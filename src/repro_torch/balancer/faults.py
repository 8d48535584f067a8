"""Deterministic chaos harness: seeded fault injection for any server.

The fault-tolerance subsystem (DESIGN.md §12) is only trustworthy if its
failure paths are *exercised on schedule*: a crash that depends on a race
reproduces once a week, a seeded crash on call #3 of server ``fine-1``
reproduces every run.  A :class:`FaultPlan` wraps existing
:class:`~repro_torch.balancer.types.Server` / ``BatchServer`` /
``RemoteServer`` objects (and, for the network layer, a client
transport) and injects the production failure classes on reproducible
schedules:

* **crash-on-nth-call** — the handler raises :class:`InjectedCrash`
  (the dispatcher's server-death edge), either probabilistically
  (``p_crash``) or at exact per-server call indices (``crash_on``).  A
  crashed server then *fails health probes* for ``down_s`` seconds of
  the plan's clock, so self-healing pools observe a realistic outage
  window instead of an instantly-healthy corpse;
* **latency spikes / stragglers** — ``p_straggle`` sleeps
  ``straggle_s`` through the plan's injectable ``sleep`` (fake-clock
  compatible: hermetic tier-1 chaos tests never really sleep);
* **NaN/Inf payloads** — ``p_nan`` poisons one member of the result
  with non-finite values *before* the server's own ``check_finite``
  scatter, exercising the per-member error channel end to end;
* **connection drops / partitions** — :meth:`wrap_transport` closes a
  pooled connection out from under the next call (the client's
  redial/backoff path) or, past ``p_drop``'s schedule, raises a
  transport error into the dispatcher's server-death edge.

Determinism: every wrapped server draws from its own
``numpy.random.Generator`` seeded from ``(plan seed, crc32(name))``, and
each call consumes a fixed number of draws regardless of outcome — so
schedules are stable across servers being added/removed from the plan,
across thread interleavings (per-server calls are serialized by the
dispatcher's one-worker-per-server discipline; a per-schedule lock
covers shell-side concurrency), and across runs.  ``plan.events`` logs
every injected fault as ``(server, call_index, kind)`` for assertions.
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .types import Server


class InjectedFault(RuntimeError):
    """Base class of every fault raised by the chaos harness."""


class InjectedCrash(InjectedFault):
    """A scheduled handler crash (takes the server-death dispatch edge)."""


class InjectedDrop(InjectedFault, ConnectionError):
    """A scheduled transport partition (a remote call that never lands).

    Subclasses :class:`ConnectionError` so the network client's
    transport-fault handling treats it exactly like a real socket death.
    """


class _Schedule:
    """Per-target deterministic fault schedule: own RNG + call counter."""

    __slots__ = ("name", "rng", "n", "lock", "crash_on", "down_until")

    def __init__(self, name: str, seed: int, crash_on: Iterable[int]) -> None:
        self.name = name
        self.rng = np.random.default_rng(
            np.random.SeedSequence((seed, zlib.crc32(name.encode())))
        )
        self.n = 0  # calls seen so far (the "nth call" index)
        self.lock = threading.Lock()
        self.crash_on = frozenset(int(i) for i in crash_on)
        self.down_until = -np.inf  # plan-clock time the outage ends

    def draw(self) -> Tuple[int, float, float, float]:
        """Consume one call's draws: (call index, u_crash, u_straggle, u_nan).

        Exactly three uniforms per call, whatever happens — the schedule
        depends only on the seed and the call count, never on which
        faults actually fired.
        """
        with self.lock:
            idx = self.n
            self.n += 1
            u = self.rng.random(3)
        return idx, float(u[0]), float(u[1]), float(u[2])


class FaultPlan:
    """A seeded, reproducible fault-injection plan (see module docstring).

    ``clock`` / ``sleep`` default to real time; tests inject a fake clock
    so straggler sleeps and outage windows are simulated, keeping chaos
    tests hermetic and fast.  ``max_crashes`` bounds the total injected
    crashes across the plan (a storm that must not exterminate the pool
    when health monitoring is off); ``None`` means unbounded.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        p_crash: float = 0.0,
        p_straggle: float = 0.0,
        p_nan: float = 0.0,
        p_drop: float = 0.0,
        straggle_s: float = 0.05,
        down_s: float = 0.0,
        crash_on: Optional[Dict[str, Iterable[int]]] = None,
        max_crashes: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.seed = int(seed)
        self.p_crash = float(p_crash)
        self.p_straggle = float(p_straggle)
        self.p_nan = float(p_nan)
        self.p_drop = float(p_drop)
        self.straggle_s = float(straggle_s)
        self.down_s = float(down_s)
        self.crash_on = {k: tuple(v) for k, v in (crash_on or {}).items()}
        self.max_crashes = max_crashes
        self.clock = clock
        self.sleep = sleep
        self._events: List[Tuple[str, int, str]] = []
        self._events_lock = threading.Lock()
        self._n_crashes = 0
        self._schedules: Dict[str, _Schedule] = {}

    # -- bookkeeping ---------------------------------------------------------
    @property
    def events(self) -> List[Tuple[str, int, str]]:
        """Injected faults so far: ``(target name, call index, kind)``."""
        with self._events_lock:
            return list(self._events)

    def counts(self) -> Dict[str, int]:
        """Injected-fault totals by kind (``crash``/``straggle``/...)."""
        out: Dict[str, int] = {}
        for _name, _idx, kind in self.events:
            out[kind] = out.get(kind, 0) + 1
        return out

    def _log(self, name: str, idx: int, kind: str) -> None:
        with self._events_lock:
            self._events.append((name, idx, kind))

    def _schedule(self, name: str) -> _Schedule:
        sched = self._schedules.get(name)
        if sched is None:
            sched = self._schedules[name] = _Schedule(
                name, self.seed, self.crash_on.get(name, ())
            )
        return sched

    def _take_crash_budget(self) -> bool:
        with self._events_lock:
            if self.max_crashes is not None and self._n_crashes >= self.max_crashes:
                return False
            self._n_crashes += 1
            return True

    # -- server wrapping -----------------------------------------------------
    def wrap(self, server: Server) -> Server:
        """Instrument ``server`` in place (and return it, for chaining).

        Exactly ONE call edge is wrapped — ``batch_call`` when the server
        routes everything through it (``batch_fn`` is set: the dispatcher
        calls ``batch_call`` even for lone requests), ``fn`` otherwise —
        so a fault is drawn once per dispatch, never double-injected.
        ``server.probe`` is shadowed to fail while the server is inside a
        scheduled outage window (``down_s`` after a crash), which is what
        makes quarantine/re-admission cycles observable.
        """
        sched = self._schedule(server.name)
        if server.batch_fn is not None:
            inner_batch = server.batch_call

            def chaotic_batch(thetas: Sequence[Any]) -> List[Any]:
                idx, u_nan = self._pre_call(sched)
                results = inner_batch(thetas)
                if u_nan < self.p_nan:
                    self._log(sched.name, idx, "nan")
                    results = self._poison_batch(server, results)
                return results

            server.batch_call = chaotic_batch  # type: ignore[method-assign]
        else:
            inner_fn = server.fn

            def chaotic_fn(theta: Any) -> Any:
                idx, u_nan = self._pre_call(sched)
                result = inner_fn(theta)
                if u_nan < self.p_nan:
                    self._log(sched.name, idx, "nan")
                    result = self._poison(result)
                return result

            server.fn = chaotic_fn

        inner_probe = server.probe

        def chaotic_probe() -> bool:
            if self.clock() < sched.down_until:
                return False
            return bool(inner_probe())

        server.probe = chaotic_probe  # type: ignore[method-assign]
        return server

    def wrap_all(self, servers: Sequence[Server]) -> List[Server]:
        return [self.wrap(s) for s in servers]

    def _pre_call(self, sched: _Schedule) -> Tuple[int, float]:
        """Pre-handler faults — crash (scheduled or drawn), then straggle.

        Returns ``(call index, nan uniform)`` so the post-handler NaN
        decision uses the same call's third draw (one draw triple per
        call keeps schedules independent of which faults fire).
        """
        idx, u_crash, u_straggle, u_nan = sched.draw()
        crash = idx in sched.crash_on or u_crash < self.p_crash
        if crash and self._take_crash_budget():
            sched.down_until = self.clock() + self.down_s
            self._log(sched.name, idx, "crash")
            raise InjectedCrash(
                f"injected crash on call {idx} of '{sched.name}'"
            )
        if u_straggle < self.p_straggle:
            self._log(sched.name, idx, "straggle")
            self.sleep(self.straggle_s)
        return idx, u_nan

    @staticmethod
    def _poison(like: Any) -> Any:
        """A non-finite payload shaped like ``like`` (NaN in slot 0)."""
        arr = np.array(np.asarray(like), dtype=float, copy=True)
        if arr.ndim == 0:
            return np.asarray(np.nan)
        arr.reshape(-1)[0] = np.nan
        return arr

    def _poison_batch(self, server: Server, results: List[Any]) -> List[Any]:
        """Poison member 0 of a batch result, re-applying the server's own
        ``check_finite`` scatter: a chaos NaN on a finite-checked server
        becomes the same per-member ``FloatingPointError`` a real
        non-finite solve produces — the error channel under test."""
        out = list(results)
        for i, r in enumerate(out):  # poison the first non-errored member
            if not isinstance(r, BaseException):
                poisoned = self._poison(r)
                if getattr(server, "check_finite", False):
                    out[i] = FloatingPointError(
                        f"non-finite result for batch member {i} on "
                        f"'{server.name}' (injected)"
                    )
                else:
                    out[i] = poisoned
                break
        return out

    # -- transport wrapping (connection drops / partitions) ------------------
    def wrap_transport(self, transport: Any, name: Optional[str] = None) -> Any:
        """Instrument a :mod:`repro_torch.net` client transport in place.

        Each ``eval_single`` / ``eval_batch`` call draws from the
        transport's own schedule; past ``p_drop`` the fault alternates
        deterministically (by call-index parity) between

        * **drop** — close one live pooled connection out from under the
          call, then let it proceed: the retry layer redials with
          jittered backoff and the call usually still lands (the
          reconnect-stampede path), and
        * **partition** — raise :class:`InjectedDrop` without touching
          the wire: the remote server dies in the dispatcher and its
          requests requeue (the transport-death path).
        """
        sched = self._schedule(name or getattr(transport, "name", "transport"))

        for op in ("eval_single", "eval_batch"):
            inner = getattr(transport, op)

            def chaotic(
                *args: Any, _inner: Callable = inner, **kwargs: Any
            ) -> Any:
                idx, u_crash, _u_straggle, _u_nan = sched.draw()
                if u_crash < self.p_drop:
                    if idx % 2 == 0:
                        self._log(sched.name, idx, "drop")
                        self._drop_one_connection(transport)
                    else:
                        self._log(sched.name, idx, "partition")
                        raise InjectedDrop(
                            f"injected partition on call {idx} of "
                            f"'{sched.name}'"
                        )
                return _inner(*args, **kwargs)

            setattr(transport, op, chaotic)
        return transport

    @staticmethod
    def _drop_one_connection(transport: Any) -> None:
        """Close the first live pooled connection (a mid-flight reset)."""
        with transport._lock:
            conns = [c for c in transport._conns if c is not None]
        for conn in conns:
            close = getattr(conn, "close", None)
            if close is not None:
                close()
                return
