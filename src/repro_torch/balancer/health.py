"""Self-healing pools: quarantine, probing, re-admission, circuit breakers.

Without this module a server death is terminal — ``server.dead = True`` and the
pool only ever shrinks, which is the wrong model for the elastic cloud
pools of the UM-Bridge deployment shape (nodes vanish *and return*).
This module gives servers a lifecycle::

    live -> quarantined -> probation -> live
                      \\-> (still failing: exponential probe backoff)

* **Quarantine** — the dispatcher hands every failed server to
  :meth:`HealthMonitor.quarantine` (never a retired one).  The monitor
  probes it on an exponential backoff schedule (``quarantine_backoff_s``
  doubling up to ``backoff_cap_s``) using ``server.probe()`` — a no-op
  True for in-process servers, a heartbeat frame across the transport
  for remote ones (:mod:`repro_torch.net`), and a downtime-aware shadow under
  the chaos harness.
* **Re-admission** — a passing probe re-enters the server through
  :meth:`LoadBalancer.readmit_server` (the existing
  ``FreeServerIndex.add`` path, worker pool re-grown, dispatcher
  notified) in ``probation`` state; after ``probation_s`` without a
  failure the monitor promotes it back to ``live``.  A failure during
  probation re-quarantines with the *escalated* backoff — flapping
  servers back off, stable ones recover in one probe interval.
* **Circuit breaker** — per ``(server, tag)``: ``breaker_threshold``
  consecutive *member* failures (poisoned results on an otherwise-live
  server) open the route for ``breaker_cooldown_s``; the dispatcher
  filters open routes out of the candidate list, so a server that keeps
  returning NaNs for one tag stops receiving that tag while still
  serving its others.  Any success closes the route and resets the
  count.

Threading: the monitor owns one daemon thread, woken every
``probe_interval_s`` (and by :meth:`stop`).  Lock ordering is strict —
the monitor lock is never held while taking the dispatcher's mutex
(probes and re-admissions run unlocked / through the balancer's public
entry points), and the dispatcher never calls into the monitor while
holding its own mutex, so the two subsystems cannot deadlock.

With ``health=None`` (the default) none of this exists: no thread, no
breaker checks on the dispatch path, and the recorded fifo seed trace is
byte-identical to the pre-fault-tolerance engine.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .types import Server


@dataclass(frozen=True)
class HealthConfig:
    """Tuning knobs of the :class:`HealthMonitor` (all times in seconds).

    ``clock`` is injectable for deterministic tests: backoff and
    probation arithmetic run on it, while the monitor thread's wait uses
    real time (tests that drive a fake clock call :meth:`HealthMonitor.
    tick` directly and park the thread with a large
    ``probe_interval_s``).  ``breaker_threshold=None`` disables circuit
    breaking while keeping quarantine/re-admission.
    """

    probe_interval_s: float = 0.05
    quarantine_backoff_s: float = 0.1
    backoff_factor: float = 2.0
    backoff_cap_s: float = 5.0
    probation_s: float = 1.0
    breaker_threshold: Optional[int] = None
    breaker_cooldown_s: float = 1.0
    clock: Callable[[], float] = field(default=time.monotonic, repr=False)


@dataclass
class _Quarantine:
    """One quarantined (or probationary) server's monitor entry."""

    server: Server
    backoff_s: float
    next_probe_at: float
    probation_until: float = 0.0
    state: str = "quarantined"  # or "probation"


@dataclass
class _Breaker:
    """Consecutive-member-failure count + open-until time for one route."""

    failures: int = 0
    open_until: float = 0.0


class HealthMonitor:
    """Background prober + breaker bookkeeping for one balancer.

    Owned by :class:`~repro_torch.balancer.dispatcher.LoadBalancer` when it is
    constructed with ``health=HealthConfig(...)``; not a public
    entry point on its own (tests reach it via ``balancer.health``).
    """

    def __init__(self, balancer: Any, config: HealthConfig) -> None:
        self._lb = balancer
        self.cfg = config
        self._lock = threading.Lock()
        self._entries: Dict[int, _Quarantine] = {}  # id(server) -> entry
        self._breakers: Dict[Tuple[int, str], _Breaker] = {}
        self._n_open = 0  # open breakers; lets the dispatcher skip lookups
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="lb-health", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.cfg.probe_interval_s)

    # -- quarantine / probing ------------------------------------------------
    def quarantine(self, server: Server) -> None:
        """Register a failed server for probing (dispatcher death path).

        Re-quarantining (a failure during probation, or a server that
        died again before its first probe) escalates the backoff; retired
        servers are never registered — retirement is terminal.
        """
        now = self.cfg.clock()
        with self._lock:
            if server.lifecycle == "retired":
                return
            server.lifecycle = "quarantined"
            entry = self._entries.get(id(server))
            if entry is None:
                backoff = self.cfg.quarantine_backoff_s
                self._entries[id(server)] = _Quarantine(
                    server=server, backoff_s=backoff, next_probe_at=now + backoff
                )
            else:
                entry.state = "quarantined"
                entry.backoff_s = min(
                    entry.backoff_s * self.cfg.backoff_factor,
                    self.cfg.backoff_cap_s,
                )
                entry.next_probe_at = now + entry.backoff_s

    def tick(self) -> None:
        """One monitor pass: probe due servers, promote finished probation.

        Public so fake-clock tests can drive the schedule synchronously;
        the daemon thread calls it every ``probe_interval_s``.
        """
        now = self.cfg.clock()
        with self._lock:
            due = [
                e
                for e in self._entries.values()
                if e.state == "quarantined" and e.next_probe_at <= now
            ]
            promote = [
                e
                for e in self._entries.values()
                if e.state == "probation" and e.probation_until <= now
            ]
        for entry in due:  # probe WITHOUT the monitor lock (it may block)
            try:
                ok = bool(entry.server.probe())
            except Exception:  # noqa: BLE001 - a raising probe is a failed one
                ok = False
            if not ok:
                with self._lock:
                    entry.backoff_s = min(
                        entry.backoff_s * self.cfg.backoff_factor,
                        self.cfg.backoff_cap_s,
                    )
                    entry.next_probe_at = self.cfg.clock() + entry.backoff_s
                continue
            if self._lb.readmit_server(entry.server):
                with self._lock:
                    entry.state = "probation"
                    entry.probation_until = (
                        self.cfg.clock() + self.cfg.probation_s
                    )
            else:  # shutdown or retired race: drop the entry
                with self._lock:
                    self._entries.pop(id(entry.server), None)
        for entry in promote:
            with self._lock:
                # A probation failure re-flipped the state: leave it alone.
                if entry.state == "probation" and not entry.server.dead:
                    entry.server.lifecycle = "live"
                    entry.backoff_s = self.cfg.quarantine_backoff_s
                    self._entries.pop(id(entry.server), None)
        self._expire_breakers(now)

    def quarantined(self) -> List[Server]:
        """Servers currently quarantined (not probationary)."""
        with self._lock:
            return [
                e.server
                for e in self._entries.values()
                if e.state == "quarantined"
            ]

    def has_quarantined_for(self, tag: str) -> bool:
        """Will a currently-quarantined server accept ``tag`` once healed?

        The dispatcher consults this before failing queued/new requests
        as unservable: a tag whose only servers are *quarantined* (not
        retired) is a recovery away from servable, so its requests wait
        instead of dying.
        """
        with self._lock:
            return any(
                e.server.accepts(tag)
                for e in self._entries.values()
                if e.state == "quarantined"
            )

    # -- circuit breaker -----------------------------------------------------
    def note_result(self, server: Server, tag: str, ok: bool) -> None:
        """Feed one member outcome into the (server, tag) breaker."""
        if self.cfg.breaker_threshold is None:
            return
        key = (id(server), tag)
        now = self.cfg.clock()
        opened = False
        with self._lock:
            br = self._breakers.get(key)
            if ok:
                if br is not None:
                    if br.open_until > now:
                        self._n_open -= 1
                    del self._breakers[key]
                return
            if br is None:
                br = self._breakers[key] = _Breaker()
            br.failures += 1
            if br.failures >= self.cfg.breaker_threshold and br.open_until <= now:
                br.open_until = now + self.cfg.breaker_cooldown_s
                self._n_open += 1
                opened = True
        if opened:
            self._lb.telemetry.record_fault("breaker_open", tag)

    def has_open_breakers(self) -> bool:
        return self._n_open > 0  # racy read is fine: gate, not decision

    def breaker_blocks(self, server: Server, tag: str) -> bool:
        """Is the (server, tag) route currently open (shedding traffic)?"""
        if self._n_open == 0:
            return False
        with self._lock:
            br = self._breakers.get((id(server), tag))
            return br is not None and br.open_until > self.cfg.clock()

    def _expire_breakers(self, now: float) -> None:
        """Half-open expired breakers: the route gets one fresh chance
        (count reset); wake the dispatcher so blocked tags re-dispatch."""
        expired = False
        with self._lock:
            for key, br in list(self._breakers.items()):
                if 0.0 < br.open_until <= now:
                    del self._breakers[key]
                    self._n_open -= 1
                    expired = True
        if expired:
            self._lb.kick()

    def open_routes(self) -> List[Dict[str, Any]]:
        """Open breaker routes for reporting: server name, tag, open-until."""
        now = self.cfg.clock()
        by_id = {id(s): s.name for s in self._lb.servers}
        with self._lock:
            return [
                {
                    "server": by_id.get(sid, str(sid)),
                    "tag": tag,
                    "open_for_s": br.open_until - now,
                }
                for (sid, tag), br in self._breakers.items()
                if br.open_until > now
            ]
