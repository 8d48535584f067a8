"""Event-driven dispatcher core (paper Algorithm 1, engine-ified).

The seed implementation ran Algorithm 1's body on one OS thread *per
request*; the first refactor replaced that with a single dispatch loop and
a fixed worker pool, but kept the seed's *data structures*: a flat arrival
``deque`` scanned O(queue x servers) per decision, an O(queue)
``deque.remove``, a ``notify_all`` on every submit/free event, and
O(servers) admission checks per submit.  At ensemble scale — sub-ms GP
requests from dozens of chains — those scans were the scheduler overhead
the paper's millisecond idle times leave no room for.

This core makes the steady-state cost of one dispatch decision O(1) in
queue length and pool size, with unchanged observable semantics (FIFO
fairness per tag, head-of-line-blocking avoidance across tags,
byte-identical ``fifo`` dispatch order vs the recorded seed trace):

* the arrival queue is an :class:`~repro_torch.balancer.queueing.IndexedQueue`
  (per-tag FIFO sub-queues under a global arrival sequence number) and a
  :class:`~repro_torch.balancer.queueing.FreeServerIndex` is maintained
  incrementally on busy/free/death/retire transitions, so the policy
  receives ready ``(request, candidates)`` pairs instead of scanning, and
  popping the dispatched request is O(1);
* wakeups are **targeted and mostly eliminated**: the event that makes a
  pair ready dispatches it under the same lock acquisition.  A submit
  drains every currently-ready pair itself and hands them straight to the
  worker pool; a worker that frees its server grabs the next decision and
  keeps executing without a hand-off.  The dispatcher thread survives as
  the backstop for the cold paths (unservable sweeps after death/retire,
  requeues, elastic resize) and is signalled only by them — no
  ``notify_all`` herd on the hot path, and steady-state requests cost two
  thread hops (client -> worker -> client) instead of four;
* the coalescing window is **non-blocking**: a worker parks on an event
  with deadline = window and fires early the moment a full ``max_batch``
  is queued (see ``_execute_batched``), instead of unconditionally
  sleeping a pool slot.

The paper's design points survive intact: one persistent pool for the
whole run, FIFO arrival order under a mutex, event-driven wakeup via
condition variables (no polling), zero assumptions about task runtimes.
``shutdown()`` joins every thread it started, so the process thread count
returns to its pre-balancer baseline — verified in tests.  See DESIGN.md §2.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.spans import SPANS, SpanLog

from .health import HealthConfig, HealthMonitor
from .policies import PolicyContext, SchedulingPolicy, create_policy
from .queueing import FreeServerIndex, IndexedQueue
from .telemetry import Telemetry
from .types import (
    DeadlineExceeded,
    PoisonRequestError,
    PromptTooLongError,
    QueueFull,
    Request,
    RequestCancelled,
    Server,
    ServerDiedError,
)


class _BatchWaiter:
    """A worker parked in the coalescing window for ``tag``: its event is
    set by the submit path the moment ``needed`` batchable same-tag
    requests are queued, so a full batch never waits out the window."""

    __slots__ = ("needed", "event")

    def __init__(self, needed: int) -> None:
        self.needed = needed
        self.event = threading.Event()


class LoadBalancer:
    """Algorithm 1, as a thread-safe in-process dispatcher.

    Clients call :meth:`submit` (blocking, like the paper's HTTP round trip)
    or :meth:`submit_async` from as many threads as they like; Algorithm 1's
    ``parallel for`` is simply many client threads calling in.

    ``policy`` selects the scheduling strategy by registry name (``fifo``,
    ``round_robin``, ``least_loaded``, ``power_of_two``, ``cost_aware``) or
    accepts a :class:`SchedulingPolicy` instance.  The default ``fifo``
    reproduces the seed/paper dispatch order exactly.

    ``exact_telemetry`` switches :class:`Telemetry` from its streaming
    default (O(1) recording, bounded memory) to the exact unbounded mode
    (full history, quantiles from full sorts) for paper-figure runs.
    """

    def __init__(
        self,
        servers: Sequence[Server],
        *,
        policy: "str | SchedulingPolicy" = "fifo",
        max_retries: int = 2,
        hedge_quantile: Optional[float] = None,
        batch_window_s: float = 0.0,
        batch_window_frac: float = 0.25,
        max_batch: int = 256,
        max_workers: Optional[int] = None,
        exact_telemetry: bool = False,
        health: "Optional[HealthConfig] | bool" = None,
        poison_threshold: Optional[int] = None,
        max_queue_per_tag: Optional[int] = None,
    ) -> None:
        self._servers: List[Server] = list(servers)
        self._mutex = threading.Lock()
        self._cv = threading.Condition(self._mutex)
        self._queue = IndexedQueue()
        self._free = FreeServerIndex(self._servers)
        self._telemetry = Telemetry(exact=exact_telemetry)
        self._policy = create_policy(policy)
        # Policies that override select() need the flat-scan compatibility
        # path (they may reorder the request scan); built-ins never do.
        self._legacy_select = (
            type(self._policy).select is not SchedulingPolicy.select
        )
        # With the default select_ready (take the earliest ready head) the
        # decision needs only ONE candidate list; a policy that overrides
        # it sees every ready (head, candidates) pair instead.
        self._default_ready = (
            type(self._policy).select_ready is SchedulingPolicy.select_ready
        )
        self._ctx = PolicyContext(
            servers=self._servers, telemetry=self._telemetry, now=time.monotonic
        )
        self.max_retries = max_retries
        self.hedge_quantile = hedge_quantile
        self.batch_window_s = batch_window_s
        self.batch_window_frac = batch_window_frac
        self.max_batch = max_batch
        self.max_workers = max_workers
        # Fault tolerance (DESIGN.md §12) — all three default OFF, keeping
        # the default engine byte-identical to the pre-fault-tolerance one:
        # ``health`` enables quarantine/probing/re-admission (True -> default
        # HealthConfig), ``poison_threshold`` fails a request that killed
        # that many *distinct* servers instead of letting it exterminate the
        # pool, ``max_queue_per_tag`` bounds per-tag queue depth (admission
        # control: excess submissions are shed with ``QueueFull``).
        if health is True:
            health = HealthConfig()
        self._health = HealthMonitor(self, health) if health else None
        self.poison_threshold = poison_threshold
        self.max_queue_per_tag = max_queue_per_tag
        self._has_deadlines = False  # any request ever carried a deadline
        self._shutdown = False
        self._started = False
        self._unservable_dirty = False  # set when a server dies / retires
        self._batch_waiters: Dict[str, List[_BatchWaiter]] = {}
        self._dispatcher: Optional[threading.Thread] = None
        self._workers: List[threading.Thread] = []  # every worker ever started
        self._n_live_workers = 0  # workers not yet retired; guarded by _work_cv
        self._work: deque[Tuple[Request, Server]] = deque()
        self._work_cv = threading.Condition()

    # -- introspection -------------------------------------------------------
    @property
    def policy(self) -> SchedulingPolicy:
        return self._policy

    @property
    def telemetry(self) -> Telemetry:
        return self._telemetry

    @property
    def health(self) -> Optional[HealthMonitor]:
        return self._health

    @property
    def servers(self) -> List[Server]:
        return list(self._servers)

    def alive_servers(self) -> List[Server]:
        return [s for s in self._servers if not s.dead]

    # -- pool management (elastic resize; beyond paper) ----------------------
    def add_server(self, server: Server) -> None:
        with self._cv:
            self._servers.append(server)
            self._free.add(server)
            if self._started:
                self._grow_workers_locked()
            self._cv.notify()

    def retire_server(self, name: str) -> None:
        with self._cv:
            for s in self._servers:
                if s.name == name:
                    s.dead = True
                    s.lifecycle = "retired"  # terminal: never re-admitted
                    self._free.mark_dead(s)
            self._unservable_dirty = True
            self._cv.notify()  # wake the dispatcher for the dirty sweep
        # The worker pool sizes itself to the live-server count; wake idle
        # workers so the now-excess ones park out (see _worker_loop).
        with self._work_cv:
            self._work_cv.notify_all()

    def readmit_server(self, server: Server) -> bool:
        """Re-admit a quarantined server after a passing health probe.

        The inverse of the death transition: the server re-enters the free
        index (appended to pool order — see :meth:`FreeServerIndex.add`),
        the worker pool re-grows to match, and any requests its return
        makes dispatchable go out immediately.  The server lands in
        ``probation``; the :class:`~repro_torch.balancer.health.HealthMonitor`
        promotes it to ``live`` after a clean probation window.  Returns
        False (and does nothing) under shutdown or for retired servers.
        """
        pairs: List[Tuple[Request, Server]] = []
        with self._cv:
            if self._shutdown or server.lifecycle == "retired":
                return False
            if not server.dead:
                return True  # double-probe race: already re-admitted
            server.dead = False
            server.busy = False
            server.lifecycle = "probation"
            self._free.add(server)
            if self._started:
                self._grow_workers_locked()
            if self._queue:
                pairs = self._drain_ready_locked()
            self._cv.notify()
        with self._work_cv:
            self._work_cv.notify_all()
        for tag in list(server.capacity_tags) or [""]:
            self._telemetry.record_fault("readmission", tag)
        if pairs:
            self._hand_off(pairs)
        return True

    def kick(self) -> None:
        """Wake the dispatch loop to retake decisions whose inputs changed
        outside the queue/free events — e.g. a circuit breaker expiring
        re-opens routes for tags that were skipped while it was open."""
        with self._cv:
            self._cv.notify()

    # -- engine lifecycle ----------------------------------------------------
    def _n_workers_wanted(self) -> int:
        if self.max_workers is not None:
            return max(1, self.max_workers)
        return max(1, sum(1 for s in self._servers if not s.dead))

    def _ensure_started_locked(self) -> None:
        if self._started:
            return
        self._started = True
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="lb-dispatch", daemon=True
        )
        self._dispatcher.start()
        self._grow_workers_locked()
        if self._health is not None:
            self._health.start()

    def _grow_workers_locked(self) -> None:
        # _n_live_workers (not len(_workers)) is the pool size: workers that
        # parked out after a shrink stay in _workers so shutdown can join
        # them, but no longer count toward capacity.
        with self._work_cv:
            while self._n_live_workers < self._n_workers_wanted():
                t = threading.Thread(
                    target=self._worker_loop,
                    name=f"lb-worker-{len(self._workers)}",
                    daemon=True,
                )
                self._workers.append(t)
                self._n_live_workers += 1
                t.start()

    def shutdown(self) -> None:
        """Stop accepting work, fail queued requests, join every thread.

        After this returns the process thread count is back to its
        pre-balancer baseline (no leaked dispatcher/worker threads).
        In-flight requests finish; queued ones complete with an error.
        """
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
            # release any worker parked in a coalescing window
            for waiters in self._batch_waiters.values():
                for w in waiters:
                    w.event.set()
        with self._work_cv:
            self._work_cv.notify_all()
        if self._health is not None:
            # Before joining the workers: a mid-probe monitor tick calling
            # readmit_server sees _shutdown and backs off, then the join
            # guarantees no re-admission mutates the pool after the sweeps.
            self._health.stop()
        if self._dispatcher is not None and self._dispatcher is not threading.current_thread():
            self._dispatcher.join()
        for t in self._workers:
            if t is not threading.current_thread():
                t.join()
        # Dispatcher exits before failing anything it hasn't seen; sweep the
        # queue AND the worker hand-off deque (a pair pushed after the last
        # worker exited would otherwise leave its client blocked forever).
        with self._cv:
            self._fail_queued_locked("balancer shut down")
        with self._work_cv:
            leftover, self._work = list(self._work), deque()
        for req, server in leftover:
            server.busy = False
            req.error = RuntimeError("balancer shut down")
            req._complete()

    def __enter__(self) -> "LoadBalancer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- client API ----------------------------------------------------------
    def submit(
        self,
        theta,
        *,
        tag: str = "",
        batchable: bool = False,
        deadline_s: Optional[float] = None,
    ) -> Any:
        """Blocking evaluation of one request (the paper's client call)."""
        req = self.submit_async(
            theta, tag=tag, batchable=batchable, deadline_s=deadline_s
        )
        return self.result(req)

    def submit_async(
        self,
        theta,
        *,
        tag: str = "",
        batchable: bool = False,
        deadline_s: Optional[float] = None,
    ) -> Request:
        """Enqueue one request; see :meth:`submit` for the blocking form.

        ``deadline_s`` arms queue-time shedding: a request still queued
        that many seconds after arrival is completed with
        :class:`DeadlineExceeded` instead of dispatching stale (once
        dispatched it always runs to completion).  With
        ``max_queue_per_tag`` set, a submission that would push the tag's
        queue past the bound is rejected immediately with
        :class:`QueueFull` — overload sheds at admission, with bounded
        memory, instead of queueing unboundedly.
        """
        req = Request(
            theta=theta, tag=tag, batchable=batchable, arrived_at=time.monotonic()
        )
        if deadline_s is not None:
            req.deadline_at = req.arrived_at + deadline_s
        req._cancel_hook = self.cancel
        fire: Optional[List[_BatchWaiter]] = None
        pairs: List[Tuple[Request, Server]] = []
        fault: Optional[str] = None
        with self._cv:
            if self._shutdown:
                req.error = RuntimeError("balancer shut down")
            elif not self._free.servable(tag) and not self._waitable_locked(tag):
                req.error = RuntimeError(f"no live server accepts tag '{tag}'")
                fault = "rejected"
            elif (
                self.max_queue_per_tag is not None
                and self._queue.count_tag(tag) >= self.max_queue_per_tag
            ):
                req.error = QueueFull(
                    f"tag '{tag}' queue is at its bound "
                    f"({self.max_queue_per_tag}); submission shed"
                )
                fault = "queue_full"
            else:
                self._ensure_started_locked()
                if req.deadline_at is not None:
                    self._has_deadlines = True
                self._queue.push(req)  # queue.push(request[j])
                # Submit-driven fast path: if this tag has a free server,
                # take the dispatch decision here and now — no dispatcher
                # thread wakeup, no herd.
                if self._free.has_free_for(tag):
                    pairs = self._drain_ready_locked()
                if batchable:
                    fire = self._ripe_batch_waiters_locked(tag)
        if req.error is not None:  # rejected: never booked in telemetry
            if fault is not None:
                self._telemetry.record_fault(fault, tag)
            req._complete()
            return req
        self._telemetry.record_arrival(req)
        if pairs:
            self._hand_off(pairs)
        if fire:
            for w in fire:
                w.event.set()
        return req

    def submit_many(
        self,
        thetas: Sequence[Any],
        *,
        tag: str = "",
        batchable: bool = False,
        deadline_s: Optional[float] = None,
    ) -> List[Request]:
        """Enqueue a batch of requests under one lock acquisition.

        Returns the requests in submission order; combine with
        :func:`repro_torch.balancer.futures.wait_any` /
        :func:`~repro_torch.balancer.futures.as_completed` to react to whichever
        finishes first, or :func:`~repro_torch.balancer.futures.gather` for the
        barrier round trip.  All-or-nothing admission: if the pool cannot
        serve ``tag`` (or is shut down) every request completes immediately
        with the error set — rejected requests are never booked in
        telemetry.
        """
        now = time.monotonic()
        deadline_at = None if deadline_s is None else now + deadline_s
        reqs = [
            Request(
                theta=theta, tag=tag, batchable=batchable,
                arrived_at=now, deadline_at=deadline_at,
            )
            for theta in thetas
        ]
        for req in reqs:
            req._cancel_hook = self.cancel
        error: Optional[Exception] = None
        fault: Optional[str] = None
        fire: Optional[List[_BatchWaiter]] = None
        pairs: List[Tuple[Request, Server]] = []
        with self._cv:
            if self._shutdown:
                error = RuntimeError("balancer shut down")
            elif not self._free.servable(tag) and not self._waitable_locked(tag):
                error = RuntimeError(f"no live server accepts tag '{tag}'")
                fault = "rejected"
            elif (
                self.max_queue_per_tag is not None
                and self._queue.count_tag(tag) + len(reqs) > self.max_queue_per_tag
            ):
                # All-or-nothing admission also under overload: a batch that
                # would overflow the tag's bound is shed whole, never split.
                error = QueueFull(
                    f"batch of {len(reqs)} would push tag '{tag}' past its "
                    f"queue bound ({self.max_queue_per_tag}); submission shed"
                )
                fault = "queue_full"
            else:
                self._ensure_started_locked()
                if deadline_at is not None:
                    self._has_deadlines = True
                for req in reqs:
                    self._queue.push(req)
                if reqs and self._free.has_free_for(tag):
                    pairs = self._drain_ready_locked()
                if batchable:
                    fire = self._ripe_batch_waiters_locked(tag)
        if error is not None:
            for req in reqs:
                if fault is not None:
                    self._telemetry.record_fault(fault, tag)
                req.error = type(error)(*error.args)  # fresh traceback each
                req._complete()
            return reqs
        for req in reqs:
            self._telemetry.record_arrival(req)
        if pairs:
            self._hand_off(pairs)
        if fire:
            for w in fire:
                w.event.set()
        return reqs

    def result(
        self,
        req: Request,
        timeout: Optional[float] = None,
        *,
        cancel_on_timeout: bool = False,
    ) -> Any:
        """Wait for ``req``; with ``cancel_on_timeout`` a deadline miss
        first tries to :meth:`cancel` the request so a still-queued one is
        reclaimed instead of completing into the void (an in-flight one is
        merely abandoned — its result is discarded when it lands)."""
        if not req.done.wait(timeout):
            if cancel_on_timeout:
                self.cancel(req)
            raise TimeoutError("request did not complete in time")
        if req.error is not None:
            raise req.error
        return req.result

    def cancel(self, req: Request) -> bool:
        """Cancel ``req`` if it is still queued (client deadline support).

        Queued requests are popped in O(tag queue) and complete
        immediately with :class:`RequestCancelled`; completed or in-flight
        requests return False untouched — a dispatched evaluation cannot
        be recalled from its server, the caller abandons it instead.
        """
        with self._cv:
            if req.done.is_set() or req not in self._queue:
                return False
            self._queue.pop(req)
            req.error = RequestCancelled("request cancelled before dispatch")
        req._complete()
        return True

    # -- dispatch loop (Algorithm 1's scheduler half) ------------------------
    def _dispatch_loop(self) -> None:
        """Cold-path backstop: the hot paths dispatch inline (submit drains
        ready pairs, a freeing worker grabs the next decision), so this
        loop is signalled only by death/retire sweeps, requeues and
        elastic resizes — it sleeps through steady-state traffic."""
        while True:
            pairs: List[Tuple[Request, Server]] = []
            with self._cv:  # mutex.lock()
                while True:
                    if self._shutdown:
                        self._fail_queued_locked("balancer shut down")
                        return
                    if self._unservable_dirty:
                        self._unservable_dirty = False
                        self._fail_unservable_locked()
                    # Drain EVERY currently-ready pair under this one lock
                    # acquisition — one wakeup can dispatch a whole wave.
                    pairs = self._drain_ready_locked()
                    if pairs:
                        break
                    self._cv.wait()  # conditional_variable.wait(mutex)
            # mutex.unlock() — implicit; hand off to the worker pool.
            self._hand_off(pairs)

    def _waitable_locked(self, tag: str) -> bool:
        """No *live* server accepts ``tag``, but a quarantined one would:
        the tag is one successful health probe away from servable, so its
        requests queue for re-admission instead of failing.  Always False
        without health monitoring (preserving the strict admission check).
        """
        return self._health is not None and self._health.has_quarantined_for(tag)

    def _shed_expired_locked(self) -> None:
        """Complete queued requests whose deadline passed (caller holds the
        mutex) with :class:`DeadlineExceeded`.

        Head-of-line, best-effort: within a tag requests dispatch FIFO, so
        the head is always the next to go — shedding checks each tag's
        successive heads at every dispatch opportunity, which is exactly
        when a stale request would otherwise occupy a server.  Zero cost
        until some request actually carries a deadline.
        """
        if not self._has_deadlines or not self._queue:
            return
        now = time.monotonic()
        for tag in self._queue.tags():
            while True:
                head = self._queue.head(tag)
                if (
                    head is None
                    or head.deadline_at is None
                    or head.deadline_at > now
                ):
                    break
                self._queue.pop(head)
                head.error = DeadlineExceeded(
                    f"request shed after waiting past its deadline "
                    f"({now - head.arrived_at:.3f}s queued)"
                )
                self._telemetry.record_fault("deadline_shed", tag)
                head._complete()

    def _drain_ready_locked(self) -> List[Tuple[Request, Server]]:
        """Take every dispatch decision currently possible (caller holds
        the mutex): pop each chosen request, mark its server busy."""
        self._shed_expired_locked()
        pairs: List[Tuple[Request, Server]] = []
        while True:
            pair = self._select_locked()
            if pair is None:
                return pairs
            req, server = pair
            self._queue.pop(req)  # O(1): req is its tag's head
            server.busy = True  # server.markBusy()
            self._free.mark_busy(server)
            pairs.append(pair)

    def _hand_off(self, pairs: List[Tuple[Request, Server]]) -> None:
        with self._work_cv:
            if not self._shutdown:
                self._work.extend(pairs)
                if len(pairs) == 1:
                    self._work_cv.notify()
                else:
                    self._work_cv.notify_all()
                return
        # Shutdown raced us between draining these pairs and handing them
        # off: the workers may already be joined and the final sweeps done,
        # so enqueueing now would strand the clients forever.  Fail the
        # pairs exactly like the shutdown sweep would have.
        for req, server in pairs:
            server.busy = False
            req.error = RuntimeError("balancer shut down")
            req._complete()

    def _select_locked(self) -> Optional[Tuple[Request, Server]]:
        """One dispatch decision over the indexed structures.

        Builds the ready ``(head request, candidates)`` pair per
        dispatchable tag — O(distinct queued tags), each candidate list
        O(free servers accepting that tag) — and lets the policy choose.
        Falls back to the flat O(queue x servers) reference scan only for
        legacy policies that override ``select``.
        """
        if not self._queue:
            return None
        if self._legacy_select:
            return self._policy.select(list(self._queue), self._ctx)
        # Open circuit breakers (health monitoring only) veto (server, tag)
        # routes; the filter is consulted ONLY while some breaker is open,
        # so the default engine's decision path is untouched.
        health = self._health
        breakers = health is not None and health.has_open_breakers()
        if self._default_ready:
            if breakers:
                # Breaker-aware scan: earliest head whose candidate list
                # survives the route filter (a tag whose every free server
                # is vetoed waits for cooldown or another server).
                for tag, head in sorted(
                    self._queue.heads(), key=lambda th: th[1].seq
                ):
                    if not self._free.has_free_for(tag):
                        continue
                    candidates = [
                        s
                        for s in self._free.candidates(tag)
                        if not health.breaker_blocks(s, tag)
                    ]
                    if candidates:
                        return head, self._policy.choose_server(
                            head, candidates, self._ctx
                        )
                return None
            # Fast path: the default select_ready takes the earliest ready
            # head, so find it with O(1) has_free_for probes and build the
            # candidate list once, for that tag only.
            best: Optional[Request] = None
            for tag, head in self._queue.heads():
                if (best is None or head.seq < best.seq) and (
                    self._free.has_free_for(tag)
                ):
                    best = head
            if best is None:
                return None
            candidates = self._free.candidates(best.tag)
            return best, self._policy.choose_server(best, candidates, self._ctx)
        ready: List[Tuple[Request, List[Server]]] = []
        for tag, head in self._queue.heads():
            candidates = self._free.candidates(tag)
            if breakers:
                candidates = [
                    s for s in candidates if not health.breaker_blocks(s, tag)
                ]
            if candidates:
                ready.append((head, candidates))
        if not ready:
            return None
        ready.sort(key=lambda rc: rc[0].seq)  # earliest arrival first
        return self._policy.select_ready(ready, self._ctx)

    def _fail_unservable_locked(self) -> None:
        """Fail queued requests whose tag no live server accepts.

        Runs only after a server death/retirement (``_unservable_dirty``) —
        servability never shrinks otherwise, and requests with an unservable
        tag are rejected at submit time — so the dispatch hot path stays
        O(queued tags) per wakeup.
        """
        for tag in self._queue.tags():
            if not self._free.servable(tag):
                if self._waitable_locked(tag):
                    continue  # a quarantined server may heal: requests wait
                for req in self._queue.drain_tag(tag):
                    req.error = RuntimeError(
                        f"no live server accepts tag '{req.tag}'"
                    )
                    req._complete()

    def _fail_queued_locked(self, msg: str) -> None:
        for req in self._queue.drain_all():
            req.error = RuntimeError(msg)
            req._complete()

    # -- worker pool (Algorithm 1's execution half) --------------------------
    def _worker_loop(self) -> None:
        pair: Optional[Tuple[Request, Server]] = None
        while True:
            if pair is None:
                with self._work_cv:
                    while not self._work:
                        if self._shutdown:
                            return
                        if self._n_live_workers > self._n_workers_wanted():
                            # Pool shrank (server retired/died): park this
                            # worker out rather than idling forever.  Checked
                            # only when idle, so queued work is never abandoned.
                            self._n_live_workers -= 1
                            return
                        self._work_cv.wait()
                    pair = self._work.popleft()
            elif self._work:  # lock-free peek; cheap no-op when empty
                # Fairness: with max_workers below the ready-server count,
                # pairs can be parked in the hand-off deque while this
                # worker chains completion-driven grabs.  Rotate the
                # grabbed pair behind them so hand-offs never starve.
                with self._work_cv:
                    if self._work:
                        self._work.append(pair)
                        pair = self._work.popleft()
            # Completion-driven fast path: _execute frees the server and,
            # under the same lock acquisition, grabs the next ready
            # decision — this worker keeps going with zero hand-offs.
            pair = self._execute(*pair)

    def _execute(
        self, req: Request, server: Server
    ) -> Optional[Tuple[Request, Server]]:
        req.dispatched_at = time.monotonic()
        req.server = server.name
        if server.continuous:
            return self._execute_continuous(req, server)
        if req.batchable and server.batch_fn is not None and self.batch_window_s > 0:
            return self._execute_batched(req, server)
        try:
            if server.batch_fn is not None:
                # Batch-capable servers evaluate through batch_call even for
                # a lone request, so the per-member error channel (Exception
                # results, check_finite) has the same semantics whether or
                # not the request was coalesced: the member fails alone, the
                # server survives.  Routing through _single/fn instead would
                # re-raise the member error here and kill the server below.
                result = server.batch_call([req.theta])[0]
            else:
                result = server.fn(req.theta)  # return server(request[j])
        except Exception:  # noqa: BLE001 - any worker fault kills the server
            self._fail_dispatch(req, server)
            return None
        req.completed_at = time.monotonic()
        ok = not isinstance(result, BaseException)
        if ok:
            req.result = result
        else:
            req.error = result
            self._telemetry.record_member_failure(server)
        if self._health is not None:
            self._health.note_result(server, req.tag, ok)
        self._telemetry.record_completion(req, server)
        self._book_wire(req.tag, server, req.completed_at - req.dispatched_at)
        nxt = self._free_server(server)
        req._complete()
        return nxt

    def _book_wire(self, tag: str, server: Server, total_s: float) -> None:
        """Split a remote completion into wire vs remote service seconds.

        Remote servers (:mod:`repro_torch.net`) report the shell-side handler
        seconds of their last call in ``last_service_s``; the difference
        to the observed round trip is serialization + socket time — the
        network overhead the binary framing mode exists to shrink.  A
        server is driven by one worker at a time, so reading the
        attribute here is race-free.  No-op for local servers.
        """
        if not server.remote:
            return
        service = server.last_service_s
        if service is None:
            return
        self._telemetry.record_wire(
            server.name, tag, max(0.0, total_s - service), service
        )

    def _free_server(self, server: Server) -> Optional[Tuple[Request, Server]]:
        """Free ``server`` and grab the next ready dispatch decision.

        Freeing one server makes at most one new pair ready (every other
        ready pair was dispatched by the event that created it), so the
        calling worker executes the grabbed pair itself — the decision
        happens under the same lock acquisition as the free transition,
        with no dispatcher wakeup and no hand-off queue in between.
        """
        with self._cv:  # reset busyness once done
            server.busy = False
            server.last_free_at = time.monotonic()
            self._free.mark_free(server)
            if self._queue and not self._shutdown:
                self._shed_expired_locked()
                pair = self._select_locked()
                if pair is not None:
                    nreq, nserver = pair
                    self._queue.pop(nreq)
                    nserver.busy = True
                    self._free.mark_busy(nserver)
                    return pair
        return None

    def _fail_dispatch(self, req: Request, server: Server) -> None:
        """A handler raised: mark the server dead, retry or fail ``req``.

        With health monitoring the death is a *quarantine* (the monitor
        probes and re-admits); with ``poison_threshold`` a request whose
        failures span that many distinct servers is declared poison and
        failed before it can take down another — the classic
        crash-the-whole-pool input (a theta that segfaults the solver)
        costs ``poison_threshold`` servers instead of all of them.
        """
        self._telemetry.record_failure(server)
        self._telemetry.record_fault("server_death", req.tag)
        with self._cv:
            server.dead = True
            server.busy = False
            self._free.mark_dead(server)
            self._unservable_dirty = True
            self._cv.notify()  # dirty sweep must run even with no free server
        with self._work_cv:  # a death shrinks the pool like a retire
            self._work_cv.notify_all()
        if self._health is not None:
            self._health.quarantine(server)
        req.killed_servers.add(server.name)
        req.retries += 1
        if (
            self.poison_threshold is not None
            and len(req.killed_servers) >= self.poison_threshold
        ):
            self._telemetry.record_fault("poison", req.tag)
            req.error = PoisonRequestError(
                f"request killed {len(req.killed_servers)} distinct servers "
                f"({sorted(req.killed_servers)}); quarantined as poison"
            )
            req._complete()
        elif req.retries > self.max_retries:
            self._telemetry.record_fault("retries_exhausted", req.tag)
            req.error = ServerDiedError(
                f"request failed after {req.retries} attempts"
            )
            req._complete()
        else:
            self._telemetry.record_fault("requeue", req.tag)
            self._requeue(req)

    def _requeue(self, req: Request) -> None:
        with self._cv:
            if not self._shutdown:
                self._queue.push(req)  # re-enter Algorithm 1
                # The server that failed this request may have been its only
                # compatible one, and the dispatcher may already have consumed
                # the death's dirty flag before we re-enqueued — re-arm it so
                # the next wakeup re-checks servability instead of parking
                # the request forever.
                self._unservable_dirty = True
                self._cv.notify()
                return
            req.error = RuntimeError("balancer shut down")
        req._complete()

    # -- coalesced batch dispatch (beyond paper) -----------------------------
    def _coalesce_window(self, tag: str) -> float:
        """Adaptive coalescing window for ``tag``.

        Waiting for peers only pays off when it is cheap relative to the
        work it amortises, so the window is a fraction
        (``batch_window_frac``) of the tag's EWMA service time, capped by
        ``batch_window_s``: microsecond GP lookups never sleep a full
        window, and multi-second fine solves use the whole cap.  Until the
        EWMA has data the configured cap is used as-is.
        """
        ewma = self._telemetry.tag_ewma(tag)
        if ewma is None:
            return self.batch_window_s
        return min(self.batch_window_s, self.batch_window_frac * ewma)

    def _ripe_batch_waiters_locked(self, tag: str) -> Optional[List[_BatchWaiter]]:
        """Batch waiters for ``tag`` whose member threshold is now met."""
        waiters = self._batch_waiters.get(tag)
        if not waiters:
            return None
        queued = self._queue.count_batchable(tag)
        return [w for w in waiters if queued >= w.needed] or None

    def _execute_batched(
        self, req: Request, server: Server
    ) -> Optional[Tuple[Request, Server]]:
        """Coalesce queued batchable same-tag requests into ONE server call.

        ``server.batch_call`` receives every member theta at once — for a
        :class:`~repro_torch.balancer.types.BatchServer` that is a single stacked
        ``(B, ...)`` evaluation (one vmapped XLA launch for the whole
        batch), for a legacy ``batch_fn`` the list contract.  Results are
        scattered back to member requests; a member whose result is an
        ``Exception`` fails alone (its batch mates complete normally),
        while a whole-call exception follows the server-death path with
        members retrying elsewhere.

        FIFO fairness: members are drained from the arrival queue in
        arrival order and non-matching requests keep their relative order,
        so batching never reorders requests within a tag nor starves other
        tags.  The window is **non-blocking**: it is only armed when some
        (but not a full batch of) same-tag batchable peers are queued at
        dispatch time, and the worker parks on an event the submit path
        fires the moment the ``max_batch``-th member arrives — a full
        batch never waits out the window, a lone request never pays it.
        """
        limit = self.max_batch
        if getattr(server, "max_batch", None):
            limit = min(limit, server.max_batch)
        waiter: Optional[_BatchWaiter] = None
        window = 0.0
        with self._cv:
            queued = self._queue.count_batchable(req.tag)
        if 0 < queued < limit - 1 and not self._shutdown:
            # Size the window OUTSIDE the dispatcher mutex: tag_ewma takes
            # the telemetry lock and may fold a pending backlog — that must
            # never stall concurrent submit/free traffic on _cv.
            window = self._coalesce_window(req.tag)
            if window > 0:
                with self._cv:
                    queued = self._queue.count_batchable(req.tag)
                    if 0 < queued < limit - 1 and not self._shutdown:
                        waiter = _BatchWaiter(needed=limit - 1)
                        self._batch_waiters.setdefault(req.tag, []).append(waiter)
        if waiter is not None:
            waiter.event.wait(window)  # early-fired by the submit path
            with self._cv:
                waiters = self._batch_waiters.get(req.tag)
                if waiters is not None:
                    try:
                        waiters.remove(waiter)
                    except ValueError:
                        pass
                    if not waiters:
                        del self._batch_waiters[req.tag]
        with self._cv:
            extra = self._queue.drain_batchable(req.tag, limit - 1)
        members = [req] + extra
        if SPANS.on:
            req.popped_at = req.dispatched_at
        # Re-stamp the primary past the coalescing wait: the window is
        # queueing, not service — booking it as service time would inflate
        # the tag EWMA that sizes the adaptive window (a feedback loop,
        # bounded only by the cap) and the busy-seconds utilization metric.
        now = time.monotonic()
        for r in members:
            r.dispatched_at = now
            r.server = server.name
        try:
            results = server.batch_call([r.theta for r in members])
        except Exception:  # noqa: BLE001 - whole-call fault kills the server
            # Coalesced members retry elsewhere — each burns one retry (and
            # one distinct-server kill toward the poison threshold), so
            # max_retries bounds them like any other request; the primary
            # follows the normal server-death path.
            exhausted: List[Request] = []
            poisoned: List[Request] = []
            with self._cv:
                for r in reversed(extra):
                    r.retries += 1
                    r.killed_servers.add(server.name)
                    if (
                        self.poison_threshold is not None
                        and len(r.killed_servers) >= self.poison_threshold
                    ):
                        poisoned.append(r)
                        continue
                    if r.retries > self.max_retries:
                        exhausted.append(r)
                        continue
                    r.dispatched_at = 0.0
                    r.server = None
                    self._queue.push_front(r)  # original seq: order kept
                    self._telemetry.record_fault("requeue", r.tag)
                self._cv.notify()
            for r in poisoned:
                self._telemetry.record_fault("poison", r.tag)
                r.error = PoisonRequestError(
                    f"request killed {len(r.killed_servers)} distinct "
                    f"servers ({sorted(r.killed_servers)}); quarantined as "
                    f"poison"
                )
                r._complete()
            for r in exhausted:
                self._telemetry.record_fault("retries_exhausted", r.tag)
                r.error = ServerDiedError(
                    f"request failed after {r.retries} attempts"
                )
                r._complete()
            self._fail_dispatch(req, server)
            return None
        done = time.monotonic()
        for r, res in zip(members, results):
            r.completed_at = done
            ok = not isinstance(res, BaseException)
            if ok:
                r.result = res
            else:
                r.error = res  # per-member failure: batch mates unaffected
                self._telemetry.record_member_failure(server)
            if self._health is not None:
                self._health.note_result(server, r.tag, ok)
        # One busy interval + one EWMA sample for the fused call (the
        # primary's — the service time is real even if some members
        # errored), plus request-count credit for the coalesced members;
        # errored members were booked above so summary()['failures'] does
        # not misread poisoned thetas as served work.
        self._telemetry.record_completion(req, server, len(members))
        self._telemetry.record_batched(extra, server)
        self._telemetry.record_batch_size(req.tag, len(members))
        self._book_wire(req.tag, server, done - now)
        nxt = self._free_server(server)
        for r in members:
            r._complete()
        return nxt

    # -- continuous batching (token-boundary joins; beyond paper) ------------
    def _execute_continuous(
        self, req: Request, server: Server
    ) -> Optional[Tuple[Request, Server]]:
        """Drive a :class:`~repro_torch.balancer.types.DecodePool` until its slot
        table drains — the continuous-batching dispatch edge.

        Where ``_execute_batched`` coalesces a *window* of requests into
        one stacked call, this edge keeps the server's in-flight batch
        open: after every fused decode step (a token boundary) it drains
        queued same-tag requests straight into the freed slots, so a
        1-token request admitted behind a 64-token one rides the same
        executable instead of waiting out the whole generation.  The pool
        stays ``busy`` (one worker drives it) from the first admission
        until the last slot evicts; queued requests therefore reach it
        only through the boundary join — or through a *free* replica via
        the normal dispatch path, whichever comes first.

        Failure semantics differ from the batched edge in one way: a
        step/insert fault kills the pool AND fails every in-flight
        request *without retries* — their decode state died with the
        pool's slot table and a replay would silently drop the tokens
        already emitted.  Shutdown stops admission at the next boundary;
        in-flight slots finish (the shutdown contract: in-flight requests
        complete, queued ones error).
        """
        try:
            done = self._admit_one(req, server, req.dispatched_at)
            if done is not None:
                self._complete_slot(done, server)
            while server.n_occupied:
                # Token-boundary join: fill freed slots from the queue
                # BEFORE stepping, so requests queued behind the first
                # admission ride the very next fused step.
                self._admit_queued(server, req.tag)
                finished, n_emitted = server.step_once()
                self._telemetry.record_tokens(req.tag, n_emitted)
                self._telemetry.record_occupancy(
                    server.name, n_emitted, server.n_slots
                )
                usage = server.block_usage()
                if usage is not None:
                    self._telemetry.record_blocks(server.name, *usage)
                for info in finished:
                    self._complete_slot(info, server)
        except Exception:  # noqa: BLE001 - pool fault kills the pool
            self._fail_pool(server, req.tag)
            return None
        return self._free_server(server)

    def _admit_one(self, req: Request, server: Server, now: float):
        """Admit one request into a pool, converting the typed
        never-fits rejection into a per-request failure (the pool lives
        on; a pool-killing fault would re-raise past this)."""
        try:
            return server.admit(req, now)
        except PromptTooLongError as exc:
            self._telemetry.record_fault("rejected", req.tag)
            req.completed_at = time.monotonic()
            req.error = exc
            req._complete()
            return None

    def _admit_queued(self, server: Server, tag: str) -> None:
        """Join queued ``tag`` requests into free slots, in arrival order
        (FIFO admission).  Paged pools add a block-granular gate: when the
        queue *head* does not fit the currently free blocks, admission
        stops — the head is never skipped in favour of a smaller request
        behind it, so arrival order is preserved and the head cannot
        starve.  No-op under shutdown — queued requests are failed by the
        shutdown sweep instead."""
        while server.n_free > 0:
            with self._cv:
                if self._shutdown:
                    return
                head = self._queue.head(tag)
                if head is None or not server.admissible(head.theta):
                    return
                self._queue.pop(head)
            now = time.monotonic()
            head.dispatched_at = now
            head.server = server.name
            done = self._admit_one(head, server, now)
            if done is not None:
                self._complete_slot(done, server)

    def _complete_slot(self, info, server: Server) -> None:
        """Book and complete one finished slot's request."""
        r = info.req
        r.completed_at = info.times[-1]
        r.result = info.result()
        # Per-request completion booking: the busy interval is this
        # request's dispatch->finish span, so a pool's uptime() reads as
        # *slot-seconds* (overlapping intervals — deliberately: that is
        # the utilization a slot-based server actually delivers), and the
        # tag EWMA feeds cost_aware routing across replicas.
        self._telemetry.record_completion(r, server)
        r._complete()

    def _fail_pool(self, server: Server, tag: str) -> None:
        """A DecodePool's step/insert raised: kill the pool, fail every
        in-flight slot request (no retry — their KV state is gone)."""
        self._telemetry.record_failure(server)
        self._telemetry.record_fault("server_death", tag)
        infos = server.clear()
        with self._cv:
            server.dead = True
            server.busy = False
            self._free.mark_dead(server)
            self._unservable_dirty = True
            self._cv.notify()
        with self._work_cv:  # a death shrinks the pool like a retire
            self._work_cv.notify_all()
        if self._health is not None:
            self._health.quarantine(server)
        now = time.monotonic()
        for info in infos:
            info.req.completed_at = now
            info.req.error = ServerDiedError(
                f"decode pool '{server.name}' died; in-flight decode state lost"
            )
            info.req._complete()

    # -- straggler hedging (beyond paper) ------------------------------------
    def runtime_quantile(self, tag: str, q: float) -> Optional[float]:
        return self._telemetry.runtime_quantile(tag, q)

    def submit_hedged(self, theta, *, tag: str = "") -> Any:
        """Submit with straggler mitigation: if the primary exceeds the
        ``hedge_quantile`` of past runtimes for this tag, launch a duplicate;
        first completion wins, the loser is flagged ``hedged`` so idle-time
        statistics never count the duplicated work — whichever copy wins."""
        primary = self.submit_async(theta, tag=tag)
        q = self.hedge_quantile or 0.95
        deadline = self.runtime_quantile(tag, q)
        if deadline is None:
            return self.result(primary)
        if primary.done.wait(timeout=deadline * 2.0):
            return self.result(primary)
        backup = self.submit_async(theta, tag=tag)
        backup.hedged = True  # presumed loser until proven otherwise
        first_done = threading.Event()  # set by whichever copy finishes first

        def notify(_r: Request) -> None:
            first_done.set()

        primary.add_done_callback(notify)
        backup.add_done_callback(notify)
        try:
            first_done.wait()
        finally:
            # Deregister from BOTH copies: the loser completes after the
            # race is resolved and must not touch this (now dead) event —
            # nor accumulate a stale closure for the rest of its life.
            primary.remove_done_callback(notify)
            backup.remove_done_callback(notify)
        for winner, loser in ((primary, backup), (backup, primary)):
            if winner.done.is_set() and winner.error is None:
                break
        else:
            # First finisher errored: wait out the surviving duplicate.
            winner, loser = (
                (backup, primary) if primary.done.is_set() else (primary, backup)
            )
        winner.hedged = False
        loser.hedged = True
        # Streaming telemetry folds idle times in at completion; repair the
        # aggregates for completions that landed before the flags settled.
        self._telemetry.rebook_hedged(winner, loser)
        return self.result(winner)

    # -- telemetry (paper Figs. 8 & 9) ---------------------------------------
    def idle_times(self) -> List[float]:
        """Queue delays of completed requests — the paper's Fig. 9 metric."""
        return self._telemetry.idle_times()

    def timeline(self) -> List[Dict[str, Any]]:
        """Per-server busy intervals — the paper's Fig. 8 bar chart data."""
        return self._telemetry.timeline(self._servers)

    def summary(self) -> Dict[str, Any]:
        return self._telemetry.summary(self._servers)

    def stats_table(self) -> List[Dict[str, Any]]:
        """Per-tag serving rows (completions, EWMA service time, tokens)."""
        return self._telemetry.stats_table()

    def spans(self) -> SpanLog:
        """Drain the process's span recorder (:data:`repro_torch.spans.SPANS`,
        which records only between its ``enable()`` and ``disable()``): the
        spans of this balancer's requests, its pools and the drivers around
        it.

        For an operator, each completed request's ``balancer.request`` span
        splits its latency into ``balancer.queue`` (or ``balancer.admit``),
        ``balancer.coalesce`` and ``balancer.service`` children, by tag and
        server (``balancer.service``'s tag): whether a slow tag waits for a
        free server, for its batch to fill, or in the server itself.  The
        ``summary()`` figures give the same waits only as means over all
        tags."""
        return SPANS.drain()

    # -- checkpointing (paper §7 future work) --------------------------------
    def checkpoint_queue(self) -> List[Dict[str, Any]]:
        """Snapshot pending work: the arrival queue plus any (request,
        server) pairs parked in the worker hand-off deque (possible when
        ``max_workers`` is below the free-server count)."""
        with self._mutex:
            pending = [
                {"theta": r.theta, "tag": r.tag, "batchable": r.batchable}
                for r in self._queue
            ]
        with self._work_cv:
            pending.extend(
                {"theta": r.theta, "tag": r.tag, "batchable": r.batchable}
                for r, _ in self._work
            )
        return pending
