"""Idle-time / timeline / summary bookkeeping (paper Figs. 8 & 9).

Extracted from the seed's ``LoadBalancer`` so that recording never
contends with the dispatch hot path: every mutation here happens under
``Telemetry``'s own lock, independent of the dispatcher's mutex.

Since the O(1)-dispatch rework this is a **streaming** recorder by
default: ``record_arrival`` / ``record_completion`` are O(1) and total
memory is bounded for million-request runs —

* recording is **off the hot path**: ``record_*`` appends one tuple to a
  ``collections.deque`` (append/popleft are atomic under the GIL — no
  lock acquisition on the worker side) and the aggregates are folded in
  lazily, under the telemetry lock, when anything *reads* them — plus an
  opportunistic fold once the backlog passes ``FOLD_THRESHOLD`` entries,
  which bounds both memory and the amortized cost at O(1) per request;
* the request history and per-server busy intervals live in bounded ring
  buffers (``history_limit`` most-recent entries; ``timeline()`` /
  ``idle_times()`` keep their exact output shape over that window);
* idle-time statistics are running moments (count / sum / max) plus
  :class:`P2Quantile` estimators (Jain & Chlamtac's P² algorithm) for the
  p50/p99 the paper's Fig. 9 reports — no sort over the full history;
* ``runtime_quantile`` answers from a bounded per-tag window of recent
  service times (sorted on read, O(window log window)), instead of
  sorting every runtime ever recorded on each hedged submit.

``Telemetry(exact=True)`` restores the seed's exact unbounded behaviour
(full history, quantiles from a sort over everything) for tests and
paper-figure reproduction runs; ``summary()`` returns the same keys in
both modes.  The EWMA cost model consumed by the ``cost_aware`` policy
(per tag and per (server, tag); see DESIGN.md §3) is O(1) in both modes.

While the span recorder (:data:`repro_torch.spans.SPANS`) is on, a
completion also books the request's ``balancer.*`` spans from its stamps.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.spans import SPANS

from .types import Request, Server

EWMA_ALPHA = 0.2  # smoothing for the per-tag / per-(server, tag) cost model
HISTORY_LIMIT = 16384  # streaming mode: ring capacity for history/intervals
RUNTIME_WINDOW = 1024  # streaming mode: per-tag service-time window
# Opportunistic fold once this many records are pending.  Also bounds the
# worst-case fold burst a read can pay (policy reads under the dispatcher
# mutex included), so it trades fold frequency against stall size.
FOLD_THRESHOLD = 128


class P2Quantile:
    """Streaming quantile estimator (Jain & Chlamtac 1985, the P² algorithm).

    Five markers track the running quantile with O(1) memory and O(1) per
    observation; below five observations the estimate is exact (sorted
    buffer).  Good to a few percent on the unimodal latency distributions
    the balancer sees — the exact mode exists for anything stricter.
    """

    __slots__ = ("q", "_n", "_heights", "_pos", "_want", "_inc")

    def __init__(self, q: float) -> None:
        self.q = q
        self._n = 0
        self._heights: List[float] = []
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._want = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
        self._inc = [0.0, q / 2, q, (1 + q) / 2, 1.0]

    def add(self, x: float) -> None:
        self._n += 1
        h = self._heights
        if self._n <= 5:
            h.append(x)
            h.sort()
            return
        # locate the cell containing x, clamping the extreme markers
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self._pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._inc[i]
        # adjust the three interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._want[i] - self._pos[i]
            if (d >= 1.0 and self._pos[i + 1] - self._pos[i] > 1.0) or (
                d <= -1.0 and self._pos[i - 1] - self._pos[i] < -1.0
            ):
                sign = 1.0 if d >= 1.0 else -1.0
                candidate = self._parabolic(i, sign)
                if h[i - 1] < candidate < h[i + 1]:
                    h[i] = candidate
                else:  # parabolic estimate left the bracket: linear step
                    j = i + (1 if sign > 0 else -1)
                    h[i] += sign * (h[j] - h[i]) / (self._pos[j] - self._pos[i])
                self._pos[i] += sign

    def _parabolic(self, i: int, sign: float) -> float:
        h, p = self._heights, self._pos
        return h[i] + sign / (p[i + 1] - p[i - 1]) * (
            (p[i] - p[i - 1] + sign)
            * (h[i + 1] - h[i])
            / (p[i + 1] - p[i])
            + (p[i + 1] - p[i] - sign)
            * (h[i] - h[i - 1])
            / (p[i] - p[i - 1])
        )

    def value(self) -> Optional[float]:
        if self._n == 0:
            return None
        if self._n <= 5:  # exact while the marker set is still filling
            xs = self._heights
            return xs[min(len(xs) - 1, int(self.q * len(xs)))]
        return self._heights[2]


def _book_spans(req: Request, server: Server, batch: int) -> None:
    """Book a completed request's ``balancer.request`` span and its children
    (:mod:`repro_torch.spans`) from the stamps it carries."""
    rid = SPANS.new_id()
    arrived, dispatched, seq = req.arrived_at, req.dispatched_at, req.seq
    # A pop stamp is taken only by a coalescing window, while recording.
    popped = req.popped_at if arrived <= req.popped_at <= dispatched else dispatched
    wait = "balancer.admit" if server.continuous else "balancer.queue"
    SPANS.add(wait, arrived, popped, parent=rid, request=seq, tag=req.tag)
    if popped < dispatched:
        SPANS.add("balancer.coalesce", popped, dispatched, parent=rid, request=seq, tag=req.tag)
    SPANS.add("balancer.service", dispatched, req.completed_at, parent=rid, request=seq,
              tag=server.name, n=batch)
    SPANS.add("balancer.request", arrived, req.completed_at, id=rid, request=seq,
              tag=req.tag, n=batch)


class Telemetry:
    """Thread-safe request history + runtime statistics."""

    def __init__(
        self,
        *,
        ewma_alpha: float = EWMA_ALPHA,
        exact: bool = False,
        history_limit: int = HISTORY_LIMIT,
        runtime_window: int = RUNTIME_WINDOW,
    ) -> None:
        self._lock = threading.Lock()
        self._exact = exact
        self._history_limit = None if exact else history_limit
        self._runtime_window = None if exact else runtime_window
        self._history: deque = deque(maxlen=self._history_limit)
        # Records not yet folded into the aggregates below.  deque append /
        # popleft are atomic under the GIL, so the recording side never
        # takes a lock; folding happens under self._lock on reads (and
        # opportunistically past FOLD_THRESHOLD).
        self._pending: deque = deque()
        self._runtimes: Dict[str, deque] = {}
        self._tag_ewma: Dict[str, float] = {}
        self._server_tag_ewma: Dict[tuple, float] = {}
        self._server_busy_s: Dict[str, float] = {}
        self._batch_hist: Dict[str, Dict[int, int]] = {}
        # serving counters: generated tokens per tag, completions per tag,
        # and per-server slot occupancy (continuous-batching DecodePools)
        self._tag_tokens: Dict[str, int] = {}
        self._tag_done: Dict[str, int] = {}
        self._occupancy: Dict[str, Dict[str, float]] = {}
        # paged serving: per-pool KV-block occupancy, per-tag speculative
        # draft/accept counters
        self._blocks: Dict[str, Dict[str, float]] = {}
        self._spec: Dict[str, Dict[str, int]] = {}
        # remote serving: per-(server, tag) wire vs service split
        self._wire: Dict[tuple, Dict[str, float]] = {}
        # fault counters, keyed (kind, tag): server deaths, requeues,
        # retries-exhausted, shed/rejected submissions, re-admissions, ...
        self._faults: Dict[tuple, int] = {}
        self._ewma_alpha = ewma_alpha
        # streaming idle-time aggregates (exact mode derives from _history)
        self._idle_n = 0
        self._idle_sum = 0.0
        self._idle_max = 0.0
        self._idle_p50 = P2Quantile(0.50)
        self._idle_p99 = P2Quantile(0.99)

    @property
    def exact(self) -> bool:
        return self._exact

    # -- recording (called by the dispatcher / workers) ----------------------
    # Each record_* is an O(1) lock-free deque append; _maybe_fold keeps
    # the backlog (and therefore memory) bounded without putting a lock
    # acquisition on every request.
    def record_arrival(self, req: Request) -> None:
        """Book an *admitted* request.  Rejected submissions (shutdown, no
        server accepts the tag) are never recorded, so ``summary()`` counts
        and the history window reflect real traffic only."""
        self._history.append(req)  # ring append: atomic under the GIL

    def record_completion(self, req: Request, server: Server, batch: int = 1) -> None:
        """Book a completion: server stats + runtime model + idle stats
        (and, while the span recorder records, the request's spans; ``batch``
        is the size of the call that served it).

        Per-server bookkeeping is eager and lock-free: a server is
        executed by exactly one worker at a time (it is ``busy`` from
        dispatch to free, with the transitions ordered by the dispatcher's
        mutex), so its ``stats`` never see concurrent writers.  The global
        aggregates (EWMA cost model, idle moments, quantile windows) are
        shared across workers and go through the pending queue instead.
        """
        dt = req.completed_at - req.dispatched_at
        stats = server.stats
        if self._history_limit is not None and not isinstance(
            stats.busy_log, deque
        ):  # first touch in streaming mode: bound the per-server ring
            stats.busy_log = deque(stats.busy_log, maxlen=self._history_limit)
        stats.busy_log.append((req.dispatched_at, req.completed_at, req.tag))
        stats.n_requests += 1
        stats.busy_s += dt
        # _server_busy_s is keyed by NAME, which may be shared by several
        # Server objects (retire_server retires by name), so its
        # read-modify-write stays under the lock — in the fold.
        self._pending.append(("completion", req, server))
        if SPANS.on:
            _book_spans(req, server, batch)
        self._maybe_fold()

    def record_batched(self, reqs: Sequence[Request], server: Server) -> None:
        """Book the extra members of a coalesced batch (one fused solve)."""
        server.stats.n_requests += len(reqs)  # eager: single-owner stats
        self._pending.append(("batched", tuple(reqs), server))
        if SPANS.on:
            for r in reqs:
                _book_spans(r, server, len(reqs) + 1)
        self._maybe_fold()

    def _maybe_fold(self) -> None:
        if len(self._pending) >= FOLD_THRESHOLD:
            with self._lock:
                self._fold_locked()

    def _fold_locked(self) -> None:
        """Fold every pending record into the aggregates (lock held)."""
        while True:
            try:
                kind, a, b = self._pending.popleft()
            except IndexError:
                return
            if kind == "completion":
                dt = a.completed_at - a.dispatched_at
                self._server_busy_s[b.name] = (
                    self._server_busy_s.get(b.name, 0.0) + dt
                )
                self._record_runtime_locked(a.tag, dt, b.name)
                self._tag_done[a.tag] = self._tag_done.get(a.tag, 0) + 1
                self._book_idle_locked(a)
            elif kind == "batched":
                for r in a:
                    self._book_idle_locked(r)
            elif kind == "tokens":
                self._tag_tokens[a] = self._tag_tokens.get(a, 0) + b
            elif kind == "wire":
                wire_s, service_s = b
                w = self._wire.get(a)
                if w is None:
                    w = self._wire[a] = {
                        "n": 0, "wire_s": 0.0, "service_s": 0.0,
                        "wire_ewma": wire_s, "service_ewma": service_s,
                    }
                al = self._ewma_alpha
                w["n"] += 1
                w["wire_s"] += wire_s
                w["service_s"] += service_s
                w["wire_ewma"] = (1 - al) * w["wire_ewma"] + al * wire_s
                w["service_ewma"] = (
                    (1 - al) * w["service_ewma"] + al * service_s
                )
            elif kind == "fault":
                self._faults[(a, b)] = self._faults.get((a, b), 0) + 1
            elif kind == "occupancy":
                occupied, capacity = b
                occ = self._occupancy.get(a)
                if occ is None:
                    occ = self._occupancy[a] = {
                        "steps": 0, "slot_steps": 0.0, "capacity": float(capacity),
                        "ewma": occupied / capacity,
                    }
                occ["steps"] += 1
                occ["slot_steps"] += occupied
                occ["capacity"] = float(capacity)
                al = self._ewma_alpha
                occ["ewma"] = (1 - al) * occ["ewma"] + al * (occupied / capacity)
            elif kind == "blocks":
                used, capacity = b
                blk = self._blocks.get(a)
                if blk is None:
                    blk = self._blocks[a] = {
                        "steps": 0, "block_steps": 0.0,
                        "capacity": float(capacity),
                        "ewma": used / capacity,
                    }
                blk["steps"] += 1
                blk["block_steps"] += used
                blk["capacity"] = float(capacity)
                al = self._ewma_alpha
                blk["ewma"] = (1 - al) * blk["ewma"] + al * (used / capacity)
            elif kind == "spec":
                accepted, drafted = b
                sp = self._spec.get(a)
                if sp is None:
                    sp = self._spec[a] = {"rounds": 0, "accepted": 0, "drafted": 0}
                sp["rounds"] += 1
                sp["accepted"] += accepted
                sp["drafted"] += drafted
            else:  # "batch_size"
                hist = self._batch_hist.setdefault(a, {})
                hist[b] = hist.get(b, 0) + 1

    def _book_idle_locked(self, req: Request) -> None:
        """Fold one completed request into the running idle-time moments.

        Skips errored requests and hedge losers, mirroring the read-time
        filter of ``idle_times()``; ``rebook_hedged`` repairs the rare race
        where a hedge copy completes before the race is resolved.
        """
        if req.error is not None or req.hedged or req.idle_booked:
            return
        req.idle_booked = True
        delay = req.queue_delay
        self._idle_n += 1
        self._idle_sum += delay
        if delay > self._idle_max:
            self._idle_max = delay
        self._idle_p50.add(delay)
        self._idle_p99.add(delay)

    def rebook_hedged(self, winner: Request, loser: Request) -> None:
        """Repair idle aggregates after a hedge race resolves.

        Flags flip *after* completion can land: the loser may already be
        booked (subtract its count/sum contribution — the quantile markers
        cannot un-observe, an accepted streaming approximation) and the
        winner may have been skipped because it still carried the
        presumed-loser flag (book it now).
        """
        with self._lock:
            self._fold_locked()  # settle completions that raced the flags
            if loser.idle_booked:
                loser.idle_booked = False
                self._idle_n -= 1
                self._idle_sum -= loser.queue_delay
            if winner.done.is_set():
                self._book_idle_locked(winner)

    def record_batch_size(self, tag: str, size: int) -> None:
        """Book the realised size of one coalesced dispatch (size >= 1).

        Size-1 dispatches are recorded too: the histogram answers 'how
        often does coalescing actually fire', so the lone-request case is
        signal, not noise.
        """
        self._pending.append(("batch_size", tag, size))
        self._maybe_fold()

    def record_tokens(self, tag: str, n: int) -> None:
        """Book ``n`` generated tokens against ``tag`` (serving workloads:
        the tokens/s numerator, alongside the paper's idle-time columns)."""
        if n:
            self._pending.append(("tokens", tag, n))
            self._maybe_fold()

    def record_occupancy(self, server: str, occupied: int, capacity: int) -> None:
        """Book one decode step's slot occupancy for a continuous-batching
        pool: ``occupied`` of ``capacity`` slots emitted a token.  Folded
        into a per-server EWMA + running mean — the 'how full does the
        fused step run' metric BENCH_serve.json reports."""
        self._pending.append(("occupancy", server, (occupied, capacity)))
        self._maybe_fold()

    def record_blocks(self, server: str, used: int, capacity: int) -> None:
        """Book one token boundary's KV-block occupancy for a paged pool:
        ``used`` of ``capacity`` blocks are leased to in-flight slots.
        The block-granular analogue of :meth:`record_occupancy` — together
        they show whether a pool is slot-bound or memory-bound."""
        if capacity > 0:
            self._pending.append(("blocks", server, (used, capacity)))
            self._maybe_fold()

    def record_spec(self, tag: str, accepted: int, drafted: int) -> None:
        """Book one speculative-decoding round: ``drafted`` draft tokens
        proposed, ``accepted`` of them verified (accepted-prefix rule).
        Folded into per-tag totals; the accept *rate* is the number that
        says whether the draft model is paying for itself."""
        self._pending.append(("spec", tag, (accepted, drafted)))
        self._maybe_fold()

    def record_wire(
        self, server: str, tag: str, wire_s: float, service_s: float
    ) -> None:
        """Book one remote call's wire/service split for ``(server, tag)``.

        ``service_s`` is the shell-reported handler seconds, ``wire_s``
        the remainder of the observed round trip (serialization + socket
        + queueing inside the remote shell).  Folded into per-(server,
        tag) totals and EWMAs; ``summary()['wire_split']`` reports them —
        the number that shows whether the wire or the solver is the
        bottleneck of a distributed run.
        """
        self._pending.append(("wire", (server, tag), (wire_s, service_s)))
        self._maybe_fold()

    def record_fault(self, kind: str, tag: str = "") -> None:
        """Book one fault event of ``kind`` against ``tag``.

        Kinds in use: ``server_death``, ``requeue``, ``retries_exhausted``,
        ``poison``, ``queue_full``, ``deadline_shed``, ``rejected``,
        ``readmission``, ``breaker_open``.  Counters are independent of the
        request history — a rejected submission moves a fault counter but
        is still never booked as traffic (``n_requests`` / idle stats /
        the history ring are untouched).  Surfaced as
        ``summary()['fault_counters']`` and per-tag columns in
        :meth:`stats_table`.
        """
        self._pending.append(("fault", kind, tag))
        self._maybe_fold()

    def fault_count(self, kind: str, tag: Optional[str] = None) -> int:
        """Total count for ``kind`` (summed over tags, or one ``tag``)."""
        with self._lock:
            self._fold_locked()
            if tag is not None:
                return self._faults.get((kind, tag), 0)
            return sum(n for (k, _t), n in self._faults.items() if k == kind)

    def record_failure(self, server: Server) -> None:
        server.stats.n_failures += 1  # eager: single-owner stats

    def record_member_failure(self, server: Server) -> None:
        """Book a per-member batch failure (poisoned theta): the request
        errored but the server is healthy — counted in ``n_failures`` so
        ``summary()`` never misreads failed evaluations as served work."""
        self.record_failure(server)

    def _record_runtime_locked(self, tag: str, dt: float, server: Optional[str]) -> None:
        window = self._runtimes.get(tag)
        if window is None:
            window = self._runtimes[tag] = deque(maxlen=self._runtime_window)
        window.append(dt)
        a = self._ewma_alpha
        prev = self._tag_ewma.get(tag)
        self._tag_ewma[tag] = dt if prev is None else (1 - a) * prev + a * dt
        if server is not None:
            key = (server, tag)
            prev = self._server_tag_ewma.get(key)
            self._server_tag_ewma[key] = (
                dt if prev is None else (1 - a) * prev + a * dt
            )

    # -- cost model reads (consumed by scheduling policies) ------------------
    def tag_ewma(self, tag: str) -> Optional[float]:
        with self._lock:
            self._fold_locked()
            return self._tag_ewma.get(tag)

    def server_tag_ewma(self, server: str, tag: str) -> Optional[float]:
        with self._lock:
            self._fold_locked()
            return self._server_tag_ewma.get((server, tag))

    def tag_ewmas(self) -> Dict[str, float]:
        with self._lock:
            self._fold_locked()
            return dict(self._tag_ewma)

    def server_busy_seconds(self, server: str) -> float:
        with self._lock:
            self._fold_locked()
            return self._server_busy_s.get(server, 0.0)

    def batch_histogram(self, tag: Optional[str] = None) -> Dict:
        """Realised coalesced-batch sizes: ``{size: count}`` for ``tag``,
        or ``{tag: {size: count}}`` for every tag when ``tag`` is None."""
        with self._lock:
            self._fold_locked()
            if tag is not None:
                return dict(self._batch_hist.get(tag, {}))
            return {t: dict(h) for t, h in self._batch_hist.items()}

    def runtime_quantile(self, tag: str, q: float) -> Optional[float]:
        """Service-time quantile for ``tag`` over the recent window
        (streaming) or the full history (exact).  None below 4 samples."""
        with self._lock:
            self._fold_locked()
            xs = sorted(self._runtimes.get(tag, ()))
        if len(xs) < 4:
            return None
        idx = min(len(xs) - 1, int(q * len(xs)))
        return xs[idx]

    # -- reporting (paper Figs. 8 & 9) ---------------------------------------
    def idle_times(self) -> List[float]:
        """Queue delays of completed requests — the paper's Fig. 9 metric.

        Hedge losers (``hedged`` flag, set on whichever duplicate lost the
        race) are excluded so duplicated work does not skew the statistic.
        In streaming mode this covers the history ring (the
        ``history_limit`` most recent requests); ``summary()``'s moments
        cover the entire run in both modes.
        """
        with self._lock:
            history = list(self._history)
        return [
            r.queue_delay
            for r in history
            if r.done.is_set() and r.error is None and not r.hedged
        ]

    def timeline(self, servers: Sequence[Server]) -> List[Dict[str, Any]]:
        """Per-server busy intervals — the paper's Fig. 8 bar chart data."""
        with self._lock:
            self._fold_locked()
            rows = []
            for s in servers:
                # list(deque) is one C call — an atomic snapshot under the
                # GIL even though the owning worker appends lock-free; the
                # single (start, end, tag) log cannot misalign.
                for a, b, tag in list(s.stats.busy_log):
                    rows.append({"server": s.name, "start": a, "end": b, "tag": tag})
        return rows

    def summary(self, servers: Sequence[Server]) -> Dict[str, Any]:
        if self._exact:
            idles_sorted = sorted(self.idle_times())
            n = len(idles_sorted)
            stats = {
                "n_requests": n,
                "mean_idle_s": sum(idles_sorted) / n if n else 0.0,
                "p50_idle_s": idles_sorted[n // 2] if n else 0.0,
                "p99_idle_s": idles_sorted[min(n - 1, int(0.99 * n))] if n else 0.0,
                "max_idle_s": idles_sorted[-1] if n else 0.0,
            }
        else:
            with self._lock:
                self._fold_locked()
                n = self._idle_n
                stats = {
                    "n_requests": n,
                    "mean_idle_s": self._idle_sum / n if n else 0.0,
                    "p50_idle_s": self._idle_p50.value() or 0.0,
                    "p99_idle_s": self._idle_p99.value() or 0.0,
                    "max_idle_s": self._idle_max,
                }
        with self._lock:
            self._fold_locked()
            stats["per_server_uptime"] = {s.name: s.stats.uptime() for s in servers}
            stats["failures"] = sum(s.stats.n_failures for s in servers)
            stats["batch_histogram"] = {
                t: dict(h) for t, h in self._batch_hist.items()
            }
            stats["tag_tokens"] = dict(self._tag_tokens)
            stats["wire_split"] = {
                f"{server}:{tag}": {
                    "calls": int(w["n"]),
                    "wire_s": w["wire_s"],
                    "service_s": w["service_s"],
                    "wire_ewma_s": w["wire_ewma"],
                    "service_ewma_s": w["service_ewma"],
                }
                for (server, tag), w in self._wire.items()
            }
            fault_counters: Dict[str, Dict[str, int]] = {}
            for (kind, tag), n in self._faults.items():
                fault_counters.setdefault(kind, {})[tag] = n
            stats["fault_counters"] = fault_counters
            stats["slot_occupancy"] = {
                name: {
                    "mean": occ["slot_steps"] / (occ["steps"] * occ["capacity"])
                    if occ["steps"]
                    else 0.0,
                    "ewma": occ["ewma"],
                    "steps": occ["steps"],
                    "capacity": int(occ["capacity"]),
                }
                for name, occ in self._occupancy.items()
            }
            stats["block_occupancy"] = {
                name: {
                    "mean": blk["block_steps"] / (blk["steps"] * blk["capacity"])
                    if blk["steps"]
                    else 0.0,
                    "ewma": blk["ewma"],
                    "steps": blk["steps"],
                    "capacity": int(blk["capacity"]),
                }
                for name, blk in self._blocks.items()
            }
            stats["spec_accept"] = {
                tag: {
                    "rounds": sp["rounds"],
                    "accepted": sp["accepted"],
                    "drafted": sp["drafted"],
                    "rate": sp["accepted"] / sp["drafted"]
                    if sp["drafted"]
                    else 0.0,
                }
                for tag, sp in self._spec.items()
            }
        return stats

    def stats_table(self) -> List[Dict[str, Any]]:
        """Per-tag serving/runtime rows for human-readable reports.

        One row per tag ever completed: request count, EWMA service time,
        the generated-token counter (0 for non-serving tags), for tags
        served by remote servers the EWMA wire seconds per call (None for
        purely local tags), and the failure columns — server deaths,
        requeues, retries-exhausted, shed/rejected submissions
        (queue-full + deadline-shed + unservable rejections), and
        re-admissions.
        """
        with self._lock:
            self._fold_locked()
            tags = sorted(
                set(self._tag_done)
                | set(self._tag_tokens)
                | set(self._spec)
                | {t for _k, t in self._faults}
            )
            wire_by_tag: Dict[str, float] = {}
            for (_server, tag), w in self._wire.items():
                # several replicas may serve one tag: report the worst EWMA
                prev = wire_by_tag.get(tag)
                if prev is None or w["wire_ewma"] > prev:
                    wire_by_tag[tag] = w["wire_ewma"]

            def fault(kind: str, tag: str) -> int:
                return self._faults.get((kind, tag), 0)

            return [
                {
                    "tag": tag,
                    "n_done": self._tag_done.get(tag, 0),
                    "ewma_s": self._tag_ewma.get(tag),
                    "tokens": self._tag_tokens.get(tag, 0),
                    "wire_ewma_s": wire_by_tag.get(tag),
                    "n_deaths": fault("server_death", tag),
                    "n_requeues": fault("requeue", tag),
                    "n_retries_exhausted": fault("retries_exhausted", tag),
                    "n_shed": (
                        fault("queue_full", tag)
                        + fault("deadline_shed", tag)
                        + fault("rejected", tag)
                    ),
                    "n_readmitted": fault("readmission", tag),
                    "spec_accept_rate": (
                        self._spec[tag]["accepted"] / self._spec[tag]["drafted"]
                        if tag in self._spec and self._spec[tag]["drafted"]
                        else None
                    ),
                }
                for tag in tags
            ]
