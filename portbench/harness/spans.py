"""The program's spans, reduced to what the per-layer readers read, and put
on the device trace's clock.

The program records spans on ``time.monotonic`` while its recorder
(``repro_torch.spans.SPANS``) is on; a run enables it at the
window's start and drains it after the window (:class:`SpanLog`).
:func:`figures` reduces a drained log to five numbers; each is ``None``
where the window holds nothing to read, and all are ``None`` when the
recorder dropped a record, so no figure comes from a truncated window.

A traced run's profiler trace has a clock of its own.  :func:`trace_clock`
maps the program's clock onto it through two anchors: runtime calls that
the reading thread makes between ``time.monotonic`` stamps just inside the
window's two ends.
:func:`named_idle_gaps` then names each idle stretch of the card by the
state of the thread that launched the operation ending it: the innermost
program span open there at the stretch's middle, else ``<thread> idle``
for a thread the program named, else the label ``Trace.idle_gaps`` gives.
Nothing here changes the trace, so every reader of it reads the same.

Nothing here imports the program: a log is any object with the
``spans``, ``dropped`` and ``threads`` of ``SpanLog``, each span a tuple
in ``Span``'s field order.
"""
from __future__ import annotations

import statistics
from bisect import bisect_left, bisect_right
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from portbench.harness.serving import _p95
from portbench.harness.trace import WINDOW_MARK, Trace

FIGURES = ("driver_host_ms", "fine_queue_wait_ms", "pool_host_share",
           "admission_wait_p95_ms", "prefill_p95_ms")
# The runtime calls by which a pool call reaches the card.
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaMemcpyAsync")
# The runtime calls that anchor the program's clock in a trace: at the
# slice's ends, and every few tens of milliseconds in between.
CLOCK_CALL = "cudaStreamSynchronize"
PROBE_CALL = "cudaMemGetInfo"
PROBE_SLACK_S = 50e-6
# How far (us) a probe call may lie from where the two end anchors put its
# stamps: a quarter of the probes' spacing, above the drift of a slice.
PROBE_MATCH_US = 5000.0


def _dur(s) -> float:
    return s.end - s.start


def figures(log, t0: float, t1: float, fine_tag: str = "level2") -> Dict[str, Optional[float]]:
    """The five span figures of the window ``[t0, t1)`` (``time.monotonic``):

    * ``driver_host_ms``: the ensemble driver's host time a fine sample,
      ms: its ``driver.round`` spans that start in the window, less their
      ``driver.wait`` and ``driver.sync`` children, over the rounds' fine
      samples;
    * ``fine_queue_wait_ms``: mean ``balancer.queue`` (arrival to pop) of the
      ``fine_tag`` requests that arrived in the window, ms;
    * ``pool_host_share``: the level pools' calls in the window, their host
      share, %: sum of ``pool.call`` less its ``pool.sync`` child, over the
      sum of ``pool.call``;
    * ``admission_wait_p95_ms``: p95 of ``balancer.admit`` (submit to
      admission) over the requests submitted in the window, ms (the rule of
      ``ttft_p95_ms``);
    * ``prefill_p95_ms``: p95 of ``pool.prefill`` (admission to first token)
      over the same requests, ms.
    """
    out: Dict[str, Optional[float]] = dict.fromkeys(FIGURES)
    if log is None or log.dropped:
        return out
    spans = log.spans
    rounds = {s.id: s for s in spans if s.name == "driver.round" and t0 <= s.start < t1}
    fine = sum(r.n for r in rounds.values())
    if fine:
        host = sum(_dur(r) for r in rounds.values()) - sum(
            _dur(s) for s in spans
            if s.name in ("driver.wait", "driver.sync") and s.parent in rounds)
        out["driver_host_ms"] = host / fine * 1e3
    waits = [_dur(s) for s in spans
             if s.name == "balancer.queue" and s.tag == fine_tag and t0 <= s.start < t1]
    if waits:
        out["fine_queue_wait_ms"] = statistics.fmean(waits) * 1e3
    calls = {s.id: s for s in spans if s.name == "pool.call" and t0 <= s.start < t1}
    total = sum(_dur(c) for c in calls.values())
    if total > 0:
        synced = sum(_dur(s) for s in spans if s.name == "pool.sync" and s.parent in calls)
        out["pool_host_share"] = 100.0 * (total - synced) / total
    admits = {s.request: s for s in spans if s.name == "balancer.admit" and t0 <= s.start < t1}
    if admits:
        out["admission_wait_p95_ms"] = _p95([_dur(s) for s in admits.values()]) * 1e3
    prefills = [_dur(s) for s in spans if s.name == "pool.prefill" and s.request in admits]
    if prefills:
        out["prefill_p95_ms"] = _p95(prefills) * 1e3
    return out


def trace_clock(trace: Trace, first: float, last: float, thread: Optional[int] = None,
                probes: Sequence[Tuple[float, float]] = ()) -> Callable[[float], float]:
    """``time.monotonic`` seconds -> the trace's microseconds, piecewise
    linear through anchors: runtime calls that the trace holds and that the
    program stamped on its clock.  ``first`` and ``last`` are the middles
    of two stream synchronisations (``CLOCK_CALL``) that ``thread`` made
    just after the tracer opened its window and just before it closed it
    (its first and last such calls in the trace); ``probes`` the stamps
    ``(before, after)`` of the ``PROBE_CALL`` calls a thread made between
    them, every few tens of milliseconds.  A probe and a trace's such call
    are matched where each is the other's nearest, once the end anchors put
    the probe on the trace's clock, within ``PROBE_MATCH_US`` (another
    thread may make the same call, and the trace may lack one); a matched
    probe counts where its stamps lie
    no more than ``PROBE_SLACK_S`` wider apart than the call lasted in the
    trace: a wider pair waited for the interpreter's lock around the call.  The two
    clocks drift apart by some hundred parts per million, unevenly, on the
    card's machine; the runtime's calls and the card's operations share one
    clock in the trace, and the window marker, a host operation, may lie
    milliseconds off it.  With no anchor in the trace (no card) the
    marker's ends stand in.  The returned function's ``anchors`` is the
    number of anchors it runs through."""
    ends = clock_points(trace, thread)
    if not ends:
        return _through([(first, trace.t0), (last, trace.t1)])
    points = [(first, ends[0]), (last, ends[1])]
    linear = _through(points)
    calls = sorted((h.ts + 0.5 * h.dur, h.dur) for h in trace.host
                   if h.name.startswith(PROBE_CALL))
    mids = [c[0] for c in calls]
    probes = sorted(probes)
    guesses = [linear(0.5 * (a + b)) for a, b in probes]
    for k, ((a, b), guess) in enumerate(zip(probes, guesses)):
        j = _nearest(mids, guess)
        if (j is not None and _nearest(guesses, mids[j]) == k
                and abs(mids[j] - guess) <= PROBE_MATCH_US
                and b - a - calls[j][1] * 1e-6 <= PROBE_SLACK_S):
            points.append((0.5 * (a + b), mids[j]))
    return _through(points)


def _nearest(xs: List[float], x: float) -> Optional[int]:
    """Index of the entry of the sorted ``xs`` nearest to ``x``."""
    i = bisect_left(xs, x)
    return min((j for j in (i - 1, i) if 0 <= j < len(xs)), key=lambda j: abs(xs[j] - x),
               default=None)


def _through(points: List[Tuple[float, float]]) -> Callable[[float], float]:
    """The piecewise linear map through ``points`` (program s, trace us),
    extended beyond the outer two."""
    points = sorted(points)
    xs = [p[0] for p in points]

    def clock(t: float) -> float:
        i = min(max(bisect_right(xs, t), 1), len(points) - 1)
        (x0, y0), (x1, y1) = points[i - 1], points[i]
        return y0 + (t - x0) * ((y1 - y0) / (x1 - x0) if x1 > x0 else 1e6)

    clock.anchors = len(points)
    return clock


def clock_points(trace: Trace, thread: Optional[int]) -> Optional[Tuple[float, float]]:
    """The middles (us) of ``thread``'s first and last ``CLOCK_CALL`` in the
    trace, or ``None`` where it holds fewer than two."""
    calls = sorted((h for h in trace.host if h.tid == thread and h.name.startswith(CLOCK_CALL)),
                   key=lambda h: h.ts)
    if thread is None or len(calls) < 2:
        return None
    return calls[0].ts + 0.5 * calls[0].dur, calls[-1].ts + 0.5 * calls[-1].dur


# Spans of a request rather than of the thread that books them: they say
# nothing of what that thread was doing.
REQUEST_SPANS = ("balancer.", "pool.prefill")


class _Stabber:
    """Intervals ``(start, end, item)`` for "which hold this point": those
    no longer than ``short`` (us) sorted by start, the few longer in a list
    of their own."""

    def __init__(self, rows: List[Tuple[float, float, object]], short: float = 1000.0) -> None:
        self.short = short
        self.rows = sorted((r for r in rows if r[1] - r[0] <= short), key=lambda r: r[0])
        self.starts = [r[0] for r in self.rows]
        self.long = [r for r in rows if r[1] - r[0] > short]

    def covering(self, t: float) -> List[Tuple[float, float, object]]:
        lo = bisect_left(self.starts, t - self.short)
        hi = bisect_right(self.starts, t)
        return ([r for r in self.rows[lo:hi] if r[1] >= t]
                + [r for r in self.long if r[0] <= t <= r[1]])


def _on_threads(trace: Trace, log, clock) -> Dict[int, _Stabber]:
    """Each thread's own spans that overlap the slice, on the trace's clock."""
    by_thread: Dict[int, List] = {}
    for s in log.spans:
        if s.name.startswith(REQUEST_SPANS):
            continue
        a, b = clock(s.start), clock(s.end)
        if b >= trace.t0 and a <= trace.t1:
            by_thread.setdefault(s.thread, []).append((a, b, s))
    return {tid: _Stabber(rows) for tid, rows in by_thread.items()}


# The spans inside which a pool's thread launches work on the card.
LAUNCHING_SPANS = ("pool.call",)


def thread_ids(trace: Trace, log, clock) -> Dict[int, int]:
    """A trace's thread id -> the program's (native) one.  The profiler
    writes the native id of the thread that started it.  For the others it
    writes an id of the runtime's tracing: on an H100 machine the low 32
    bits of ``pthread_self()`` (Python's ``threading.get_ident()``) in one
    run and neither that nor the native id in the next.  So a thread id
    that is neither is matched to the program thread whose pool calls (on
    the trace's clock) hold most of its launch calls, where they hold at least half of them and three."""
    out: Dict[int, int] = {}
    for ident, native in getattr(log, "idents", {}).items():
        low = ident & 0xFFFFFFFF
        out[ident] = out[low] = out[low - (1 << 32) if low >> 31 else low] = native
    out.update({native: native for native in log.threads})
    by_thread: Dict[int, List] = {}
    for s in log.spans:
        if s.name in LAUNCHING_SPANS:
            by_thread.setdefault(s.thread, []).append((clock(s.start), clock(s.end), s))
    threads = {tid: _Stabber(rows) for tid, rows in by_thread.items()}
    votes: Dict[int, Counter] = {}
    for h in trace.host:
        if h.tid not in out and h.name.startswith(LAUNCH_CALLS):
            tally = votes.setdefault(h.tid, Counter())
            tally[None] += 1
            for native, stab in threads.items():
                if stab.covering(h.ts):
                    tally[native] += 1
    # One program thread to a trace thread: the surest matches first.
    ranked = sorted(((n / tally[None], n, tid, native)
                     for tid, tally in votes.items()
                     for native, n in tally.items() if native is not None), reverse=True)
    taken = set()
    for share, n, tid, native in ranked:
        if tid not in out and native not in taken and n >= 3 and share >= 0.5:
            out[tid] = native
            taken.add(native)
    return out


def _label(span) -> str:
    return f"{span.name} {span.tag}" if span.tag else span.name


def _gaps(trace: Trace) -> List[Tuple[float, float, float, Optional[object], str]]:
    """Every idle stretch ``(length, a, b, op ending it, op it follows)``,
    longest first, as ``Trace.idle_gaps`` finds them (us)."""
    starts: Dict[float, object] = {}
    ends: Dict[float, str] = {}
    for op in trace.device:
        starts.setdefault(max(op.ts, trace.t0), op)
        ends.setdefault(min(op.ts + op.dur, trace.t1), op.name)
    gaps = []
    edge, prev = trace.t0, "window start"
    for a, b in trace.busy_intervals():
        if a > edge:
            gaps.append((a - edge, edge, a, starts.get(a), prev))
        edge = b
        prev = ends.get(b, prev)
    if trace.t1 > edge:
        gaps.append((trace.t1 - edge, edge, trace.t1, None, prev))
    gaps.sort(key=lambda g: -g[0])
    return gaps


def named_idle_gaps(trace: Trace, log, clock, n: Optional[int] = 10) -> List[List]:
    """The ``n`` longest idle stretches (all with ``n=None``) as
    ``[label, seconds]``, named by the program's spans (module docstring)."""
    threads = _on_threads(trace, log, clock)
    ids = thread_ids(trace, log, clock)
    host = _Stabber([(h.ts, h.ts + h.dur, h) for h in trace.host if h.name != WINDOW_MARK])
    out = []
    for length, a, b, op, after in _gaps(trace)[:n]:
        mid = 0.5 * (a + b)
        corr = op.args.get("correlation") if op is not None else None
        launch = trace.launches.get(int(corr)) if corr is not None else None
        label = None
        if launch is not None:
            tid = ids.get(launch.tid, launch.tid)
            cover = threads[tid].covering(mid) if tid in threads else []
            if cover:
                label = _label(min(cover, key=lambda r: r[1] - r[0])[2])
            elif tid in log.threads:
                label = f"{log.threads[tid]} idle"
        if label is None:  # the trace's own label (Trace.idle_gaps)
            cover = host.covering(mid)
            label = (f"host: {min(cover, key=lambda r: r[1] - r[0])[2].name[:80]}" if cover
                     else f"after {after[:80]}")
        out.append([label, length * 1e-6])
    return out


def idle_by_name(trace: Trace, log, clock) -> Dict[str, float]:
    """Each label's share of the slice's idle time, largest first."""
    tot: Dict[str, float] = {}
    for label, s in named_idle_gaps(trace, log, clock, None):
        tot[label] = tot.get(label, 0.0) + s
    idle = sum(tot.values())
    return {k: v / idle for k, v in sorted(tot.items(), key=lambda kv: -kv[1])} if idle else {}


def clock_check(trace: Trace, log, clock) -> Dict[str, object]:
    """How well the two clocks agree: of the ``pool.call`` spans that lie in
    the slice once mapped, the share that contain a launch call
    (``LAUNCH_CALLS``) on the same thread, and the median distance (us)
    from a span's start to its first such call; the share by thread and by
    tag (``[calls, share]``); and, over the spans that hold none, the median
    distance from a span's start to its thread's nearest launch call."""
    ids = thread_ids(trace, log, clock)
    calls: Dict[int, List[float]] = {}
    for h in trace.host:
        if h.name.startswith(LAUNCH_CALLS):
            calls.setdefault(ids.get(h.tid, h.tid), []).append(h.ts)
    for v in calls.values():
        v.sort()
    n = 0
    offsets, misses = [], []
    parts: Dict[str, List[int]] = {}
    for s in log.spans:
        if s.name != "pool.call":
            continue
        a, b = clock(s.start), clock(s.end)
        if a < trace.t0 or b > trace.t1:
            continue
        n += 1
        ts = calls.get(s.thread, [])
        i = bisect_left(ts, a)
        hit = i < len(ts) and ts[i] <= b
        if hit:
            offsets.append(ts[i] - a)
        elif ts:
            misses.append(min((t - a for t in ts[max(i - 1, 0): i + 1]), key=abs))
        for key in (log.threads.get(s.thread, str(s.thread)), s.tag):
            part = parts.setdefault(key, [0, 0])
            part[0] += 1
            part[1] += hit
    return {"pool_calls": n, "with_launch_share": len(offsets) / n if n else None,
            "median_offset_us": statistics.median(offsets) if offsets else None,
            "miss_nearest_us": statistics.median(misses) if misses else None,
            "by_part": {k: [c, h / c] for k, (c, h) in parts.items()}}

