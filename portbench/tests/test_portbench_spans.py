"""The program's spans as the harness reads them (``portbench.harness.spans``
and ``portbench/tools/span_readings.py``): the span figures agree with the
stamps the other readers use, idle gaps are named on the trace's clock by
the launching thread's spans, and naming them changes no existing reading."""
from __future__ import annotations

import json

import pytest

from portbench.harness import cells, spans
from portbench.harness.trace import parse
from portbench.tests import tiny


def _window(name):
    """Set a tiny cell up, run its window with the recorder on; the bench
    and the drained log."""
    from repro_torch.spans import SPANS

    ctx = tiny.context(name)
    bench = cells.load_driver(ctx.cell).Bench(ctx)
    SPANS.drain()
    SPANS.enable()
    try:
        bench.window()
    finally:
        SPANS.disable()
    log = SPANS.drain()
    return bench, log


def test_mlda_waits_are_the_balancers_idle_time():
    """Queue plus coalescing wait, over every tag, is the balancer's idle
    time differenced at the window's edges: both read the same stamps."""
    bench, log = _window("mlda-paper")
    try:
        assert log.dropped == 0
        top = {s.id for s in log.spans if s.name == "balancer.request"}
        waits = [s.end - s.start for s in log.spans
                 if s.name in ("balancer.queue", "balancer.coalesce") and s.parent in top]
        facts = bench.facts
        assert len(top) == facts["idle_n"] > 0
        assert abs(sum(waits) / len(top) - facts["idle_sum_s"] / facts["idle_n"]) < 1e-9
    finally:
        bench.release()


def test_chat_time_to_first_token_is_admission_wait_plus_prefill():
    """Each request's submit stamp, its admission wait and its prefill add
    up to its first token's stamp; what is left is the submission path up
    to the balancer's arrival stamp."""
    bench, log = _window("granite-chat")
    try:
        admits = sorted((s for s in log.spans if s.name == "balancer.admit"),
                        key=lambda s: s.request)
        prefill = {s.request: s for s in log.spans if s.name == "pool.prefill"}
        records = [r for r in bench.records if r.result is not None]
        assert len(admits) == len(records) == len(bench.records) > 0
        for rec, adm in zip(records, admits):  # one submitting thread: seq order
            pre = prefill[adm.request]
            first = rec.result.token_times[0]
            lead = adm.start - rec.submitted
            assert 0.0 <= lead < 5e-3
            assert adm.end == pre.start
            total = rec.submitted + (adm.end - adm.start) + (pre.end - pre.start)
            assert abs(total + lead - first) < 1e-9
    finally:
        bench.release()


EXPECTED = {
    "mlda-paper": {"driver_host_ms", "fine_queue_wait_ms", "pool_host_share"},
    "mlda-paper-device": {"driver_host_ms", "fine_queue_wait_ms", "pool_host_share"},
    "granite-chat": {"admission_wait_p95_ms", "prefill_p95_ms"},
    "granite-batch": {"admission_wait_p95_ms", "prefill_p95_ms"},
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_readings_tool_reports_the_figures(name):
    """The tool's traced run reports its cell's span figures on the CPU,
    drops nothing, and leaves the run's own result as it was."""
    from portbench.tools.span_readings import run

    out, checks = run(tiny.context(name, trace=True))
    sp = out["spans"]
    assert out["correct"] is True and list(out)[-1] == "checks"
    assert sp["dropped"] == 0 and sp["records"] > 0
    assert {k for k in spans.FIGURES if sp[k] is not None} == EXPECTED[name]
    assert all(sp[k] >= 0 for k in EXPECTED[name])
    assert ("idle_gaps" in sp) == name.startswith("mlda")
    json.dumps(out)


def test_span_readings_tool_off_records_nothing():
    from portbench.tools.span_readings import run

    out, _ = run(tiny.context("granite-chat"), on=False)
    assert out["spans"]["records"] == 0
    assert all(out["spans"][k] is None for k in spans.FIGURES)
    assert out["correct"] is True and "ttft_p95_ms" in out["metrics"]


class _Log:
    def __init__(self, rows, dropped=0, threads=None, idents=None):
        from repro_torch.spans import Span

        self.spans = [Span(*r) for r in rows]
        self.dropped = dropped
        self.threads = threads or {}
        self.idents = idents or {}


def test_figures_from_a_known_log():
    rows = [  # id, name, start, end, thread, parent, request, tag, n
        (1, "driver.round", 10.0, 12.0, 7, 0, -1, "", 20),
        (0, "driver.wait", 10.5, 11.0, 7, 1, -1, "", 0),
        (0, "driver.sync", 11.0, 11.5, 7, 1, -1, "", 0),
        (0, "balancer.queue", 10.1, 10.3, 8, 2, 5, "level2", 0),
        (0, "balancer.queue", 10.2, 10.3, 8, 3, 6, "level2", 0),
        (0, "balancer.queue", 10.2, 10.9, 8, 4, 7, "level1", 0),
        (0, "balancer.queue", 9.0, 10.3, 8, 5, 4, "level2", 0),  # arrived before
        (9, "pool.call", 10.0, 10.4, 8, 0, -1, "level2", 2),
        (0, "pool.sync", 10.1, 10.4, 8, 9, -1, "level2", 2),
        (0, "balancer.admit", 10.0, 10.2, 9, 6, 11, "prefill:g", 0),
        (0, "balancer.admit", 10.1, 10.2, 9, 7, 12, "prefill:g", 0),
        (0, "pool.prefill", 10.2, 10.6, 9, 0, 11, "prefill:g", 3),
        (0, "pool.prefill", 10.2, 10.3, 9, 0, 12, "prefill:g", 1),
    ]
    got = spans.figures(_Log(rows), 10.0, 13.0)
    assert got["driver_host_ms"] == pytest.approx(1.0 / 20 * 1e3)
    assert got["fine_queue_wait_ms"] == pytest.approx(150.0)
    assert got["pool_host_share"] == pytest.approx(25.0)
    # p95 by the rule of ttft_p95_ms (statistics.quantiles, n=20)
    assert got["admission_wait_p95_ms"] == pytest.approx(spans._p95([0.2, 0.1]) * 1e3)
    assert got["prefill_p95_ms"] == pytest.approx(spans._p95([0.4, 0.1]) * 1e3)
    assert all(v is None for v in spans.figures(_Log(rows, dropped=1), 10.0, 13.0).values())
    assert all(v is None for v in spans.figures(_Log([]), 10.0, 13.0).values())


# How the profiler writes the launching threads: its own by native id
# (111); the others by pthread_self() (the log's idents, 333) or by an id
# of neither kind (222's), which its launches inside its pool call match.
IDENT_222, IDENT_333 = (1 << 40) + 0x02345678, 139_637_976_727_296
TRACE_TIDS = (111, 0x7EFFF940, IDENT_333)


def _chrome(path):
    """A profiler trace: the window marker over [500, 10500] us, three
    kernels launched by threads 111, 222 and 333, and thread 111's two
    stream synchronisations at 1000 and 11000 us, on the runtime's clock
    (the marker, a host operation, lies 500 us off it)."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 500,
           "dur": 10000, "tid": 1}]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": ts,
            "dur": 0, "tid": 111, "args": {}} for ts in (1000, 11000)]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": ts,
            "dur": 10, "tid": TRACE_TIDS[1], "args": {}} for ts in (1600, 1700)]
    for corr, (ts, dur, tid, name) in enumerate([
            (1500, 500, TRACE_TIDS[0], "swe_fused_step_kernel<4>"),
            (4000, 1000, TRACE_TIDS[1], "other_kernel"),
            (8000, 500, TRACE_TIDS[2], "swe_fused_step_kernel<4>")], start=1):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
                   "args": {"correlation": corr, "grid": [3, 3, 8]}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": ts - 100,
                   "dur": 20, "tid": tid, "args": {"correlation": corr}})
    path.write_text(json.dumps({"traceEvents": ev}))
    return parse(path)


def _readers(trace):
    names = ["device_idle.mlda", "swe_fused_step_roofline"]
    facts = {"grids": {"3": [96, 96]}, "n_probes": 2}
    return {n: cells.load_metric(n).read(facts, trace) for n in names}


def test_gaps_are_named_by_the_launching_threads_spans(tmp_path):
    trace = _chrome(tmp_path / "t.json")
    before = (_readers(trace), trace.idle_gaps(10), trace.busy_s())
    # Program spans on time.monotonic, the anchors (thread 111's two
    # synchronisations) at 50.0 s and 50.01 s: a span at t lies at
    # 1000 + (t - 50) * 1e6 us in the trace.
    log = _Log([
        (1, "driver.round", 49.9, 50.02, 111, 0, -1, "", 5),
        (0, "driver.sync", 50.0001, 50.0004, 111, 1, -1, "", 0),
        (2, "pool.call", 50.0005, 50.0035, 222, 0, -1, "level2", 4),
        (0, "pool.sync", 50.0031, 50.0035, 222, 2, -1, "level2", 4),
        (0, "balancer.queue", 50.004, 50.009, 333, 3, 9, "level2", 0),  # a request's
    ], threads={333: "lb-worker-2", 222: "lb-worker-1", 111: "MainThread"},
        idents={IDENT_222: 222, IDENT_333: 333})
    clock = spans.trace_clock(trace, 50.0, 50.01, thread=111)
    assert clock(50.0) == 1000.0 and abs(clock(50.01) - 11000.0) < 1e-6
    assert spans.trace_clock(trace, 50.0, 50.01)(50.0) == trace.t0 == 500.0  # no anchors
    named = spans.named_idle_gaps(trace, log, clock)
    assert [g[0] for g in named] == [
        "lb-worker-2 idle",  # [5000, 8000): 333 has no span of its own there
        "pool.call level2",  # [2000, 4000): 222 inside its call, not yet syncing
        "after swe_fused_step_kernel<4>",  # [8500, 10500): no launch ends it
        "driver.round",  # [500, 1500): 111's innermost span at 1000
    ]
    assert [g[1] for g in named] == pytest.approx([g[1] for g in trace.idle_gaps(10)])
    shares = spans.idle_by_name(trace, log, clock)
    assert sum(shares.values()) == pytest.approx(1.0)
    assert shares["lb-worker-2 idle"] == pytest.approx(3000 / 8000)
    assert shares["driver.round"] == pytest.approx(1000 / 8000)
    assert spans.thread_ids(trace, log, clock)[TRACE_TIDS[1]] == 222
    check = spans.clock_check(trace, log, clock)
    assert check == {"pool_calls": 1, "with_launch_share": 1.0,
                     "median_offset_us": pytest.approx(100.0), "miss_nearest_us": None,
                     "by_part": {"lb-worker-1": [1, 1.0], "level2": [1, 1.0]}}
    # Naming reads the trace and changes none of it.
    assert (_readers(trace), trace.idle_gaps(10), trace.busy_s()) == before
    assert before[0]["swe_fused_step_roofline"] > 0


def test_clock_follows_the_probe_calls(tmp_path, monkeypatch):
    """Between the two end anchors the mapping runs through the probe calls,
    each matched to the call nearest to where the end anchors put it."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 500,
           "dur": 10000, "tid": 1}]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": ts,
            "dur": 0, "tid": 111, "args": {}} for ts in (1000, 11000)]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaMemGetInfo", "ts": ts, "dur": 20,
            "tid": 7, "args": {}} for ts in (5490, 9990)]  # the second another thread's
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    trace = parse(path)
    clock = spans.trace_clock(trace, 50.0, 50.01, thread=111, probes=[(50.00499, 50.00501)])
    assert clock.anchors == 3 and clock(50.005) == pytest.approx(5500.0)
    assert clock(50.0025) == pytest.approx(3250.0) and clock(50.0075) == pytest.approx(8250.0)
    # Two probes near one call: the nearer takes it, the other is left out.
    two = spans.trace_clock(trace, 50.0, 50.01, thread=111,
                            probes=[(50.00399, 50.00401), (50.00449, 50.00451)])
    assert two.anchors == 3 and two(50.0045) == pytest.approx(5500.0)
    linear = spans.trace_clock(trace, 50.0, 50.01, thread=111,
                               probes=[(50.004, 50.006)])  # 2 ms apart, the call 20 us: a lock wait
    assert linear.anchors == 2 and linear(50.005) == pytest.approx(6000.0)
    monkeypatch.setattr(spans, "PROBE_MATCH_US", 1000.0)
    far = spans.trace_clock(trace, 50.0, 50.01, thread=111,
                            probes=[(50.00099, 50.00101)])  # its nearest call 3.5 ms off
    assert far.anchors == 2 and far(50.005) == pytest.approx(6000.0)
