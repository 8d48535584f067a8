"""The span recorder (``repro_torch.spans.SPANS``) and the spans
the port records where its time goes: off it records nothing, on its
records link up by parent and request, the ring is bounded and counts what
it drops, and each site's spans agree with the stamps they are taken from.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.balancer import BatchServer, LoadBalancer, PagedDecodePool
from repro_torch.core import GaussianRandomWalk, balanced_mlda
from repro_torch.spans import SPANS, SpanRecorder
from repro_torch.swe.servers import _on_host


@pytest.fixture
def recording():
    """The process's recorder, emptied and on for the test, off after."""
    SPANS.drain()
    SPANS.enable()
    try:
        yield SPANS
    finally:
        SPANS.disable()
        SPANS.drain()


def _batch_balancer(**kw):
    server = BatchServer(lambda xs: np.asarray(xs, dtype=float) * 2.0, name="pool-0",
                         capacity_tags=("level0",), max_batch=4)
    return LoadBalancer([server], batch_window_s=0.05, batch_window_frac=1.0, **kw)


def _submit_burst(lb, n=9):
    reqs = lb.submit_many([np.array([float(i)]) for i in range(n)], tag="level0",
                          batchable=True)
    for r in reqs:
        lb.result(r, timeout=10)
    return reqs


def test_off_records_nothing():
    SPANS.drain()
    assert not SPANS.on
    lb = _batch_balancer()
    try:
        reqs = _submit_burst(lb)
    finally:
        lb.shutdown()
    log = SPANS.drain()
    assert log.spans == [] and log.dropped == 0
    assert all(r.popped_at == 0.0 for r in reqs)  # no stamp taken while off


def test_request_spans_link_up_and_match_the_stamps(recording):
    lb = _batch_balancer()
    try:
        reqs = _submit_burst(lb)
        log = lb.spans()
    finally:
        lb.shutdown()
    by_id = {s.id: s for s in log.spans if s.id}
    top = {s.request: s for s in log.spans if s.name == "balancer.request"}
    assert sorted(top) == sorted(r.seq for r in reqs)
    for r in reqs:
        rs = top[r.seq]
        kids = {s.name: s for s in log.spans if s.parent == rs.id}
        assert by_id[rs.id] is rs and all(k.request == r.seq for k in kids.values())
        assert (rs.start, rs.end, rs.tag) == (r.arrived_at, r.completed_at, "level0")
        q, svc = kids["balancer.queue"], kids["balancer.service"]
        assert q.start == r.arrived_at and svc.end == r.completed_at
        assert svc.tag == "pool-0" and svc.n == rs.n >= 1
        wait = sum(k.end - k.start for n, k in kids.items() if n != "balancer.service")
        # queue + coalescing wait is the paper's idle time, from the same stamps
        assert abs(wait - r.queue_delay) < 1e-9
        assert set(kids) <= {"balancer.queue", "balancer.coalesce", "balancer.service"}
    # a batch of more than one was held by the coalescing window
    assert any(s.name == "balancer.coalesce" for s in log.spans)
    assert any(s.n > 1 for s in top.values())
    names = set(log.threads.values())
    assert "lb-dispatch" in names and any(n.startswith("lb-worker") for n in names)


def test_ring_is_bounded_and_counts_drops_exactly():
    rec = SpanRecorder(capacity=5)
    for i in range(8):
        rec.add("x", float(i), float(i) + 1.0, n=i)
    log = rec.drain()
    assert [s.n for s in log.spans] == [0, 1, 2, 3, 4] and log.dropped == 3
    assert log.spans[0].thread == threading.get_native_id()
    assert log.idents[threading.get_ident()] == threading.get_native_id()
    assert log.threads[threading.get_native_id()] == threading.current_thread().name
    again = rec.drain()
    assert again.spans == [] and again.dropped == 0


def test_concurrent_records_are_kept_or_counted():
    """More threads than cores racing at the ring's edge: every record is
    either kept or counted as dropped, and the ring stays near its bound."""
    rec = SpanRecorder(capacity=20_000)
    n_threads, per = 24, 2_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(per):
                rec.add("x", 0.0, 1.0, n=i)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    log = rec.drain()
    assert len(log.spans) + log.dropped == n_threads * per
    assert rec.capacity <= len(log.spans) <= rec.capacity + n_threads


def test_paged_pool_spans_split_time_to_first_token(recording):
    def step_fn(state, toks, active):
        return state, np.asarray(toks) + 1

    def chunk_fn(state, slot, chunk, start_pos):
        return state, int(chunk[-1]) + 1

    pool = PagedDecodePool(step_fn, chunk_fn, lambda state, slot, row: state, lambda: 0, 2,
                           n_blocks=8, block_size=4, max_blocks_per_slot=4, max_positions=16,
                           prefill_chunk=4, name="paged:toy", capacity_tags=("toy",))
    lb = LoadBalancer([pool])
    try:
        prompts = [np.arange(10).reshape(1, -1), np.arange(3).reshape(1, -1),
                   np.arange(7).reshape(1, -1)]
        reqs = [lb.submit_async((p, 3, None), tag="toy") for p in prompts]
        results = [lb.result(r, timeout=10) for r in reqs]
        log = lb.spans()
    finally:
        lb.shutdown()
    for p, r, res in zip(prompts, reqs, results):
        (admit,) = [s for s in log.spans if s.name == "balancer.admit" and s.request == r.seq]
        (pre,) = [s for s in log.spans if s.name == "pool.prefill" and s.request == r.seq]
        assert (admit.start, admit.end) == (r.arrived_at, r.dispatched_at)
        assert (pre.start, pre.end) == (r.dispatched_at, res.token_times[0])
        assert pre.n == -(-p.size // 4)
        assert abs(r.arrived_at + (admit.end - admit.start) + (pre.end - pre.start)
                   - res.token_times[0]) < 1e-9


def test_level_pool_call_and_its_read_to_the_host(recording):
    call = _on_host(lambda x: x * 2.0, torch.device("cpu"))
    call.tag = "level1"
    out = call(np.ones((3, 2)))
    assert out.shape == (3, 2)
    log = SPANS.drain()
    (c,) = [s for s in log.spans if s.name == "pool.call"]
    (sync,) = [s for s in log.spans if s.name == "pool.sync"]
    assert sync.parent == c.id and (c.tag, c.n) == ("level1", 3) == (sync.tag, sync.n)
    assert c.start <= sync.start <= sync.end == c.end


def test_recorder_imports_nothing_of_the_port():
    """The recorder is a leaf: the layers that record (the balancer, the
    level pools, the ensemble drivers) import it, and it imports none of
    them, so no lower layer comes to depend on the balancer through it."""
    code = ("import sys, repro_torch.spans as s; "
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch') "
            "and m not in ('repro_torch', 'repro_torch.spans')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)})
    assert out.stdout.strip() == "[]"
    from repro_torch import balancer

    assert balancer.SPANS is SPANS and balancer.SpanRecorder is SpanRecorder


def test_ensemble_round_is_host_time_and_waits(recording):
    servers = [BatchServer(lambda xs: np.asarray(xs, float), name=f"l{i}",
                           capacity_tags=(f"level{i}",)) for i in range(2)]
    runner, lb = balanced_mlda(servers, lambda obs: -0.5 * float(np.sum(obs ** 2)),
                               lambda t: 0.0, GaussianRandomWalk(0.5), [2], n_chains=3,
                               as_runner=True)
    try:
        t0 = time.monotonic()
        res = runner.run(np.zeros(2), 6)
        t1 = time.monotonic()
        log = lb.spans()
    finally:
        lb.shutdown()
    (rnd,) = [s for s in log.spans if s.name == "driver.round"]
    assert t0 <= rnd.start <= rnd.end <= t1 and rnd.n == res.chains.shape[0] * 6 == 18
    waits = [s for s in log.spans if s.name == "driver.wait"]
    assert waits and all(w.parent == rnd.id and w.thread == rnd.thread for w in waits)
    assert sum(w.end - w.start for w in waits) <= rnd.end - rnd.start
