"""The port's CUDA-graph cache (``GraphBatchCache``, ``StaticGraph``) and the
graph-backed decode (``DecodeGraph``), without a card.

On the CPU no graph exists, but the cache keeps the card's bookkeeping:
power-of-two padding, one entry per ``(*key, B_pad)`` and calling thread,
static input buffers that a call copies into, static outputs that a call
returns clones of.  So these tests hold the contract the card's replays
keep (the reference's ``tests/test_batch_dispatch.py`` for its
``AOTBatchCache``), the batched solver against the JAX reference's, both
planted faults of ``graphs.py`` against the checks of ``chip_smoke.py``,
and the graph-backed decode against the eager decode step.  The tests of
the replays themselves need the card and carry the ``gpu`` marker.
"""
import gc
import importlib.util
import threading
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.swe import TohokuScenario as JaxScenario
from repro.swe import solver as jsolver
from repro_torch.configs import ARCHS
from repro_torch.kernels import build
from repro_torch.models import build_model
from repro_torch.models import lm
from repro_torch.runtime.serve_loop import DecodeGraph, make_decode_pool
from repro_torch.swe import TohokuScenario
from repro_torch.swe import solver as tsolver
from repro_torch.swe.solver import GraphBatchCache

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

THETAS = [[0.0, 0.0], [60.0, -40.0], [-90.0, 15.0], [120.0, 80.0], [-30.0, -150.0]]


@pytest.fixture(scope="module")
def small():
    """The reference test's scenario (24x24, 900 s), its batched solver and
    batched forward, on the CPU."""
    sc = TohokuScenario(nx=24, ny=24, t_end=900.0, device="cpu")
    solver = tsolver.make_solver(sc.cfg, sc.bathymetry(), sc.probe_indices(), batch=True)
    etas = torch.stack([sc.displacement(torch.tensor(t)) for t in THETAS])
    return sc, solver, sc.build_batch_forward(), etas


def _leaves(result):
    series, final = result
    return [series, *final]


@pytest.mark.parametrize("factory", ["solver", "forward"])
def test_pow2_buckets_one_entry_per_padded_size(small, factory):
    """B = 3, 2, 5 take the keys (24, 24, 4), (24, 24, 2), (24, 24, 8)."""
    sc = TohokuScenario(nx=24, ny=24, t_end=300.0, device="cpu")
    if factory == "solver":
        fn = tsolver.make_solver(sc.cfg, sc.bathymetry(), sc.probe_indices(), batch=True)
        args = torch.stack([sc.displacement(torch.tensor(t)) for t in THETAS])
    else:
        fn = sc.build_batch_forward()
        args = torch.tensor(THETAS)
    out = fn(args[:3])
    assert list(fn.executables) == [(24, 24, 4)]
    assert (out[0] if factory == "solver" else out).shape[0] == 3
    fn(args[:2])
    assert sorted(fn.executables) == [(24, 24, 2), (24, 24, 4)]
    out = fn(args)
    assert sorted(fn.executables) == [(24, 24, 2), (24, 24, 4), (24, 24, 8)]
    assert (out[0] if factory == "solver" else out).shape[0] == 5


def test_solver_padded_rows_equal_unpadded_rows(small):
    """B = 3 runs padded with a zero member to 4; its rows equal the eager
    unpadded B = 3 solve's bit for bit, and so do B = 5's (padded to 8)."""
    _, solver, _, etas = small
    for n in (3, 5):
        got, want = _leaves(solver(etas[:n])), _leaves(solver.eager(etas[:n]))
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.shape[0] == n
            assert torch.equal(g, w)


def test_forward_padded_rows_equal_unpadded_rows(small):
    """The forward pads by repeating member 0: B = 3 and 5 rows equal the
    eager unpadded forward's bit for bit."""
    _, _, forward, _ = small
    thetas = torch.tensor(THETAS)
    for n in (3, 5):
        assert torch.equal(forward(thetas[:n]), forward.eager(thetas[:n]))


@pytest.mark.parametrize("pad", ["zeros", "repeat"])
def test_cache_pads_as_asked(pad):
    """What the stacked function sees in the padding rows, for each mode,
    and that the first n rows of the padded result are the unpadded ones."""
    seen = []

    def stacked(x):
        seen.append(x.clone())
        return x * 2.0 + 1.0

    cache = GraphBatchCache(stacked, key=("toy",), pad=pad, name="toy")
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 1.0
    out, n = cache(x)
    assert n == 3 and out.shape == (4, 4)
    assert torch.equal(out[:n], stacked(x))
    fill = torch.zeros(4) if pad == "zeros" else x[0]
    assert torch.equal(seen[0][3], fill)
    assert list(cache.executables) == [("toy", 4)]


def test_unknown_pad_mode_raises():
    with pytest.raises(ValueError, match="unknown pad mode"):
        GraphBatchCache(lambda x: x, key=(1,), pad="edge", name="toy")


def test_batched_solver_matches_reference(small):
    """The cached batched solve against the JAX batched solver on numpy
    inputs from a seed: 1e-5 relative, the reference kernel test's bound."""
    rng = np.random.default_rng(11)
    thetas = rng.uniform(-200.0, 200.0, size=(3, 2)).astype(np.float32)
    js = JaxScenario(nx=24, ny=24, t_end=900.0)
    b = np.array(js.bathymetry(), np.float32)
    etas = np.stack([np.asarray(js.displacement(jnp.asarray(t))) for t in thetas])
    jsolve = jsolver.make_solver(js.cfg, jnp.asarray(b), js.probe_indices(), batch=True)
    want_series, want_final = jsolve(jnp.asarray(etas))
    cfg = tsolver.SWEConfig(nx=24, ny=24, dx=js.cfg.dx, dy=js.cfg.dy, t_end=js.cfg.t_end)
    tsolve = tsolver.make_solver(cfg, torch.from_numpy(b), js.probe_indices(), batch=True)
    got_series, got_final = tsolve(torch.from_numpy(etas))
    assert tsolve.n_steps == jsolve.n_steps
    for want, got in zip([want_series, *want_final], [got_series, *got_final]):
        want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() / max(np.abs(want).max(), 1.0) < 1e-5


def test_results_do_not_alias_and_inputs_stay(small):
    """A result is unchanged by the next call, and the caller's tensor is
    never written: ``chip_smoke.graph_checks`` on the CPU."""
    sc = TohokuScenario(nx=24, ny=24, t_end=300.0, device="cpu")
    for label, measure, err, limit in chip_smoke.graph_checks(torch, sc):
        assert measure == "unequal values" and err < limit, label


def test_two_successive_calls_return_separate_results(small):
    _, _, forward, _ = small
    thetas = torch.tensor(THETAS)
    first = forward(thetas[:2])
    kept = first.clone()
    second = forward(thetas[2:4])
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)
    assert first.data_ptr() != second.data_ptr()


def test_two_threads_get_separate_entries(small):
    """Two callers in two threads hold two graphs of one key: no static
    buffer is shared between them."""
    sc = TohokuScenario(nx=24, ny=24, t_end=300.0, device="cpu")
    forward = sc.build_batch_forward()
    thetas = torch.tensor(THETAS)
    results, errors = {}, []
    barrier = threading.Barrier(2, timeout=60)

    def call(i):
        try:
            barrier.wait()
            results[i] = forward(thetas[i : i + 3])
        except BaseException as e:  # reported below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    per_thread = forward.executables[(24, 24, 4)]
    assert len(per_thread) == 2
    a, b = per_thread.values()
    assert a is not b and a.inputs[0].data_ptr() != b.inputs[0].data_ptr()
    for i in range(2):
        assert torch.equal(results[i], forward.eager(thetas[i : i + 3]))


def _planted(name):
    """``graphs.py`` with planted fault ``name`` applied, as a module."""
    source, old, new = chip_smoke.PLANTED_FAULTS[name]
    path = chip_smoke.fault_source(source)
    module = types.ModuleType(f"planted_{name}")
    module.__file__ = str(path)
    exec(compile(path.read_text().replace(old, new), str(path), "exec"), module.__dict__)
    return module


@pytest.mark.parametrize("name", ["graph_input_copy_dropped", "graph_outputs_not_cloned"])
def test_graph_checks_reject_the_planted_faults(name, monkeypatch):
    """The checks that chip_smoke runs on each planted fault of graphs.py
    reject it on the CPU too, where the cache keeps the same buffers."""
    monkeypatch.setattr(tsolver, "StaticGraph", _planted(name).StaticGraph)
    sc = TohokuScenario(nx=24, ny=24, t_end=300.0, device="cpu")
    checks = chip_smoke.graph_checks(torch, sc)
    assert [c for c in checks if not c[2] < c[3]]


def test_collector_stays_paused_while_any_capture_runs():
    """Captures hold Python's cyclic collector off (a collection could
    destroy another graph, which invalidates a capture): overlapping
    captures of two threads keep it off until the last ends, and a
    collector the program had turned off stays off."""
    from repro_torch.graphs import _CollectorPause

    was = gc.isenabled()
    pause = _CollectorPause()
    started, release = threading.Barrier(2), threading.Event()

    def capture():
        with pause:
            started.wait(timeout=10)
            release.wait(timeout=10)

    try:
        gc.enable()
        other = threading.Thread(target=capture)
        other.start()
        with pause:
            started.wait(timeout=10)
            release.set()
            other.join(timeout=10)
            assert not other.is_alive()
            assert not gc.isenabled()  # the other capture ended, this one runs
        assert gc.isenabled()
        gc.disable()
        with pause:
            pass
        assert not gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()


def test_counters_tally_captured_launches_and_count_replays():
    """A launch inside ``build.recording()`` goes to the capture's tally, not
    to the count; a replay adds its tally as replayed launches."""
    c = build.LaunchCounter("toy")
    c.add()
    with build.recording() as tally:
        c.add()
        c.add(2)
    assert c.value == 1 and tally == {"toy": 3}
    c.add(3, replayed=True)
    assert (c.value, c.replayed) == (4, 3)
    c.reset()
    assert (c.value, c.replayed) == (0, 0)


def test_launches_leave_out_graph_replays_and_tallies():
    """A tally is counted, captured and replayed like a launch count, but
    ``launches()`` reports only kernel launches: neither tallies nor graph
    replays."""
    names = ("toy kernel", "graph_replays toy", "toy tally")
    try:
        build.counter(names[0]).add()
        build.counter(names[1]).add()
        with build.recording() as tally:
            build.tally(names[2]).add(5)
        assert tally == {names[2]: 5} and build.counter(names[2]).value == 0
        build.counter(names[2]).add(5, replayed=True)
        got = build.launches()
        assert got[names[0]] == 1 and names[1] not in got and names[2] not in got
        assert build.counter(names[2]).value == 5 and names[2] in build.TALLIES
    finally:
        for n in names:
            build.COUNTERS.pop(n, None)
        build.TALLIES.discard(names[2])


# ---------------------------------------------------------------------------
# The graph-backed decode, on the CPU
# ---------------------------------------------------------------------------
CACHE_LEN = 24


@pytest.fixture(scope="module")
def model():
    cfg = ARCHS["qwen2-0.5b"].reduced()
    bundle = build_model(cfg)
    return cfg, bundle, bundle.init(torch.Generator().manual_seed(3), "cpu")


def test_decode_graph_prefill_equals_prefill_state(model):
    """A prompt through the B = 1 decode graph equals the eager
    ``prefill_state`` bit for bit (logits and state), also for a second
    prompt after the graph's state was reset, and the snapshot survives
    the next request."""
    cfg, bundle, params = model
    graph = DecodeGraph(bundle, params, 1, CACHE_LEN, name="test B=1")
    rng = np.random.default_rng(5)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, s))) for s in (6, 3)]
    snaps = []
    for prompt in prompts:
        want_logits, want = lm.prefill_state(params, cfg, prompt, CACHE_LEN)
        ids, logits = graph.prefill(prompt)
        assert torch.equal(logits, want_logits)
        assert int(ids[0]) == int(want_logits[0, -1].argmax())
        snap = graph.snapshot()
        for got, w in zip((*snap.kv, snap.pos), (*want.kv, want.pos)):
            assert torch.equal(got, w)
        snaps.append((snap, want))
    snap, want = snaps[0]  # the first snapshot, after the second request
    assert torch.equal(snap.kv.k, want.kv.k) and torch.equal(snap.pos, want.pos)


def test_decode_pool_steps_equal_eager_decode(model):
    """The pool's graph-backed step against the eager batched decode step
    on the same inserted states: ids equal, and the pool state is the
    graph's static state, advanced in place."""
    cfg, bundle, params = model
    pool = make_decode_pool(bundle, params, n_slots=3, cache_len=CACHE_LEN, name="p", tag="t")
    state = pool.init_state_fn()
    eager = lm.pool_decode_state(cfg, 3, CACHE_LEN, "cpu")
    rng = np.random.default_rng(6)
    for slot in range(3):
        _, seq = lm.prefill_state(
            params, cfg, torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, 2 + slot))),
            CACHE_LEN,
        )
        state = pool.insert_fn(state, slot, seq)
        eager = lm.slot_insert(eager, seq, slot)
    tokens = np.array([3, 5, 7])
    for _ in range(3):
        new_state, ids = pool.step_fn(state, tokens)
        logits, eager = lm.decode_step(params, cfg, eager, torch.as_tensor(tokens)[:, None])
        assert new_state is state
        assert np.array_equal(ids, logits[:, -1].argmax(-1).numpy())
        assert torch.equal(state.pos, eager.pos) and torch.equal(state.kv.k, eager.kv.k)
        tokens = ids
    with pytest.raises(ValueError, match="captured over"):
        pool.step_fn(lm.pool_decode_state(cfg, 3, CACHE_LEN, "cpu"), tokens)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 8])
def test_replay_equals_eager_on_card(card, n):
    """Series, final state and observables of a replay equal the eager
    loop's bit for bit; the first call records the solve's launches."""
    sc = TohokuScenario(nx=32, ny=32, t_end=1800.0, device="cuda")
    solver = tsolver.make_solver(sc.cfg, sc.bathymetry(), sc.probe_indices(), batch=True)
    forward = sc.build_batch_forward()
    thetas = torch.tensor(THETAS * 2, device=card)[:n]
    etas = torch.stack([sc.displacement(t) for t in thetas])
    for got, want in zip(_leaves(solver(etas)), _leaves(solver.eager(etas))):
        assert torch.equal(got, want)
    assert torch.equal(forward(thetas), forward.eager(thetas))
    (graph,) = solver.executables[(32, 32, tsolver.pow2_batch(n))].values()
    assert graph.launches == {"swe_fused_step": solver.n_steps}


@pytest.mark.gpu
def test_decode_pool_step_on_card(card):
    """One pool step through the graph equals the eager step bit for bit."""
    cfg = ARCHS["qwen2-0.5b"].reduced()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(3), "cuda")
    graph = DecodeGraph(bundle, params, 4, CACHE_LEN, name="test pool")
    eager = lm.pool_decode_state(cfg, 4, CACHE_LEN, "cuda")
    _, seq = lm.prefill_state(params, cfg, torch.tensor([[1, 2, 3]], device=card), CACHE_LEN)
    for slot in range(4):
        lm.slot_insert(graph.state, seq, slot)
        eager = lm.slot_insert(eager, seq, slot)
    tokens = torch.tensor([[4], [5], [6], [7]], device=card)
    ids, logits = graph(tokens)
    want, _ = lm.decode_step(params, cfg, eager, tokens)
    assert torch.equal(logits, want)
    assert torch.equal(ids, want[:, -1].argmax(-1))
