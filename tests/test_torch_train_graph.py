"""The train step over donated state (``GraphTrainStep``, the port's
``jax.jit(train_step, donate_argnums=(0, 1))``) on the CPU, where it runs
its function eagerly on the same static buffers that a CUDA graph reads on
the card.

Held bit for bit against the functional ``train_step`` of
``make_train_fns`` (parameters, moments, master copy, step count and the
metrics, under deterministic algorithms: the CPU's embedding backward
accumulates rows in no fixed order otherwise) over dense, MoE and SSM
reduced archs, microbatches and an fp32 master copy; the in-place contract
(the same leaf objects, the step count, metrics that survive the next
call); a restart through disk into a fresh and into a used trainer; the
reference's ``train_step`` through the graph trainer within the
tolerances of ``tests/test_torch_train.py``; the refusal of a batch of
another layout; and remat without RNG bookkeeping.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro_torch.checkpoint as ckpt
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.runtime.train_loop import TrainRuntime as JaxTrainRuntime
from repro.runtime.train_loop import make_train_fns as jax_make_train_fns
from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.data import microbatch, synthetic_lm_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import chunked_attention, layers, params_from_reference
from repro_torch.optim import AdamWConfig
from repro_torch.optim.tree import tree_leaves, tree_unflatten
from repro_torch.runtime.train_loop import GraphTrainStep, TrainRuntime, make_train_fns
from test_torch_train import (
    ADAM_EPS,
    B,
    GRAD_RTOL,
    PARAM_ATOL,
    _assert_leaves_close,
    _batch,
    _jax_batch,
    _np,
    _reference,
    _state_from_reference,
    _torch_batch,
)

SHAPE = ShapeConfig("graph", seq_len=16, global_batch=4, kind="train")
ADAMW = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _clone(tree):
    return tree_unflatten(tree, [t.clone() for t in tree_leaves(tree)])


def _setup(cfg, rt):
    """A graph step over fresh state, the functional step, and a copy of
    the same initial state for it."""
    init_fn, train_step = make_train_fns(cfg, rt)
    params, opt = init_fn(torch.Generator().manual_seed(0), "cpu")
    graph = GraphTrainStep(cfg, rt, params, opt)
    return graph, train_step, _clone((params, opt))


def _batches(cfg, k, n):
    return [microbatch(synthetic_lm_batch(cfg, SHAPE, s, device="cpu"), k) for s in range(n)]


def _bf16_with_master():
    return dataclasses.replace(ARCHS["smollm-360m"].reduced(), param_dtype="bfloat16",
                               compute_dtype="bfloat16")


CASES = {
    "dense": (lambda: ARCHS["smollm-360m"].reduced(), 1, AdamWConfig()),
    "dense-microbatches-2": (lambda: ARCHS["smollm-360m"].reduced(), 2, AdamWConfig()),
    "dense-bf16-fp32-master": (_bf16_with_master, 1, AdamWConfig(master_dtype="float32")),
    "moe": (lambda: ARCHS["granite-moe-3b-a800m"].reduced(), 1, AdamWConfig()),
    "moe-microbatches-2": (lambda: ARCHS["granite-moe-3b-a800m"].reduced(), 2, AdamWConfig()),
    "ssm": (lambda: ARCHS["mamba2-1.3b"].reduced(), 1, AdamWConfig()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_step_equals_functional_step(case, deterministic):
    """Three steps through the graph step against three functional steps
    from the same state on the same batches: every metric each step, and
    params, m, v, master and step after, bit for bit."""
    make_cfg, k, adamw = CASES[case]
    cfg = make_cfg()
    rt = TrainRuntime(microbatches=k, adamw=dataclasses.replace(
        adamw, lr=ADAMW.lr, warmup_steps=ADAMW.warmup_steps, total_steps=ADAMW.total_steps))
    graph, train_step, (params, opt) = _setup(cfg, rt)
    for batch in _batches(cfg, k, 3):
        got = graph(batch)
        params, opt, want = train_step(params, opt, batch)
        assert sorted(got) == sorted(want) == ["grad_norm", "loss", "lr"]
        for key in want:
            assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    mine, ref = (graph.params, graph.opt_state), (params, opt)
    assert (graph.opt_state.master is None) == (adamw.master_dtype is None)
    for a, b in zip(tree_leaves(mine), tree_leaves(ref), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_state_is_written_in_place():
    """After n calls the step count is n, and the step's params and
    optimizer state are the same tensor objects over the same storage as
    before the first call (written, never rebound); the metrics returned
    are copies that the next call leaves alone."""
    cfg = ARCHS["smollm-360m"].reduced()
    rt = TrainRuntime(adamw=ADAMW)
    graph, _, _ = _setup(cfg, rt)
    leaves = tree_leaves((graph.params, graph.opt_state))
    ptrs = [t.data_ptr() for t in leaves]
    before = [t.clone() for t in leaves]
    kept = []
    for n, batch in enumerate(_batches(cfg, 1, 4), start=1):
        kept.append({k: (v, v.clone()) for k, v in graph(batch).items()})
        assert int(graph.opt_state.step) == n
    after = tree_leaves((graph.params, graph.opt_state))
    assert all(a is b for a, b in zip(after, leaves, strict=True))
    assert [t.data_ptr() for t in after] == ptrs
    assert sum(not torch.equal(a, b) for a, b in zip(after, before)) == len(after)
    for metrics in kept:
        for got, copy in metrics.values():
            assert torch.equal(got, copy)
    assert not graph.captured  # no graph on the CPU


@pytest.mark.parametrize("used", [False, True], ids=["fresh", "used"])
def test_restart_through_disk(tmp_path, used, deterministic):
    """3 steps, save, restore into another graph trainer (a fresh one, or
    one that has already taken a step, so its captured buffers must be
    written in place), then 3 more: bit for bit the 6 straight steps."""
    cfg = ARCHS["smollm-360m"].reduced()
    kw = dict(steps=6, seq_len=16, batch=4, device="cpu")
    straight = launch_train.make_trainer(cfg, **kw)
    for s in range(6):
        straight.step(s)
    first = launch_train.make_trainer(cfg, **kw)
    for s in range(3):
        first.step(s)
    path = str(tmp_path / "mid.npz")
    ckpt.save(path, first.state, step=3)
    resumed = launch_train.make_trainer(cfg, **kw)
    if used:
        resumed.step(5)
    leaves = tree_leaves(resumed.state)
    start = resumed.restore(path)
    assert start == 3 and all(a is b for a, b in zip(tree_leaves(resumed.state), leaves))
    for s in range(start, 6):
        resumed.step(s)
    for a, b in zip(tree_leaves(straight.state), tree_leaves(resumed.state), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,k", [("smollm-360m", 1), ("smollm-360m", 2),
                                    ("granite-moe-3b-a800m", 2)])
def test_graph_train_steps_match_reference(name, k):
    """``tests/test_torch_train.py::test_train_steps_match_reference``
    through the graph step: three steps from the reference's initial
    params and AdamW state, against the reference's jitted ``train_step``
    on the same numpy batches, within the same tolerances."""
    jcfg, cfg = _reference(name)
    adamw = dict(lr=1e-3, eps=ADAM_EPS, warmup_steps=2, total_steps=20)
    jinit, jstep = jax_make_train_fns(jcfg, JaxTrainRuntime(microbatches=k,
                                                             adamw=JaxAdamWConfig(**adamw)))
    rt = TrainRuntime(microbatches=k, adamw=AdamWConfig(**adamw))
    jparams, jopt = jinit(jax.random.key(0))
    graph = GraphTrainStep(cfg, rt, params_from_reference(_np(jparams), cfg, "cpu"),
                           _state_from_reference(jopt, cfg))
    jstep = jax.jit(jstep)
    for s in range(3):
        batch = _batch(cfg, seed=10 + s)
        jb = {n: x.reshape(k, B // k, *x.shape[1:]) if k > 1 else x
              for n, x in _jax_batch(batch).items()}
        jparams, jopt, jm = jstep(jparams, jopt, jb)
        m = graph(microbatch(_torch_batch(batch), k))
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, atol=1e-6)
    assert int(graph.opt_state.step) == int(jopt.step) == 3
    want = params_from_reference(_np(jparams), cfg, "cpu")
    for g, w in zip(tree_leaves(graph.params), tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL)
    for tree, jtree in ((graph.opt_state.m, jopt.m), (graph.opt_state.v, jopt.v)):
        _assert_leaves_close(tree, params_from_reference(_np(jtree), cfg, "cpu"), GRAD_RTOL)


def test_launcher_trains_through_the_graph_step():
    """``make_trainer`` (the CLI's trainer) steps through one
    ``GraphTrainStep`` that owns the trainer's state, and the CLI has no
    flag for another route."""
    trainer = launch_train.make_trainer(ARCHS["smollm-360m"].reduced(), steps=2, seq_len=16,
                                        batch=4, device="cpu")
    step = trainer.train_step
    assert isinstance(step, GraphTrainStep)
    assert step.params is trainer.params and step.opt_state is trainer.opt_state
    assert trainer.state[0] is trainer.params
    trainer.step(0)
    assert int(trainer.opt_state.step) == 1
    flags = {a.dest for a in launch_train.build_parser()._actions}
    assert not any("eager" in f or "graph" in f for f in flags)


def _other_layouts(batch):
    tokens, labels = batch["tokens"], batch["labels"]
    return {
        "shorter": ("tokens", {"tokens": tokens[:, :8], "labels": labels}),
        "int32": ("labels", {"tokens": tokens, "labels": labels.to(torch.int32)}),
        "missing": ("labels", {"tokens": tokens}),
        "extra": ("patches", {**batch, "patches": torch.zeros(4, 2, 8)}),
    }


@pytest.mark.parametrize("layout", ["shorter", "int32", "missing", "extra"])
def test_batch_of_another_layout_refused(layout):
    """After the first call fixed the batch's keys, shapes and dtypes, a
    batch that differs is refused with the leaf's name, and the state is
    not touched."""
    cfg = ARCHS["smollm-360m"].reduced()
    graph, _, _ = _setup(cfg, TrainRuntime(adamw=ADAMW))
    batch = _batches(cfg, 1, 1)[0]
    graph(batch)
    before = [t.clone() for t in tree_leaves((graph.params, graph.opt_state))]
    name, other = _other_layouts(batch)[layout]
    with pytest.raises(ValueError, match=f"batch leaf '{name}'"):
        graph(other)
    for a, b in zip(tree_leaves((graph.params, graph.opt_state)), before):
        assert torch.equal(a, b)


def test_remat_keeps_no_rng_state(monkeypatch, deterministic):
    """Remat forced on: both checkpoints (the blocks and the chunked
    attention's key blocks) are called with ``preserve_rng_state=False``,
    and the graph step with remat equals the functional step without it
    bit for bit over two steps."""
    seen = []
    for module in (layers, chunked_attention):
        real = module.checkpoint

        def spy(fn, *args, _real=real, _module=module, **kw):
            seen.append((_module, kw.get("preserve_rng_state", True)))
            return _real(fn, *args, **kw)

        monkeypatch.setattr(module, "checkpoint", spy)
    cfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(), remat=True)
    rt = TrainRuntime(adamw=ADAMW)
    graph, _, (params, opt) = _setup(cfg, rt)
    _, plain_step = make_train_fns(dataclasses.replace(cfg, remat=False), rt)
    for batch in _batches(cfg, 1, 2):
        got = graph(batch)
        params, opt, want = plain_step(params, opt, batch)
        for key in want:
            assert torch.equal(got[key], want[key])
    assert not any(keep for _, keep in seen)
    assert {module for module, _ in seen} == {layers, chunked_attention}
    for a, b in zip(tree_leaves((graph.params, graph.opt_state)), tree_leaves((params, opt))):
        assert torch.equal(a, b)
