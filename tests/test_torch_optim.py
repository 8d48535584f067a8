"""The port's AdamW against the reference's, on the CPU.

Identical params, gradients and state (the reference's ``init`` state
carried across) through three ``update`` steps in both packages, with the
global-norm clip active and inactive, the fp32 master copy on and off, and
bf16 moments; then the warmup-cosine schedule.  Bounds: fp32 leaves within
1e-6 relative of the reference's (the same operations in the same order;
XLA and PyTorch round ``sqrt``, ``pow`` and the norm's sums on their own);
bf16 leaves within one bf16 step (up to 2^-7 of the value: a rounding of
nearly equal fp32 values can land on either neighbour).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import lr_schedule as jax_lr_schedule
from repro.optim.adamw import make_adamw as jax_make_adamw
from repro_torch.optim import AdamWConfig, AdamWState, lr_schedule, make_adamw
from repro_torch.optim.tree import tree_leaves, tree_map

FP32_RTOL = 1e-6
BF16_RTOL = 2.0**-7
SHAPES = {"w": (16, 8), "b": (8,), "blocks": {"wq": (8, 8), "ln": (8,)}}


def _tree(rng, scale, dtype):
    def leaf(shape):
        return (rng.normal(size=shape) * scale).astype(dtype)

    return {"w": leaf(SHAPES["w"]), "b": leaf(SHAPES["b"]),
            "blocks": {k: leaf(v) for k, v in SHAPES["blocks"].items()}}


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, want):
    want = _t(want)
    rtol = BF16_RTOL if torch.bfloat16 in (got.dtype, want.dtype) else FP32_RTOL
    got, want = got.float(), want.float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=rtol * float(want.abs().max()))


CASES = {
    # name: (config changes, param dtype, gradient scale)
    "clip_inactive": ({}, np.float32, 0.01),
    "clip_active": ({}, np.float32, 3.0),
    "master_fp32": ({"master_dtype": "float32"}, ml_dtypes.bfloat16, 3.0),
    "bf16_moments": ({"m_dtype": "bfloat16", "v_dtype": "bfloat16"}, ml_dtypes.bfloat16, 0.01),
    "bf16_moments_master": ({"m_dtype": "bfloat16", "v_dtype": "bfloat16",
                             "master_dtype": "float32"}, ml_dtypes.bfloat16, 3.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_reference(case):
    changes, dtype, gscale = CASES[case]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, **changes)
    jinit, jupdate = jax_make_adamw(JaxAdamWConfig(**kw))
    init, update = make_adamw(AdamWConfig(**kw))
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(jnp.asarray, _tree(rng, 0.1, dtype))
    jstate = jinit(jparams)
    params = tree_map(_t, jax.tree.map(np.asarray, jparams))
    state = AdamWState(step=torch.tensor(int(jstate.step), dtype=torch.int32),
                       m=tree_map(_t, jax.tree.map(np.asarray, jstate.m)),
                       v=tree_map(_t, jax.tree.map(np.asarray, jstate.v)),
                       master=None if jstate.master is None
                       else tree_map(_t, jax.tree.map(np.asarray, jstate.master)))
    fresh = init(params)
    for mine, ref in zip(tree_leaves(fresh), tree_leaves(state)):
        assert mine.dtype == ref.dtype and torch.equal(mine, ref)
    jupdate = jax.jit(jupdate)
    clipped = []
    for _ in range(3):
        grads = _tree(rng, gscale, dtype)
        jparams, jstate, jm = jupdate(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        params, state, m = update(tree_map(_t, grads), state, params)
        _close(m["lr"], jm["lr"])
        _close(m["grad_norm"], jm["grad_norm"])
        clipped.append(float(m["grad_norm"]) > 1.0)
    assert all(clipped) == (gscale > 1)
    assert int(state.step) == int(jstate.step) == 3
    for name, mine, ref in (("params", params, jparams), ("m", state.m, jstate.m),
                            ("v", state.v, jstate.v), ("master", state.master, jstate.master)):
        ref_leaves = jax.tree.leaves(ref)
        assert len(tree_leaves(mine)) == len(ref_leaves), name
        for a, b in zip(tree_leaves(mine), ref_leaves):
            assert a.dtype == _t(b).dtype, name
            _close(a, b)


def test_update_leaves_its_inputs_alone():
    """The update is functional: grads, state and params come out as they
    went in (fp32 leaves too, whose ``.float()`` is the leaf itself)."""
    init, update = make_adamw(AdamWConfig(lr=1e-2, warmup_steps=1))
    rng = np.random.default_rng(1)
    params = tree_map(_t, _tree(rng, 0.1, np.float32))
    grads = tree_map(_t, _tree(rng, 1.0, np.float32))
    state = init(params)
    before = [t.clone() for t in tree_leaves((params, grads, state))]
    new_params, new_state, _ = update(grads, state, params)
    for a, b in zip(before, tree_leaves((params, grads, state))):
        assert torch.equal(a, b)
    assert not any(torch.equal(a, b) for a, b in zip(tree_leaves(new_params),
                                                     tree_leaves(params)))
    assert int(new_state.step) == 1 and int(state.step) == 0


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (5, 30), (0, 1)])
def test_lr_schedule_matches_reference(warmup, total):
    cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
    steps = np.array([0, 1, 2, warmup, warmup + 1, total // 2, total, total + 7], np.float32)
    got = lr_schedule(AdamWConfig(**cfg), torch.from_numpy(steps))
    want = jax_lr_schedule(JaxAdamWConfig(**cfg), jnp.asarray(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP32_RTOL, atol=0)
    assert got.dtype == torch.float32
    assert float(got[-1]) == pytest.approx(0.1 * 3e-4, rel=1e-6)  # the floor
