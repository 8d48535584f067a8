"""The port's MoE FFN and Mamba2 (SSD) blocks against the JAX reference's.

Inputs come from numpy with a seed; parameters are the reference's
(``init_moe`` / ``init_mamba``), carried across as numpy arrays.  Bounds:
the reference's own tests (``tests/test_moe_ssm.py``): 1e-5 for the MoE
FFN, 1e-4 for the SSD and the decode-continues-block check; 1e-6 for
elementwise functions (the frameworks' exp, log1p and tanh differ in the
last fp32 bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import ssm as jax_ssm
from repro_torch.configs import arch_from_reference
from repro_torch.models import layers, moe, ssm


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _tree(params):
    return {k: _t(v) for k, v in jax.tree.map(np.asarray, params).items()}


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe_setup(e=4, k=2, cf=8.0):
    jmoe = JaxMoEConfig(n_experts=e, top_k=k, d_ff=32, capacity_factor=cf)
    jcfg = JaxArchConfig(arch_id="t", family="moe", n_layers=1, d_model=16, n_heads=2,
                         n_kv_heads=2, d_ff=32, vocab=64, moe=jmoe, param_dtype="float32")
    jparams = jax_moe.init_moe(jax.random.key(0), jcfg, jnp.float32)
    cfg = arch_from_reference(jcfg)
    return jmoe, jparams, cfg.moe, _tree(jparams)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_sparse_matches_reference_and_the_dense_oracle():
    """No drops at capacity_factor 8: sparse == JAX sparse == dense."""
    jmoe, jp, m, p = _moe_setup()
    x = _x((3, 16, 16), 1)
    got = moe.moe_ffn_sparse(p, _t(x), m)
    want = jax_moe.moe_ffn_sparse(jp, jnp.asarray(x), jmoe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), moe.moe_ffn_dense(p, _t(x), m).numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(moe.moe_ffn_dense(p, _t(x), m).numpy(),
                               np.asarray(jax_moe.moe_ffn_dense(jp, jnp.asarray(x), jmoe)),
                               rtol=0, atol=1e-5)
    assert moe._dispatch(p, _t(x), m, moe._capacity(m, 16))[2].tolist() == [0, 0, 0]


def test_router_topk_matches_reference():
    jmoe, jp, m, p = _moe_setup(e=8, k=3)
    x2 = _x((64, 16), 3)
    w, idx = moe._router_topk(p, _t(x2), m)
    jw, jidx = jax_moe._router_topk(jp, jnp.asarray(x2), jmoe)
    assert idx.tolist() == np.asarray(jidx).tolist()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("n", [1, 16, 32, 100])
def test_capacity_matches_reference(n):
    jmoe, _, m, _ = _moe_setup(e=40, k=8, cf=1.25)
    assert moe._capacity(m, n) == jax_moe._capacity(jmoe, n)


def test_tight_capacity_keeps_and_slots_the_reference_pairs():
    """capacity_factor 0.3 drops pairs: the kept mask, the slots and the
    drop count exactly as the reference's per-row dispatch, the output at
    1e-5."""
    jmoe, jp, m, p = _moe_setup(cf=0.3)
    x = _x((2, 32, 16), 2)
    cap = moe._capacity(m, 32)
    assert cap == jax_moe._capacity(jmoe, 32)
    _, (slot, _), dropped = moe._dispatch(p, _t(x), m, cap)
    _, experts = jax_moe._router_topk(jp, jnp.asarray(x.reshape(-1, 16)), jmoe)
    experts = np.asarray(experts).reshape(2, -1)
    for b in range(2):
        _, (jslot, jkeep, jtoken, _) = jax_moe._dispatch_row(jp, jnp.asarray(x[b]), jmoe, cap)
        order = np.argsort(experts[b], kind="stable")  # the reference's sorted pair order
        assert (np.asarray(jtoken) == order // m.top_k).all()
        kept = slot[b, order] < m.n_experts * cap
        assert kept.tolist() == np.asarray(jkeep).tolist()
        assert slot[b, order][kept].tolist() == np.asarray(jslot)[np.asarray(jkeep)].tolist()
        assert int(dropped[b]) == int((~np.asarray(jkeep)).sum()) > 0
    got = moe.moe_ffn_sparse(p, _t(x), m)
    want = jax_moe.moe_ffn_sparse(jp, jnp.asarray(x), jmoe)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert float((got - moe.moe_ffn_dense(p, _t(x), m)).abs().max()) > 1e-4


def test_sparse_is_deterministic_and_batch_invariant():
    """Two calls are equal bit for bit, and a row alone equals the same row
    in a batch of three (routing and capacity are per sequence)."""
    _, _, m, p = _moe_setup(cf=0.3)
    x = _t(_x((3, 32, 16), 4))
    a, b = moe.moe_ffn_sparse(p, x, m), moe.moe_ffn_sparse(p, x, m)
    assert torch.equal(a, b)
    for row in range(3):
        assert torch.equal(moe.moe_ffn_sparse(p, x[row : row + 1], m)[0], a[row])
        cap = moe._capacity(m, 32)
        assert torch.equal(moe._dispatch(p, x[row : row + 1], m, cap)[2][0],
                           moe._dispatch(p, x, m, cap)[2][row])


def test_moe_ffn_follows_impl_and_the_loss_waits():
    import dataclasses

    _, _, m, p = _moe_setup(cf=0.3)
    x = _t(_x((1, 32, 16), 5))
    dense = dataclasses.replace(m, impl="dense")
    assert torch.equal(moe.moe_ffn(p, x, dense), moe.moe_ffn_dense(p, x, m))
    assert torch.equal(moe.moe_ffn(p, x, m), moe.moe_ffn_sparse(p, x, m))
    # The load-balancing loss is ported with training: the reference's value.
    jmoe, jp, _, _ = _moe_setup(cf=0.3)
    want = jax_moe.aux_load_balance_loss(jp, jnp.asarray(x.numpy()), jmoe)
    np.testing.assert_allclose(float(moe.aux_load_balance_loss(p, x, m)), float(want), rtol=1e-6)
    with pytest.raises(AttributeError):
        moe.no_such_function


def test_init_moe_keeps_the_router_in_fp32():
    cfg = arch_from_reference(_moe_setup_cfg())
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    assert p["router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
    assert p["w_gate"].shape == (4, 16, 32) and p["w_down"].shape == (4, 32, 16)


def _moe_setup_cfg():
    return JaxArchConfig(arch_id="t", family="moe", n_layers=1, d_model=16, n_heads=2,
                         n_kv_heads=2, d_ff=32, vocab=64,
                         moe=JaxMoEConfig(n_experts=4, top_k=2, d_ff=32))


# ---------------------------------------------------------------------------
# Elementwise: GELU and softplus
# ---------------------------------------------------------------------------
def test_gelu_and_softplus_match_reference():
    x = np.concatenate([_x((200,), 6) * 4, [-40.0, -20.5, 0.0, 20.5, 40.0]]).astype(np.float32)
    np.testing.assert_allclose(layers.gelu(_t(x)).numpy(), np.asarray(jax.nn.gelu(x)), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ssm.softplus(_t(x)).numpy(), np.asarray(jax.nn.softplus(x)),
                               rtol=0, atol=1e-6)


def test_gelu_mlp_matches_reference():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 5, 32)) * 0.5).astype(np.float32)
    p = {"w_up": (rng.normal(size=(32, 48)) / np.sqrt(32)).astype(np.float32),
         "w_down": (rng.normal(size=(48, 32)) / np.sqrt(48)).astype(np.float32)}
    got = layers.mlp({k: _t(v) for k, v in p.items()}, _t(x), "gelu")
    want = jax_layers.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        layers.mlp({k: _t(v) for k, v in p.items()}, _t(x), "geglu")


# ---------------------------------------------------------------------------
# SSD and the Mamba2 block
# ---------------------------------------------------------------------------
def _ssd_inputs(seed=0, L=64, H=2, P=8, N=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(L, H, P)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(rng.normal(size=(L, H)).astype(np.float32) * 0.5))
    A = -np.exp(rng.normal(size=(H,)) * 0.3).astype(np.float32)
    B = (rng.normal(size=(L, N)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(L, N)) * 0.5).astype(np.float32)
    D = np.ones((H,), np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_reference_and_the_recurrence(chunk):
    args = _ssd_inputs()
    got = ssm.ssd_chunked(*map(_t, args), chunk)
    want = jax_ssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    naive = ssm.ssd_naive(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), naive.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(naive.numpy(), np.asarray(jax_ssm.ssd_naive(*map(jnp.asarray, args))),
                               rtol=0, atol=1e-4)


def test_ssd_chunked_batched_equals_each_row():
    rows = [_ssd_inputs(seed) for seed in (1, 2)]
    A, D = _t(rows[0][2]), _t(rows[0][5])
    stack = [torch.stack([_t(r[i]) for r in rows]) for i in (0, 1, 3, 4)]
    got = ssm.ssd_chunked(stack[0], stack[1], A, stack[2], stack[3], D, 16)
    for b, r in enumerate(rows):
        one = ssm.ssd_chunked(_t(r[0]), _t(r[1]), A, _t(r[3]), _t(r[4]), D, 16)
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), rtol=0, atol=1e-6)


def _mamba_setup():
    jcfg = JaxArchConfig(arch_id="t", family="ssm", n_layers=1, d_model=32, n_heads=0,
                         n_kv_heads=0, d_ff=0, vocab=64,
                         ssm=JaxSSMConfig(d_state=16, head_dim=16, chunk=16),
                         param_dtype="float32", compute_dtype="float32")
    jp = jax_ssm.init_mamba(jax.random.key(1), jcfg, jnp.float32)
    return jcfg, jp, arch_from_reference(jcfg), _tree(jp)


def _zero_states(cfg, b):
    s = cfg.ssm
    h = np.zeros((b, s.n_heads(cfg.d_model), s.head_dim, s.d_state), np.float32)
    conv = np.zeros((b, s.d_conv - 1, s.d_inner(cfg.d_model) + 2 * s.d_state), np.float32)
    return h, conv


def test_mamba_block_matches_reference():
    """21 positions: the chunked SSD with the sequence padded to 32."""
    jcfg, jp, cfg, p = _mamba_setup()
    x = _x((2, 21, 32), 8) * 0.5
    got = ssm.mamba_block(p, _t(x), cfg)
    want = jax_ssm.mamba_block(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_mamba_decode_matches_reference_and_continues_the_block():
    """Decode steps from zero state against the reference's steps, and
    against the port's own block over the same positions (the reference's
    test_mamba_decode_continues_block)."""
    jcfg, jp, cfg, p = _mamba_setup()
    x = _x((2, 21, 32), 9) * 0.5
    full = ssm.mamba_block(p, _t(x), cfg)
    h, conv = _zero_states(cfg, 2)
    jh, jconv = jnp.asarray(h), jnp.asarray(conv)
    h, conv = _t(h), _t(conv)
    ys = []
    for t in range(21):
        y, h, conv = ssm.mamba_decode_step(p, _t(x[:, t : t + 1]), h, conv, cfg)
        jy, jh, jconv = jax_ssm.mamba_decode_step(jp, jnp.asarray(x[:, t : t + 1]), jh, jconv, jcfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-4)
        ys.append(y)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), rtol=0, atol=1e-4)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(), rtol=0, atol=1e-4)


def test_rolling_conv_equals_the_block_conv_bit_for_bit():
    """The decode's rolling conv and the block's shifted-slice conv add the
    same products in the same order."""
    _, _, cfg, p = _mamba_setup()
    xbc = _t(_x((2, 9, p["conv_w"].shape[1]), 10))
    block = ssm._causal_conv(xbc, p["conv_w"], p["conv_b"])
    k = p["conv_w"].shape[0]
    state = torch.zeros((2, k - 1, xbc.shape[-1]))
    for t in range(9):
        full = torch.cat([state, xbc[:, t : t + 1]], dim=1)
        step = torch.nn.functional.silu(
            ssm._conv_sum([full[:, i] for i in range(k)], p["conv_w"]) + p["conv_b"])
        assert torch.equal(step, block[:, t])
        state = full[:, 1:]
