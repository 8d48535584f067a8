"""The port's dense LM against the JAX reference's, on the same weights.

The reference's parameters (``lm.init_params``) are carried across with
``params_from_reference``; both models run the reduced config in fp32 on
the same numpy tokens, the reference with ``attn_impl="pallas"`` (its
flash kernel in interpret mode, as its own tests run it) and the port with
``"kernel"`` (the plain version on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro_torch.configs import ARCHS, PORT_ONLY_ARCHS, SHAPES, arch_from_reference, get_arch
from repro_torch.models import build_model, input_specs, params_from_reference
from repro_torch.models import layers, lm

DENSE = ["qwen2-0.5b", "smollm-360m"]
CACHE_LEN = 24


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# Layers: the same arithmetic in fp32, atol 1e-6 (a few fp32 ulps of values
# of size ~1; the frameworks' rsqrt, cos/sin and matmul summation orders
# differ in the last bit).
# ---------------------------------------------------------------------------
def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    got = layers.rmsnorm(_t(x), _t(w), 1e-6)
    want = jax_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_reference(per_row):
    """Interleaved pairs, positions shared (S,) or per row (B, S)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    pos = rng.integers(0, 40, size=(2, 7) if per_row else (7,)).astype(np.int32)
    got = layers.apply_rope(_t(x), _t(pos.astype(np.int64)), 1e4)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("x_shape", [(2, 5, 32), (7, 32)])
def test_mlp_matches_reference(x_shape):
    """SwiGLU over a (B, S, d) batch and over (tokens, d) rows."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=x_shape) * 0.5).astype(np.float32)
    p = {name: (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
         for name, shape in (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    got = layers.mlp({k: _t(v) for k, v in p.items()}, _t(x), "swiglu")
    want = jax_layers.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), "swiglu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Whole model, reduced configs, the reference's weights
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=DENSE)
def model(request):
    jcfg = dataclasses.replace(JAX_ARCHS[request.param].reduced(), attn_impl="pallas")
    jparams = jax_lm.init_params(jax.random.key(0), jcfg)
    cfg = arch_from_reference(jcfg)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape)


def test_forward_matches_reference(model):
    """Logits of every position at atol 1e-4: fp32 through two layers and a
    tied unembedding of logits of size ~0.5, summed in other orders."""
    jcfg, jparams, cfg, params = model
    toks = _tokens(cfg, (2, 16), 3)
    got = lm.forward(params, cfg, {"tokens": _t(toks)})
    want = jax_lm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    assert got.shape == (2, 16, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    last = lm.prefill(params, cfg, {"tokens": _t(toks)})
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:], rtol=0, atol=1e-4)


def test_decode_and_prefill_state_match_reference(model):
    """prefill_state over a prompt, then decode steps, at atol 1e-4 (the
    forward's bound): the reference scans a shared position, the port
    carries one per row."""
    jcfg, jparams, cfg, params = model
    prompt = _tokens(cfg, (2, 6), 4)
    feeds = _tokens(cfg, (2, 3), 5)
    got, st = lm.prefill_state(params, cfg, _t(prompt), CACHE_LEN)
    want, jst = jax_lm.prefill_state(jparams, jcfg, jnp.asarray(prompt, jnp.int32), CACHE_LEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    for t in range(feeds.shape[1]):
        got, st = lm.decode_step(params, cfg, st, _t(feeds[:, t : t + 1]))
        want, jst = jax_lm.decode_step(jparams, jcfg, jst, jnp.asarray(feeds[:, t : t + 1], jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert st.pos.tolist() == [int(jst.pos)] * 2


def test_teacher_forced_decode_matches_own_forward(model):
    """The port's decode reproduces its own forward at atol 2e-3 (the
    reference's own bound for the same check, tests/test_models_smoke.py)."""
    _, _, cfg, params = model
    toks = _t(_tokens(cfg, (2, 12), 6))
    full = lm.forward(params, cfg, {"tokens": toks})
    st = lm.init_decode_state(cfg, 2, 16, "cpu")
    outs = []
    for t in range(12):
        logits, st = lm.decode_step(params, cfg, st, toks[:, t : t + 1])
        outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=0, atol=2e-3)


def test_rows_at_different_positions_decode_independently(model):
    """A pooled state whose rows sit at different positions gives each row
    the logits of its own B = 1 decode (the continuous-batching contract)."""
    _, _, cfg, params = model
    prompts = [_t(_tokens(cfg, (1, n), 7 + n)) for n in (3, 6)]
    singles = [lm.prefill_state(params, cfg, p, CACHE_LEN) for p in prompts]
    pool = lm.pool_decode_state(cfg, 3, CACHE_LEN, "cpu")
    for slot, (_, st) in enumerate(singles):
        pool = lm.slot_insert(pool, st, slot)
    assert pool.pos.tolist() == [3, 6, 0]
    feed = torch.tensor([[5], [9], [0]])
    pooled, pool = lm.decode_step(params, cfg, pool, feed)
    for row, (_, st) in enumerate(singles):
        one, _ = lm.decode_step(params, cfg, st, feed[row : row + 1])
        np.testing.assert_allclose(pooled[row].numpy(), one[0].numpy(), rtol=0, atol=1e-5)
        assert int(pooled[row, -1].argmax()) == int(one[0, -1].argmax())


@pytest.mark.parametrize("impl", ["chunked", "xla"])
def test_attention_impls_agree(model, impl):
    _, _, cfg, params = model
    toks = {"tokens": _t(_tokens(cfg, (1, 20), 8))}
    want = lm.forward(params, cfg, toks)
    got = lm.forward(params, dataclasses.replace(cfg, attn_impl=impl), toks)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Configs, bundle, shapes and weights
# ---------------------------------------------------------------------------
def test_configs_carry_across():
    assert set(JAX_ARCHS) | set(PORT_ONLY_ARCHS) == set(ARCHS)
    assert not set(JAX_ARCHS) & set(PORT_ONLY_ARCHS)
    for name, jcfg in JAX_ARCHS.items():
        assert get_arch(name) is ARCHS[name]
        # What stays refused: serving the encoder-decoder from tokens alone.
        assert (build_model(ARCHS[name]).prefill_state is None) == (jcfg.family == "encdec")
        cfg = arch_from_reference(jcfg)
        assert cfg == dataclasses.replace(ARCHS[name], attn_impl="chunked")
        assert arch_from_reference(dataclasses.replace(jcfg, attn_impl="pallas")).attn_impl == "kernel"
        assert cfg.reduced() == arch_from_reference(jcfg.reduced())
    assert ARCHS["qwen2-0.5b"].attn_impl == "kernel"
    with pytest.raises(KeyError):
        get_arch("no-such-model")
    with pytest.raises(ValueError, match="attn_impl"):
        dataclasses.replace(ARCHS["qwen2-0.5b"], attn_impl="pallas")


def test_bundle_and_input_specs():
    cfg = ARCHS["qwen2-0.5b"].reduced()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), "cpu")
    assert len(params["blocks"]) == cfg.n_layers and "unembed" not in params
    assert set(params["blocks"][0]["attn"]) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
    leaves = [params["embed"], params["ln_f"]] + [
        t for block in params["blocks"] for part in block.values()
        for t in (part.values() if isinstance(part, dict) else [part])
    ]
    jax_params = jax_build_model(JAX_ARCHS["qwen2-0.5b"].reduced()).init(jax.random.key(0))
    assert sum(t.numel() for t in leaves) == sum(int(x.size) for x in jax.tree.leaves(jax_params))
    assert input_specs(cfg, SHAPES["prefill_32k"], batch_override=1) == {
        "tokens": ((1, 32768), torch.int64)
    }
    assert input_specs(cfg, SHAPES["decode_32k"]) == {"tokens": ((128, 1), torch.int64)}
    assert set(input_specs(cfg, SHAPES["train_4k"])) == {"tokens", "labels"}
    toks = torch.zeros((2, 5), dtype=torch.int64)
    st = bundle.decode_init(params, {"tokens": toks}, 8)
    assert st.kv.k.shape == (cfg.n_layers, 2, cfg.n_kv_heads, 8, cfg.hd)
    assert bundle.prefill(params, {"tokens": toks}).shape == (2, 1, cfg.vocab)


def test_bf16_weights_carry_across():
    """The reference's bf16 leaves (ml_dtypes) arrive bit for bit."""
    cfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(), param_dtype="bfloat16")
    w = np.random.default_rng(9).normal(size=(cfg.n_layers, 3, 4)).astype(ml_dtypes.bfloat16)
    tree = {"blocks": {"w": w}, "embed": w[0], "ln_f": w[0, 0]}
    params = params_from_reference(tree, cfg, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert np.array_equal(params["blocks"][1]["w"].float().numpy(), w[1].astype(np.float32))
    with pytest.raises(ValueError, match="unknown parameter groups"):
        params_from_reference({**tree, "adapter": w}, cfg, "cpu")
    vlm = dataclasses.replace(cfg, family="vlm", n_patches=2, d_vision=3)
    projected = params_from_reference({**tree, "projector": {"w1": w[0]}}, vlm, "cpu")
    assert projected["projector"]["w1"].dtype == torch.bfloat16
