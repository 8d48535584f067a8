"""The port's MoE, SSM and hybrid LM families, and the dense nemotron with
its squared-ReLU MLP, against the JAX reference's, on the same weights.

Reduced granite-moe-3b-a800m, mixtral-8x22b, mamba2-1.3b, zamba2-1.2b and
nemotron-4-340b in fp32: the
reference's parameters (``lm.init_params``) carried across with
``params_from_reference``, the same numpy tokens through both, the
reference with ``attn_impl="pallas"`` (its flash kernel in interpret mode,
as its own tests run it) and the port with ``"kernel"`` (the plain version
on the CPU).  Logits at atol 1e-4, the dense models' bound (PERF.md);
teacher-forced decode against the port's own forward at 2e-3, the
reference's bound for the same check (``tests/test_models_smoke.py``),
also through mixtral's rolling cache with a window shorter than the
prompt.  The fp32-copy repairs of the decode scores and the head are held
to the formulas they replaced.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import abstract_params
from repro.models import lm as jax_lm
from repro_torch.configs import ARCHS, PORT_ONLY_ARCHS, arch_from_reference, get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model, lm, paged_state_from_reference, params_from_reference

FAMILIES = ["granite-moe-3b-a800m", "mamba2-1.3b", "zamba2-1.2b", "mixtral-8x22b",
            "nemotron-4-340b"]
ATOL = 1e-4
CACHE_LEN = 24
# The reference's own bounds for the full configs (tests/test_models_smoke.py).
PARAM_BOUNDS = {"granite-moe-3b-a800m": (2.5e9, 4.0e9), "mamba2-1.3b": (1.0e9, 1.7e9),
                "zamba2-1.2b": (1.0e9, 1.6e9), "phi4-mini-3.8b": (3.0e9, 4.8e9),
                "mixtral-8x22b": (130e9, 150e9), "nemotron-4-340b": (300e9, 380e9)}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape)


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    jcfg = dataclasses.replace(JAX_ARCHS[request.param].reduced(), attn_impl="pallas")
    jparams = jax_lm.init_params(jax.random.key(0), jcfg)
    cfg = arch_from_reference(jcfg)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def test_forward_and_prefill_match_reference(model):
    jcfg, jparams, cfg, params = model
    toks = _tokens(cfg, (2, 16), 3)
    got = lm.forward(params, cfg, {"tokens": _t(toks)})
    want = np.asarray(jax_lm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)}))
    assert got.shape == (2, 16, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    last = lm.prefill(params, cfg, {"tokens": _t(toks)})
    np.testing.assert_allclose(last.numpy(), want[:, -1:], rtol=0, atol=ATOL)
    jlast = jax_lm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0, atol=ATOL)


def test_prefill_state_and_decode_match_reference(model):
    """prefill_state over a prompt, then decode steps: logits, and the
    recurrent state of the SSM families, against the reference's."""
    jcfg, jparams, cfg, params = model
    prompt = _tokens(cfg, (2, 6), 4)
    feeds = _tokens(cfg, (2, 3), 5)
    got, st = lm.prefill_state(params, cfg, _t(prompt), CACHE_LEN)
    want, jst = jax_lm.prefill_state(jparams, jcfg, jnp.asarray(prompt, jnp.int32), CACHE_LEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for t in range(feeds.shape[1]):
        got, st = lm.decode_step(params, cfg, st, _t(feeds[:, t : t + 1]))
        want, jst = jax_lm.decode_step(jparams, jcfg, jst,
                                       jnp.asarray(feeds[:, t : t + 1], jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert st.pos.tolist() == [int(jst.pos)] * 2
    if cfg.ssm is not None:
        assert st.ssm_h.dtype == torch.float32 and st.ssm_conv.dtype == torch.float32
        np.testing.assert_allclose(st.ssm_h.numpy(), np.asarray(jst.ssm_h), rtol=0, atol=ATOL)
        np.testing.assert_allclose(st.ssm_conv.numpy(), np.asarray(jst.ssm_conv), rtol=0,
                                   atol=ATOL)
    if cfg.family == "ssm":
        assert st.kv is None and jst.kv is None
    else:
        assert st.kv.k.shape == np.asarray(jst.kv.k).shape[:1] + (2,) + st.kv.k.shape[2:]


def test_teacher_forced_decode_matches_own_forward(model):
    """Decode reproduces the forward at atol 2e-3; the MoE forward at
    capacity_factor 8 (a decode step never drops, a short forward may)."""
    _, _, cfg, params = model
    fwd_cfg = cfg
    if cfg.moe is not None:
        fwd_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    toks = _t(_tokens(cfg, (2, 12), 6))
    full = lm.forward(params, fwd_cfg, {"tokens": toks})
    st = lm.init_decode_state(cfg, 2, 16, "cpu")
    outs = []
    for t in range(12):
        logits, st = lm.decode_step(params, cfg, st, toks[:, t : t + 1])
        outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=0, atol=2e-3)


def test_rows_at_different_positions_decode_independently(model):
    """A pooled state whose rows sit at different positions gives each row
    the logits of its own B = 1 decode (the continuous-batching contract),
    recurrent state included; evicting a row empties it alone."""
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
    if cfg.ssm is not None:
        kept = pool.ssm_h[:, 1].clone()
        pool = lm.slot_evict(pool, cfg, CACHE_LEN, 0)
        assert not pool.ssm_h[:, 0].any() and not pool.ssm_conv[:, 0].any()
        assert torch.equal(pool.ssm_h[:, 1], kept) and pool.pos.tolist() == [0, 7, 1]


# ---------------------------------------------------------------------------
# The SSM family's paged functions against the reference's
# ---------------------------------------------------------------------------
N_SLOTS = 3


@pytest.fixture(scope="module")
def mamba():
    jcfg = JAX_ARCHS["mamba2-1.3b"].reduced()
    jparams = jax_lm.init_params(jax.random.key(1), jcfg)
    cfg = arch_from_reference(jcfg)
    return jcfg, jparams, cfg, params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _assert_ssm_states(st, jst):
    h = np.asarray(jst.ssm_h)[:, :, 0].swapaxes(0, 1)  # (n_slots, L, 1, ...) -> (L, n_slots, ...)
    conv = np.asarray(jst.ssm_conv)[:, :, 0].swapaxes(0, 1)
    np.testing.assert_allclose(st.ssm_h.numpy(), h, rtol=0, atol=ATOL)
    np.testing.assert_allclose(st.ssm_conv.numpy(), conv, rtol=0, atol=ATOL)
    assert st.pos.tolist() == np.asarray(jst.pos).tolist()
    assert st.kv is None and st.tables is None


def test_ssm_paged_functions_match_reference(mamba):
    """From one carried-across state: chunks into two slots, steps with a
    slot inactive (its recurrent state kept), a slot reset, all against the
    reference's functions; ids exactly."""
    jcfg, jparams, cfg, params = mamba
    jst = jax_lm.init_paged_state(jcfg, N_SLOTS, 1, 4, 4, 16)
    st = paged_state_from_reference(jax.tree.map(np.asarray, jst), cfg, "cpu")
    _assert_ssm_states(st, jst)
    assert st.ssm_h.shape[:2] == (cfg.n_layers, N_SLOTS)
    feeds = {}
    for slot, n in ((0, 7), (1, 5)):
        prompt = _tokens(cfg, n, 10 + slot)
        for start in range(0, n, 3):
            chunk = prompt[start : start + 3]
            jst, jtok = jax_lm.paged_prefill_chunk(jparams, jcfg, jst, jnp.int32(slot),
                                                   jnp.asarray(chunk, jnp.int32),
                                                   jnp.int32(start), 16)
            st, ids, logits = lm.paged_prefill_chunk(params, cfg, st, torch.tensor(slot),
                                                     _t(chunk), torch.tensor(start), 16)
            _assert_ssm_states(st, jst)
            assert ids.tolist() == [int(jtok)] and logits.shape == (1, 1, cfg.vocab)
        want, _ = jax_lm.prefill_state(jparams, jcfg, jnp.asarray(prompt[None], jnp.int32), 16)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0, atol=ATOL)
        feeds[slot] = int(jtok)
    for active in ([True, True, False], [True, False, False], [False, True, True]):
        tokens = np.array([feeds[0], feeds[1], 7])
        jst, jtoks = jax_lm.paged_decode_step(jparams, jcfg, jst, jnp.asarray(tokens, jnp.int32),
                                              jnp.asarray(active), 16)
        st, ids, logits = lm.paged_decode_step(params, cfg, st, _t(tokens), torch.tensor(active),
                                               16)
        _assert_ssm_states(st, jst)
        assert ids.tolist() == np.asarray(jtoks).tolist()
        feeds = {s: int(ids[s]) if active[s] else feeds[s] for s in (0, 1)}
    jst = jax_lm.paged_reset_slot(jst, jnp.int32(1), jnp.zeros((4,), jnp.int32))
    st = lm.paged_reset_slot(st, 1, np.zeros(4, np.int32))
    _assert_ssm_states(st, jst)
    assert not st.ssm_h[:, 1].any() and st.ssm_h[:, 0].any()


def test_paged_support_follows_the_family():
    for name in ("mamba2-1.3b", "granite-moe-3b-a800m", "granite-4.0-h-small"):
        lm.check_paged_support(get_arch(name).reduced(), CACHE_LEN)
    hybrid = get_arch("zamba2-1.2b").reduced()
    with pytest.raises(ValueError, match="hybrid/encdec caches are not block-structured"):
        lm.check_paged_support(hybrid, CACHE_LEN)
    # The SSM family has no window to wrap.
    lm.check_paged_support(dataclasses.replace(get_arch("mamba2-1.3b").reduced(),
                                               sliding_window=4), CACHE_LEN)
    st = lm.init_paged_state(get_arch("mamba2-1.3b").reduced(), 2, 1, 4, 4, 16, "cpu")
    assert st.kv is None and st.tables is None and st.ssm_h.shape[1] == 2


# ---------------------------------------------------------------------------
# Structure: the hybrid's tied block, leaf dtypes, parameter counts
# ---------------------------------------------------------------------------
def test_hybrid_shared_block_is_tied(model):
    """One ``shared`` set of tensors, applied after every
    ``shared_attn_every``-th block with a KV cache an invocation; changing
    it changes every invocation's output."""
    jcfg, jparams, cfg, params = model
    if cfg.family != "hybrid":
        assert "shared" not in params
        return
    assert len(params["blocks"]) == cfg.n_layers and set(params["shared"]) == {
        "ln1", "attn", "ln2", "mlp"}
    invocations = [lm._shared_invocation(cfg, layer) for layer in range(cfg.n_layers)]
    assert invocations == [None, 0, None, 1]
    full = get_arch("zamba2-1.2b")
    assert [lm._shared_invocation(full, i) for i in range(full.n_layers)
            if lm._shared_invocation(full, i) is not None] == list(range(6))
    st = lm.init_decode_state(cfg, 1, CACHE_LEN, "cpu")
    assert st.kv.k.shape[0] == cfg.n_layers // cfg.shared_attn_every == 2
    toks = {"tokens": _t(_tokens(cfg, (1, 8), 11))}
    base = lm.forward(params, cfg, toks)
    shared = {**params["shared"], "ln2": params["shared"]["ln2"] * 1.5}
    moved = lm.forward({**params, "shared": shared}, cfg, toks)
    assert float((moved - base).abs().max()) > 1e-3
    # The reference's grouped blocks, layer by layer, in the port's list.
    w = np.asarray(jparams["blocks"]["mamba"]["out_proj"])
    assert np.array_equal(params["blocks"][3]["mamba"]["out_proj"].numpy(), w[1, 1])


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_trees_keep_their_fp32_leaves(name):
    """A bf16 model's router and SSM ``dt_bias``, ``A_log``, ``D`` are fp32
    in the reference; they arrive fp32, every other leaf bf16 bit for bit."""
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_lm.init_params(jax.random.key(2), jcfg))
    params = params_from_reference(tree, arch_from_reference(jcfg), "cpu")
    block = params["blocks"][0]
    fp32 = {"moe": {"router"}, "mamba": {"dt_bias", "A_log", "D"}}
    for group, names in fp32.items():
        if group in block:
            for leaf, t in block[group].items():
                assert t.dtype == (torch.float32 if leaf in names else torch.bfloat16), leaf
    assert params["embed"].dtype == torch.bfloat16
    src = tree["embed"]
    assert src.dtype == ml_dtypes.bfloat16
    assert np.array_equal(params["embed"].float().numpy(), src.astype(np.float32))
    # The port's own bf16 init makes the same choice.
    own = build_model(arch_from_reference(jcfg)).init(torch.Generator().manual_seed(0), "cpu")
    for group, names in fp32.items():
        for leaf in names & set(own["blocks"][0].get(group, {})):
            assert own["blocks"][0][group][leaf].dtype == torch.float32


@pytest.mark.parametrize("name", [*FAMILIES, "phi4-mini-3.8b"])
def test_full_parameter_counts(name):
    """The full configs on the meta device: the reference's count exactly,
    within the reference's bounds; mamba2 has no attention heads."""
    cfg = get_arch(name)
    params = build_model(cfg).init(torch.Generator(), "meta")
    n = lm.param_count(params)
    lo, hi = PARAM_BOUNDS[name]
    assert lo <= n <= hi, f"{name}: {n / 1e9:.2f}B"
    assert n == sum(int(x.size) for x in jax.tree.leaves(abstract_params(JAX_ARCHS[name])))
    assert params["embed"].device.type == "meta"
    if name == "mamba2-1.3b":
        assert cfg.n_heads == 0 and "attn" not in params["blocks"][0]


def test_families_registered_and_the_rest_refused():
    """Every reference architecture is registered, beside the port's own;
    what stays refused is serving the encoder-decoder (no token-only
    prefill, the reference's message), its paged and zamba2's paged mode,
    the sharded train step (item 10; the training losses are ported), and
    families or MLPs that no config has."""
    assert set(ARCHS) == set(JAX_ARCHS) | set(PORT_ONLY_ARCHS)
    assert not set(JAX_ARCHS) & set(PORT_ONLY_ARCHS)
    for family in ("encdec", "vlm"):
        ArchConfig(arch_id="m", family=family, n_layers=1, d_model=8, n_heads=1,
                   n_kv_heads=1, d_ff=8, vocab=8)
    with pytest.raises(ValueError, match="family 'retnet'"):
        ArchConfig(arch_id="m", family="retnet", n_layers=1, d_model=8, n_heads=1,
                   n_kv_heads=1, d_ff=8, vocab=8)
    with pytest.raises(ValueError, match="mlp 'geglu'"):
        dataclasses.replace(ARCHS["phi4-mini-3.8b"], mlp="geglu")
    assert dataclasses.replace(ARCHS["phi4-mini-3.8b"], mlp="sqrelu").mlp == "sqrelu"
    for name in ("whisper-large-v3", "llava-next-mistral-7b", "nemotron-4-340b"):
        assert arch_from_reference(JAX_ARCHS[name]) == dataclasses.replace(
            ARCHS[name], attn_impl="chunked")
    for mode in ("continuous", "generation", "speculative"):
        with pytest.raises(ValueError, match="family 'encdec' has no prefill_state"):
            serve_main(["--arch", "whisper-large-v3", "--device", "cpu", "--mode", mode])
    for name in ("whisper-large-v3", "zamba2-1.2b"):
        with pytest.raises(ValueError, match="hybrid/encdec caches are not block-structured"):
            serve_main(["--arch", name, "--device", "cpu", "--mode", "paged"])
    from repro_torch.models import encdec
    from repro_torch.runtime import train_loop

    # Training is ported (item 9): the losses are functions; so is the
    # sharded train step (item 10), whose layout refuses a mesh without a
    # "model" axis as the reference's does.
    from repro_torch.configs import SHAPES
    from repro_torch.runtime import sharding

    assert callable(lm.lm_loss) and callable(encdec.lm_loss)
    assert callable(train_loop.shard_train_step)
    no_model_axis = type("M", (), {"shape": {"data": 8}, "axis_names": ("data",)})()
    with pytest.raises(KeyError):
        sharding.choose_policy(ARCHS["qwen2-0.5b"], SHAPES["train_4k"], no_model_axis)
    reduced = ARCHS["zamba2-1.2b"].reduced()
    assert (reduced.n_layers, reduced.shared_attn_every, reduced.ssm.d_state,
            reduced.ssm.head_dim, reduced.ssm.chunk) == (4, 2, 16, 16, 16)
    moe = ARCHS["granite-moe-3b-a800m"].reduced().moe
    assert (moe.n_experts, moe.top_k, moe.d_ff) == (4, 2, 64)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_cli_takes_the_family(name, capsys):
    m = serve_main(["--arch", name, "--device", "cpu", "--requests", "3", "--slots", "2",
                    "--cache-len", "80"])
    assert m["n_requests"] == 3 and "tok/s" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# nemotron's squared ReLU, mixtral's rolling cache
# ---------------------------------------------------------------------------
def test_sqrelu_mlp_matches_reference():
    from repro.models import layers as jax_layers
    from repro_torch.models import layers

    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 5, 32)) * 0.5).astype(np.float32)
    p = {"w_up": (rng.normal(size=(32, 48)) / np.sqrt(32)).astype(np.float32),
         "w_down": (rng.normal(size=(48, 32)) / np.sqrt(48)).astype(np.float32)}
    got = layers.mlp({k: _t(v) for k, v in p.items()}, _t(x), "sqrelu")
    want = jax_layers.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), "sqrelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    own = layers.init_mlp(torch.Generator().manual_seed(0), 32, 48, "sqrelu", torch.float32, "cpu")
    assert set(own) == {"w_up", "w_down"}


def _windowed(cfg):
    """Mixtral with a window of 8 and capacity_factor 8 (the reference's own
    rolling-cache test: a decode step never drops, a short forward may)."""
    return dataclasses.replace(cfg, sliding_window=8,
                               moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def test_rolling_cache_decode_matches_forward_and_reference():
    """20 tokens through a cache of 8 slots (the window) against the port's
    own forward (2e-3) and the reference's decode (atol 1e-4)."""
    jcfg = _windowed(dataclasses.replace(JAX_ARCHS["mixtral-8x22b"].reduced(),
                                         attn_impl="pallas"))
    jparams = jax_lm.init_params(jax.random.key(3), jcfg)
    cfg = arch_from_reference(jcfg)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = _tokens(cfg, (1, 20), 4)
    full = lm.forward(params, cfg, {"tokens": _t(toks)})
    st = lm.init_decode_state(cfg, 1, 64, "cpu")
    jst = jax_lm.init_decode_state(jcfg, 1, 64)
    assert st.kv.k.shape[3] == 8
    outs = []
    for t in range(20):
        logits, st = lm.decode_step(params, cfg, st, _t(toks[:, t : t + 1]))
        want, jst = jax_lm.decode_step(jparams, jcfg, jst, jnp.asarray(toks[:, t : t + 1],
                                                                       jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0, atol=ATOL)
        outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=0, atol=2e-3)
    assert sorted(st.kv.pos_buf[0].tolist()) == list(range(12, 20))


def test_windowed_paged_mode_is_refused_below_the_cache():
    """A window shorter than the cache makes the slab cache a ring: paged is
    refused with the reference's message, the speculative server serves
    plain greedy; at the full config's window the paged pool is built."""
    from repro_torch.runtime.serve_loop import ServingEngine, speculative_supported

    cfg = _windowed(arch_from_reference(JAX_ARCHS["mixtral-8x22b"].reduced()))
    with pytest.raises(ValueError, match=r"sliding_window >= cache_len \(8 < 24\)"):
        lm.check_paged_support(cfg, CACHE_LEN)
    with pytest.raises(ValueError, match="the slab reference wraps"):
        ServingEngine({"m": cfg}, mode="paged", cache_len=CACHE_LEN, device="cpu")
    assert not speculative_supported(cfg, CACHE_LEN)
    full = get_arch("mixtral-8x22b")
    lm.check_paged_support(full, 4096)
    with pytest.raises(ValueError, match="4096 < 8192"):
        lm.check_paged_support(full, 8192)


# ---------------------------------------------------------------------------
# The fp32-copy repairs: the same values as the formulas they replaced
# ---------------------------------------------------------------------------
def _attend_before(params, q, view_k, view_v, valid, cfg):
    """``attention._attend`` as it was: scores of fp32 copies of q and K."""
    b, _, c, hd = q.shape
    group = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, group, c, hd)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), view_k.float()) * (hd**-0.5)
    scores = torch.where(valid[:, None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p.to(view_v.dtype), view_v)
    return o.permute(0, 3, 1, 2, 4).reshape(b, c, cfg.n_heads * hd) @ params["wo"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attend_and_head_repairs_keep_their_values(dtype):
    """On the CPU: fp32 inputs agree with the old formulas to rounding of
    the summation order (atol 1e-6); bf16 inputs take the same upcast path
    as before, bit for bit (the card computes them without the copies)."""
    from repro_torch.models import attention, layers

    cfg = get_arch("qwen2-0.5b").reduced()
    gen = torch.Generator().manual_seed(1)
    b, c, w, hd = 2, 3, 10, cfg.hd
    q = torch.randn((b, cfg.n_heads, c, hd), generator=gen).to(dtype)
    k, v = (torch.randn((b, cfg.n_kv_heads, w, hd), generator=gen).to(dtype) for _ in range(2))
    valid = torch.rand((b, c, w), generator=gen) < 0.7
    valid[..., 0] = True
    wo = (torch.randn((cfg.n_heads * hd, cfg.d_model), generator=gen) * 0.1).to(dtype)
    got = attention._attend({"wo": wo}, q, k, v, valid, cfg)
    want = _attend_before({"wo": wo}, q, k, v, valid, cfg)
    x = torch.randn((b, c, cfg.d_model), generator=gen).to(dtype)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen).to(dtype)
    params = {"ln_f": torch.ones(cfg.d_model, dtype=dtype), "embed": embed, "unembed": embed.T}
    xn = layers.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    heads = {True: xn.float() @ embed.float().T, False: xn.float() @ embed.T.float()}
    for tie in (True, False):
        head = lm._head(params, dataclasses.replace(cfg, tie_embeddings=tie), x)
        assert head.dtype == torch.float32
        if dtype == torch.float32:
            np.testing.assert_allclose(head.numpy(), heads[tie].numpy(), rtol=0, atol=1e-6)
        else:
            assert torch.equal(head, heads[tie])
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    else:
        assert torch.equal(got, want)
