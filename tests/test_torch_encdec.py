"""The port's encoder-decoder (whisper-large-v3) against the JAX reference's,
on the same weights.

Reduced whisper in fp32 (2 encoder and 2 decoder layers, 32 frames): the
reference's ``encdec.init_params`` tree carried across with
``params_from_reference``, the same numpy frames and tokens through both,
the reference with ``attn_impl="pallas"`` (its flash kernel in interpret
mode, as its own tests run it) and the port with ``"kernel"`` (the plain
version on the CPU).  Encoder output and logits at atol 1e-4, the dense
models' bound (PERF.md); teacher-forced decode against the port's own
``decode_train`` at 2e-3, the reference's bound for that check
(``tests/test_models_smoke.py``).  The serving engine refuses the family
with the reference's message: its decode state comes from frames.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import encdec as jax_encdec
from repro.runtime.serve_loop import ServingEngine as JaxEngine
from repro_torch.configs import SHAPES, arch_from_reference, get_arch
from repro_torch.models import build_model, encdec, input_specs, params_from_reference
from repro_torch.runtime.serve_loop import ServingEngine

ARCH = "whisper-large-v3"
ATOL = 1e-4
CACHE_LEN = 24


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JAX_ARCHS[ARCH].reduced(), attn_impl="pallas")
    jparams = jax_encdec.init_params(jax.random.key(0), jcfg)
    cfg = arch_from_reference(jcfg)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return frames, rng.integers(0, cfg.vocab, size=(b, s))


def test_structure_and_input_specs(model):
    _, jparams, cfg, params = model
    assert (cfg.family, cfg.n_encoder_layers, cfg.n_frames, cfg.rope_theta) == (
        "encdec", 2, 32, 0.0)
    assert len(params["enc_blocks"]) == 2 and len(params["dec_blocks"]) == cfg.n_layers
    assert set(params) == {"enc_blocks", "dec_blocks", "embed", "ln_enc", "ln_f"}
    assert set(params["dec_blocks"][1]) == {"ln1", "self_attn", "ln_x", "cross_attn", "ln2",
                                           "mlp"}
    np.testing.assert_array_equal(params["dec_blocks"][1]["cross_attn"]["wq"].numpy(),
                                  np.asarray(jparams["dec_blocks"]["cross_attn"]["wq"][1]))
    own = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert {k: type(v) for k, v in own.items()} == {k: type(v) for k, v in params.items()}
    full = get_arch(ARCH)
    assert input_specs(full, SHAPES["prefill_32k"], batch_override=1) == {
        "frames": ((1, 1500, 1280), torch.bfloat16), "tokens": ((1, 32768), torch.int64)}
    assert set(input_specs(full, SHAPES["train_4k"])) == {"frames", "tokens", "labels"}
    np.testing.assert_allclose(encdec.sinusoidal_positions(40, 64, offset=3).numpy(),
                               np.asarray(jax_encdec.sinusoidal_positions(40, 64, offset=3)),
                               rtol=0, atol=1e-5)


def test_encode_and_decode_train_match_reference(model):
    jcfg, jparams, cfg, params = model
    frames, toks = _inputs(cfg, 2, 12, 3)
    enc = encdec.encode(params, cfg, _t(frames))
    jenc = jax_encdec.encode(jparams, jcfg, jnp.asarray(frames))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), rtol=0, atol=ATOL)
    got = encdec.decode_train(params, cfg, _t(toks), enc)
    want = np.asarray(jax_encdec.decode_train(jparams, jcfg, jnp.asarray(toks, jnp.int32), jenc))
    assert got.shape == (2, 12, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    last = build_model(cfg).prefill(params, {"frames": _t(frames), "tokens": _t(toks)})
    np.testing.assert_allclose(last.numpy(), want[:, -1:], rtol=0, atol=ATOL)


def test_decode_state_and_steps_match_reference(model):
    """``init_decode_state`` (the encoder once, each layer's cross K/V) and
    decode steps, logits and caches against the reference's."""
    jcfg, jparams, cfg, params = model
    frames, toks = _inputs(cfg, 2, 5, 4)
    st = build_model(cfg).decode_init(params, {"frames": _t(frames)}, CACHE_LEN)
    jst = jax_encdec.init_decode_state(jparams, jcfg, jnp.asarray(frames), CACHE_LEN)
    assert st.cross_k.shape == (cfg.n_layers, 2, cfg.n_kv_heads, cfg.n_frames, cfg.hd)
    for got, want in ((st.cross_k, jst.cross_k), (st.cross_v, jst.cross_v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for t in range(toks.shape[1]):
        got, st = encdec.decode_step(params, cfg, st, _t(toks[:, t : t + 1]))
        want, jst = jax_encdec.decode_step(jparams, jcfg, jst,
                                           jnp.asarray(toks[:, t : t + 1], jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert st.pos.tolist() == [int(jst.pos)] * 2
    np.testing.assert_allclose(st.kv.k.numpy(), np.asarray(jst.kv.k), rtol=0, atol=ATOL)
    assert st.kv.pos_buf[0].tolist() == np.asarray(jst.kv.pos_buf).tolist()


def test_teacher_forced_decode_matches_decode_train(model):
    _, _, cfg, params = model
    frames, toks = _inputs(cfg, 2, 12, 5)
    full = encdec.decode_train(params, cfg, _t(toks), encdec.encode(params, cfg, _t(frames)))
    st = encdec.init_decode_state(params, cfg, _t(frames), 16)
    outs = []
    for t in range(12):
        logits, st = encdec.decode_step(params, cfg, st, _t(toks[:, t : t + 1]))
        outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=0, atol=2e-3)


def test_rows_at_different_positions_decode_independently(model):
    """A batch whose rows sit at different positions gives each row the
    logits of its own B = 1 decode (a position per row, as the decoder-only
    LMs')."""
    _, _, cfg, params = model
    frames, toks = _inputs(cfg, 2, 6, 6)
    rows = [encdec.init_decode_state(params, cfg, _t(frames[r : r + 1]), 16) for r in (0, 1)]
    for r, n in ((0, 2), (1, 5)):
        for t in range(n):
            _, rows[r] = encdec.decode_step(params, cfg, rows[r], _t(toks[r : r + 1, t : t + 1]))
    both = encdec.init_decode_state(params, cfg, _t(frames), 16)
    for r in (0, 1):
        both.kv.k[:, r] = rows[r].kv.k[:, 0]
        both.kv.v[:, r] = rows[r].kv.v[:, 0]
        both.kv.pos_buf[r] = rows[r].kv.pos_buf[0]
    both = both._replace(pos=torch.tensor([2, 5]))
    feed = _t(toks[:, 5:6])
    pooled, _ = encdec.decode_step(params, cfg, both, feed)
    for r in (0, 1):
        one, _ = encdec.decode_step(params, cfg, rows[r], feed[r : r + 1])
        np.testing.assert_allclose(pooled[r].numpy(), one[0].numpy(), rtol=0, atol=1e-5)


def test_engine_refuses_the_family_as_the_reference_does():
    cfg = arch_from_reference(JAX_ARCHS[ARCH].reduced())
    assert build_model(cfg).prefill_state is None
    for mode in ("continuous", "generation", "speculative", "paged"):
        with pytest.raises(ValueError) as mine:
            ServingEngine({ARCH: cfg}, mode=mode, cache_len=CACHE_LEN, device="cpu")
        with pytest.raises(ValueError) as theirs:
            JaxEngine({ARCH: JAX_ARCHS[ARCH].reduced()}, mode=mode, cache_len=CACHE_LEN)
        assert str(mine.value) == str(theirs.value)
    # The family trains (the training loss is ported): its bundle's loss
    # is the teacher-forced decoder's cross entropy.
    assert build_model(cfg).loss is not None and callable(encdec.lm_loss)
