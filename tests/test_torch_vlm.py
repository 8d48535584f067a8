"""The port's VLM family (llava-next-mistral-7b) against the JAX reference's,
on the same weights.

Reduced llava in fp32 (16 patches of width 32 in front of the tokens): the
reference's parameters carried across with ``params_from_reference``, the
same numpy patches and tokens through both, the reference with
``attn_impl="pallas"`` (its flash kernel in interpret mode, as its own
tests run it) and the port with ``"kernel"`` (the plain version on the
CPU).  Logits at atol 1e-4, the dense models' bound (PERF.md); greedy
tokens of the serving engine exactly, in all four modes (the VLM serves on
text alone, as the reference's engine does).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import lm as jax_lm
from repro.runtime.serve_loop import ServingEngine as JaxEngine
from repro_torch.configs import SHAPES, arch_from_reference, get_arch
from repro_torch.models import build_model, input_specs, lm, params_from_reference
from repro_torch.runtime.serve_loop import ServingEngine

ARCH = "llava-next-mistral-7b"
ATOL = 1e-4
CACHE_LEN = 24


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JAX_ARCHS[ARCH].reduced(), attn_impl="pallas")
    jparams = jax_lm.init_params(jax.random.key(0), jcfg)
    cfg = arch_from_reference(jcfg)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, b, n_text, seed):
    rng = np.random.default_rng(seed)
    patches = rng.normal(size=(b, cfg.n_patches, cfg.d_vision)).astype(np.float32)
    return patches, rng.integers(0, cfg.vocab, size=(b, n_text))


def test_reduced_config_and_projector(model):
    _, _, cfg, params = model
    assert (cfg.family, cfg.n_patches, cfg.d_vision) == ("vlm", 16, 32)
    assert set(params["projector"]) == {"w1", "w2"}
    assert params["projector"]["w1"].shape == (cfg.d_vision, cfg.d_model)
    full = get_arch(ARCH)
    specs = input_specs(full, SHAPES["prefill_32k"], batch_override=1)
    assert specs == {"patches": ((1, 2880, 1024), torch.bfloat16),
                     "tokens": ((1, 32768 - 2880), torch.int64)}
    assert set(input_specs(full, SHAPES["train_4k"])) == {"patches", "tokens", "labels"}
    assert input_specs(full, SHAPES["decode_32k"]) == {"tokens": ((128, 1), torch.int64)}


def test_forward_and_prefill_with_patches_match_reference(model):
    jcfg, jparams, cfg, params = model
    patches, toks = _batch(cfg, 2, 8, 3)
    batch = {"patches": _t(patches), "tokens": _t(toks)}
    jbatch = {"patches": jnp.asarray(patches), "tokens": jnp.asarray(toks, jnp.int32)}
    got = lm.forward(params, cfg, batch)
    want = np.asarray(jax_lm.forward(jparams, jcfg, jbatch))
    assert got.shape == (2, cfg.n_patches + 8, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    last = build_model(cfg).prefill(params, batch)
    np.testing.assert_allclose(last.numpy(), np.asarray(jax_lm.prefill(jparams, jcfg, jbatch)),
                               rtol=0, atol=ATOL)


def test_patches_move_the_logits(model):
    """The port's form of the reference's patch test (on logits: the
    training loss waits): other patches, other logits at every text
    position; no patches, the text-only model."""
    _, _, cfg, params = model
    patches, toks = _batch(cfg, 1, 8, 4)
    base = lm.forward(params, cfg, {"patches": _t(patches), "tokens": _t(toks)})
    moved = lm.forward(params, cfg, {"patches": _t(patches * 2.0 + 1.0), "tokens": _t(toks)})
    text = slice(cfg.n_patches, None)
    assert float((moved[:, text] - base[:, text]).abs().amin(-1).max()) > 0
    assert float((moved[:, text] - base[:, text]).abs().max()) > 1e-3
    alone = lm.forward(params, cfg, {"tokens": _t(toks)})
    assert alone.shape == (1, 8, cfg.vocab)
    assert float((alone - base[:, text]).abs().max()) > 1e-3


def test_prefill_state_and_decode_match_reference(model):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(5)
    prompt, feeds = rng.integers(0, cfg.vocab, (2, 6)), rng.integers(0, cfg.vocab, (2, 3))
    got, st = lm.prefill_state(params, cfg, _t(prompt), CACHE_LEN)
    want, jst = jax_lm.prefill_state(jparams, jcfg, jnp.asarray(prompt, jnp.int32), CACHE_LEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for t in range(3):
        got, st = lm.decode_step(params, cfg, st, _t(feeds[:, t : t + 1]))
        want, jst = jax_lm.decode_step(jparams, jcfg, jst,
                                       jnp.asarray(feeds[:, t : t + 1], jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert st.pos.tolist() == [int(jst.pos)] * 2
    lm.check_paged_support(cfg, CACHE_LEN)


ENGINE_KW = {"continuous": {"n_slots": 3}, "generation": {},
             "paged": {"n_slots": 3, "block_size": 8, "prefill_chunk": 2},
             "speculative": {"spec_k": 3}}


@pytest.mark.parametrize("mode", list(ENGINE_KW))
def test_tokens_equal_the_reference_engine(mode):
    jcfg = JAX_ARCHS[ARCH].reduced()
    rng = np.random.default_rng(6)
    work = [(rng.integers(0, jcfg.vocab, size=(1, 4)), n) for n in (4, 1, 6, 2)]
    with JaxEngine({ARCH: jcfg}, mode=mode, cache_len=CACHE_LEN, **ENGINE_KW[mode]) as eng:
        want = [eng.submit(ARCH, p, n).result(timeout=300).tokens.tolist() for p, n in work]
        jparams = jax.tree.map(np.asarray, eng.params[ARCH])
    cfg = arch_from_reference(jcfg)
    params = {ARCH: params_from_reference(jparams, cfg, "cpu")}
    with ServingEngine({ARCH: cfg}, mode=mode, cache_len=CACHE_LEN, device="cpu", params=params,
                       **ENGINE_KW[mode]) as eng:
        got = [g.result(timeout=120).tokens.tolist()
               for g in [eng.submit(ARCH, p, n) for p, n in work]]
        summary = eng.summary()
    assert got == want
    if mode == "speculative":
        assert summary["spec_accept"][f"spec:{ARCH}"]["rounds"] > 0
