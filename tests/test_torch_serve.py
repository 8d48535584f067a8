"""The port's LM serving engine against the JAX reference's.

The port serves the reference engine's own weights (its ``params``,
carried across with ``params_from_reference``); greedy tokens of the
port's continuous (slot pool) and generation modes must equal each other
and the reference engine's tokens exactly, as the reference's own
cross-mode test demands of its modes (``tests/test_serve_continuous.py``).
Token identity is an argmax of fp32 logits that agree to ~1e-6 between the
frameworks; the reduced models' top-2 gaps are far above that.
"""
import dataclasses
import importlib

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.runtime.serve_loop import ServingEngine as JaxEngine
from repro_torch.balancer import PromptTooLongError
from repro_torch.configs import ARCHS, arch_from_reference
from repro_torch.launch.serve import build_parser
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import params_from_reference
from repro_torch.runtime.serve_loop import ServingEngine

CACHE_LEN = 24


def _work(vocab, seed=2):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=(1, 4)), n_new) for n_new in (5, 1, 3, 7, 2, 4)]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "smollm-360m"])
def test_tokens_match_each_other_and_the_reference(arch):
    jcfg = JAX_ARCHS[arch].reduced()
    work = _work(jcfg.vocab)
    with JaxEngine({arch: jcfg}, mode="continuous", n_slots=3, cache_len=CACHE_LEN) as eng:
        gens = [eng.submit(arch, p, n) for p, n in work]
        want = [g.result(timeout=120).tokens for g in gens]
        jparams = jax.tree.map(np.asarray, eng.params[arch])
    cfg = arch_from_reference(jcfg)
    params = params_from_reference(jparams, cfg, "cpu")
    outs = {}
    for mode in ("continuous", "generation"):
        with ServingEngine({arch: cfg}, mode=mode, n_slots=3, cache_len=CACHE_LEN,
                           device="cpu", params={arch: params}) as eng:
            gens = [eng.submit(arch, p, n) for p, n in work]
            outs[mode] = [g.result(timeout=120).tokens for g in gens]
            if mode == "continuous":
                s = eng.summary()
                assert sum(s["tag_tokens"].values()) > 0
                assert s["slot_occupancy"]
    for mode, toks in outs.items():
        assert [len(t) for t in toks] == [n for _, n in work]
        for a, b in zip(toks, want):
            assert np.array_equal(a, b), mode


@pytest.mark.parametrize("arch,mode", [
    ("mamba2-1.3b", "continuous"), ("mamba2-1.3b", "generation"),
    ("granite-moe-3b-a800m", "continuous"), ("granite-moe-3b-a800m", "generation"),
    ("zamba2-1.2b", "continuous"), ("zamba2-1.2b", "generation"),
])
def test_family_tokens_equal_the_reference_engine(arch, mode):
    """The MoE, SSM and hybrid families, reduced, on the reference engine's
    weights: the port's greedy tokens equal the reference engine's in the
    same mode (paged and speculative: tests/test_torch_paged.py)."""
    jcfg = JAX_ARCHS[arch].reduced()
    work = _work(jcfg.vocab, seed=4)
    with JaxEngine({arch: jcfg}, mode=mode, n_slots=3, cache_len=CACHE_LEN) as eng:
        want = [eng.submit(arch, p, n).result(timeout=120).tokens.tolist() for p, n in work]
        jparams = jax.tree.map(np.asarray, eng.params[arch])
    cfg = arch_from_reference(jcfg)
    with ServingEngine({arch: cfg}, mode=mode, n_slots=3, cache_len=CACHE_LEN, device="cpu",
                       params={arch: params_from_reference(jparams, cfg, "cpu")}) as eng:
        gens = [eng.submit(arch, p, n) for p, n in work]
        got = [g.result(timeout=120).tokens.tolist() for g in gens]
    assert got == want
    assert [len(t) for t in got] == [n for _, n in work]


def test_engine_inits_from_the_seed_and_shares_weights_across_modes():
    cfg = ARCHS["qwen2-0.5b"].reduced()
    work = _work(cfg.vocab, seed=3)[:3]
    outs = []
    for mode in ("continuous", "generation"):
        with ServingEngine({"m": cfg}, mode=mode, n_slots=2, cache_len=CACHE_LEN,
                           device="cpu", seed=7) as eng:
            outs.append([eng.submit("m", p, n).result(timeout=120).tokens for p, n in work])
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


def test_engine_refuses_what_is_not_ported_and_what_cannot_fit():
    cfg = ARCHS["qwen2-0.5b"].reduced()
    with pytest.raises(ValueError, match="mode"):
        ServingEngine({"m": cfg}, mode="batch", device="cpu")
    with pytest.raises(ValueError, match="kv"):
        ServingEngine({"m": cfg}, kv="ring", device="cpu")
    # A paged view never wraps, so a window shorter than the cache is refused.
    windowed = dataclasses.replace(cfg, sliding_window=16)
    for kw in ({"mode": "paged"}, {"kv": "paged"}):
        with pytest.raises(ValueError, match="sliding_window"):
            ServingEngine({"m": windowed}, cache_len=24, device="cpu", **kw)
    with ServingEngine({"m": cfg}, cache_len=8, device="cpu") as eng:
        with pytest.raises(PromptTooLongError):
            eng.submit("m", np.zeros((1, 6), np.int64), 4)
        with pytest.raises(KeyError):
            eng.submit("other", np.zeros((1, 2), np.int64), 1)


@pytest.mark.parametrize("module,name", [
    ("repro_torch.runtime.serve_loop", "shard_prefill_step"),
    ("repro_torch.runtime.serve_loop", "shard_decode_step"),
    # Was ("repro_torch.models.lm", "lm_loss"), ported with training.
    ("repro_torch.runtime.train_loop", "shard_train_step"),
])
def test_reference_only_entry_points_raise(module, name):
    """The reference's sharded entry points, once refused, are ported: each
    is a function that refuses a call without a config as the reference's
    own does."""
    mod = importlib.import_module(module)
    ref = importlib.import_module(module.replace("repro_torch.", "repro."))
    for fn in (getattr(mod, name), getattr(ref, name)):
        with pytest.raises(AttributeError):
            fn(None, None, None)
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_function")


@pytest.mark.parametrize("module,name", [
    ("repro_torch.runtime.serve_loop", "make_paged_decode_pool"),
    ("repro_torch.runtime.serve_loop", "make_speculative_fn"),
    ("repro_torch.runtime.serve_loop", "speculative_supported"),
    ("repro_torch.models.lm", "paged_decode_step"),
    ("repro_torch.models.lm", "paged_prefill_chunk"),
    ("repro_torch.models.lm", "paged_reset_slot"),
    ("repro_torch.models.lm", "slot_evict"),
])
def test_ported_entry_points_resolve(module, name):
    assert callable(getattr(importlib.import_module(module), name))


def test_serve_cli_on_the_cpu(capsys):
    m = serve_main(["--device", "cpu", "--requests", "6", "--slots", "4", "--cache-len", "80"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "slot occupancy" in out
    assert m["n_requests"] == 6 and m["n_tokens"] == sum(len(t) for t in m["tokens"])
    capsys.readouterr()
    paged = serve_main(["--device", "cpu", "--requests", "6", "--kv", "paged", "--slots", "4",
                        "--cache-len", "80", "--block-size", "8", "--prefill-chunk", "2"])
    out = capsys.readouterr().out
    assert "[serve:paged:cpu]" in out and "block occupancy" in out
    spec = serve_main(["--device", "cpu", "--requests", "6", "--mode", "speculative",
                       "--cache-len", "80", "--spec-k", "3"])
    assert "spec accept rate" in capsys.readouterr().out
    gen = serve_main(["--device", "cpu", "--requests", "6", "--mode", "generation",
                      "--cache-len", "80"])
    for other in (m, paged, spec):
        assert len(other["tokens"]) == len(gen["tokens"]) == 6
        for a, b in zip(other["tokens"], gen["tokens"]):
            assert np.array_equal(a, b)


def test_serve_cli_can_ask_for_the_full_width():
    """The reference's --reduced is store_true with default True, so its
    full config is unreachable; the port's --no-reduced reaches it."""
    ap = build_parser()
    assert ap.parse_args([]).reduced is True
    assert ap.parse_args(["--no-reduced"]).reduced is False
    assert ap.parse_args([]).device == "cuda"
