"""The port's synthetic data pipeline: the reference's Markov structure,
held by its statistics (the port draws from PyTorch's generator, not jax's
threefry, so the batches match the reference's in distribution, not in
bits), and a batch as a pure function of (seed, step), in a second
process too.

Bounds: the successor share within 5 binomial standard deviations of
0.7 + 0.3 P(draw = successor); the first token's Zipf marginal by a chi^2
over bins of at least 20 expected counts, below df + 5 sqrt(2 df).
"""
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data.pipeline import batch_for as jax_batch_for
from repro.data.pipeline import synthetic_lm_batch as jax_synthetic_lm_batch
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.data import batch_for, microbatch, synthetic_lm_batch
from repro_torch.data.pipeline import successor, zipf_probs

REPO = Path(__file__).resolve().parents[1]
SIGMAS = 5.0


def _cfg(name="smollm-360m"):
    return ARCHS[name].reduced()


def _tokens(cfg, steps, batch, seq, seed=0):
    shape = ShapeConfig("t", seq, batch, "train")
    return [synthetic_lm_batch(cfg, shape, s, seed=seed, device="cpu") for s in steps]


@pytest.mark.parametrize("name", ["smollm-360m", "qwen2-0.5b"])
def test_tokens_lie_in_the_capped_alphabet(name):
    """Tokens in [0, min(vocab, 4096)) (the full vocabularies, 49,152 and
    151,936, cap at 4096), labels the tokens shifted by one, the shapes and
    dtypes of the reference's specs."""
    cfg = ARCHS[name]
    shape = ShapeConfig("t", 64, 4, "train")
    b = synthetic_lm_batch(cfg, shape, 3, device="cpu")
    ref = jax_synthetic_lm_batch(JAX_ARCHS[name], JaxShapeConfig("t", 64, 4, "train"), 3)
    assert sorted(b) == sorted(ref) == ["labels", "tokens"]
    for k in b:
        assert tuple(b[k].shape) == ref[k].shape and b[k].dtype == torch.int64
    v_eff = min(cfg.vocab, 4096)
    for toks in (b["tokens"], b["labels"]):
        assert int(toks.min()) >= 0 and int(toks.max()) < v_eff
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_successor_share_follows_the_chain():
    """P(next = successor(prev)) = 0.7 + 0.3 zipf(successor(prev)): the
    observed share over 64 x 255 transitions a batch, 20 batches."""
    cfg = _cfg()
    probs = zipf_probs(cfg.vocab).double()
    hits, expected, var = 0, 0.0, 0.0
    for b in _tokens(cfg, range(20), 64, 255):
        toks = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1)
        prev, nxt = toks[:, :-1], toks[:, 1:]
        succ = successor(prev, probs.numel())
        p = 0.7 + 0.3 * probs[succ]
        hits += int((nxt == succ).sum())
        expected += float(p.sum())
        var += float((p * (1 - p)).sum())
    assert abs(hits - expected) <= SIGMAS * var**0.5, (hits, expected, var**0.5)


def test_first_token_is_zipf():
    """The first token of each row is a fresh Zipf(1.1) draw: chi^2 over
    rank bins holding at least 20 expected counts."""
    cfg = _cfg()
    probs = zipf_probs(cfg.vocab).double().numpy()
    first = torch.cat([b["tokens"][:, 0] for b in _tokens(cfg, range(100), 64, 8)]).numpy()
    n = first.size
    counts = np.bincount(first, minlength=probs.size)
    obs, exp, o_acc, e_acc = [], [], 0, 0.0
    for o, p in zip(counts, probs):
        o_acc, e_acc = o_acc + o, e_acc + n * p
        if e_acc >= 20:
            obs.append(o_acc)
            exp.append(e_acc)
            o_acc, e_acc = 0, 0.0
    obs[-1] += o_acc
    exp[-1] += e_acc
    obs, exp = np.array(obs, float), np.array(exp)
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    df = len(obs) - 1
    assert df >= 20
    assert chi2 < df + SIGMAS * (2 * df) ** 0.5, (chi2, df)


_SCRIPT = r"""
import hashlib, sys
sys.path.insert(0, {src!r})
from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.data import synthetic_lm_batch
for name in ("whisper-large-v3", "llava-next-mistral-7b", "smollm-360m"):
    cfg = ARCHS[name].reduced()
    b = synthetic_lm_batch(cfg, ShapeConfig("t", 40, 2, "train"), 7, seed=3, device="cpu")
    for k in sorted(b):
        print(name, k, hashlib.sha256(b[k].numpy().tobytes()).hexdigest())
"""


def _digests():
    out = []
    for name in ("whisper-large-v3", "llava-next-mistral-7b", "smollm-360m"):
        cfg = ARCHS[name].reduced()
        b = synthetic_lm_batch(cfg, ShapeConfig("t", 40, 2, "train"), 7, seed=3, device="cpu")
        for k in sorted(b):
            out.append(f"{name} {k} {hashlib.sha256(b[k].numpy().tobytes()).hexdigest()}")
    return out


def test_same_seed_and_step_same_batch_in_another_process():
    """A batch, frames and patches too, is a pure function of (seed, step):
    the same bytes in a fresh interpreter (whose string hashes are salted
    otherwise; the reference keys frames and patches by ``hash(name)``)."""
    mine = _digests()
    assert any(" frames " in line for line in mine) and any(" patches " in line for line in mine)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT.format(src=str(REPO / "src"))],
                          capture_output=True, text=True, timeout=120,
                          env={"PYTHONHASHSEED": "12345", "PATH": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:-1] == mine
    cfg = _cfg()
    shape = ShapeConfig("t", 16, 2, "train")
    a, b, c = (synthetic_lm_batch(cfg, shape, s, device="cpu") for s in (1, 1, 2))
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"], c["tokens"])
    other = synthetic_lm_batch(cfg, shape, 1, seed=1, device="cpu")
    assert not torch.equal(a["tokens"], other["tokens"])


@pytest.mark.parametrize("name", ["whisper-large-v3", "llava-next-mistral-7b", "mamba2-1.3b"])
def test_batch_for_and_microbatch_shapes(name):
    """``batch_for`` gives the reference's cell shapes (token ids int64,
    embeddings in the compute dtype); ``microbatch`` the (k, B/k, ...)
    layout of the train step."""
    cfg = ARCHS[name].reduced()
    shape = ShapeConfig("t", 48, 4, "train")
    mine = batch_for(cfg, shape, seed=2, device="cpu")
    ref = jax_batch_for(JAX_ARCHS[name].reduced(), JaxShapeConfig("t", 48, 4, "train"), seed=2)
    assert sorted(mine) == sorted(ref)
    for k, x in mine.items():
        assert tuple(x.shape) == ref[k].shape
        assert x.dtype == (torch.int64 if ref[k].dtype.kind == "i" else torch.float32)
    assert torch.equal(batch_for(cfg, shape, seed=2, device="cpu")["tokens"], mine["tokens"])
    mb = microbatch(synthetic_lm_batch(cfg, shape, 0, device="cpu"), 2)
    assert all(x.shape[:2] == (2, 2) for x in mb.values())
    assert microbatch(mine, 1) is mine
