"""Deterministic synthetic data pipeline.

The reference's ``data/pipeline.py``, with zero I/O:

  * ``synthetic_lm_batch``: Zipf-distributed tokens with a first-order
    Markov structure, so language models learn (the loss falls);
  * ``batch_for``: shape-correct random batches for any (arch x shape) cell;
  * ``microbatch``: the train step's (k, B/k, ...) layout.

A batch is a pure function of (seed, step), which is what makes a
checkpoint restart resume exactly.  The draws come from a CPU
``torch.Generator`` seeded by ``numpy.random.SeedSequence((seed, step))``
and move to the device afterwards, so a batch is the same on every device
and in every process.  The frames and patches take a stream of their own,
keyed by the CRC-32 of their name (the reference keys it by
``hash(name)``, which Python salts per process).  The streams are not
jax's threefry: the port's batches match the reference's in distribution,
not in bits.
"""
from __future__ import annotations

import zlib
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.zoo import input_specs

# The Markov chain: Zipf marginals with exponent 1.1 over a capped alphabet;
# with probability 0.7 the next token is the previous one's fixed successor.
ZIPF_EXPONENT = 1.1
ALPHABET_CAP = 4096
P_SUCCESSOR = 0.7


def _generator(*words: int) -> torch.Generator:
    hi, lo = np.random.SeedSequence([int(w) for w in words]).generate_state(2, dtype=np.uint32)
    return torch.Generator().manual_seed(int(hi) << 32 | int(lo))


def successor(tok: torch.Tensor, v_eff: int) -> torch.Tensor:
    """A token's fixed successor in the chain."""
    return (tok * 7919 + 17) % v_eff


def zipf_probs(vocab: int) -> torch.Tensor:
    """The marginal of a fresh draw over ``min(vocab, 4096)`` tokens: the
    softmax of ``-1.1 log(rank)``."""
    ranks = torch.arange(1, min(vocab, ALPHABET_CAP) + 1, dtype=torch.float32)
    return torch.softmax(-ZIPF_EXPONENT * torch.log(ranks), dim=0)


def _markov_tokens(gen: torch.Generator, batch: int, seq: int, vocab: int) -> torch.Tensor:
    """(batch, seq) int64: a Zipf draw, then each next token the previous
    one's successor with probability 0.7, else a fresh Zipf draw."""
    probs = zipf_probs(vocab)
    draws = torch.multinomial(probs, batch * seq, replacement=True, generator=gen)
    draws = draws.reshape(batch, seq)
    pick = torch.rand((batch, seq - 1), generator=gen) < P_SUCCESSOR
    toks = torch.empty((batch, seq), dtype=torch.int64)
    tok = toks[:, 0] = draws[:, 0]
    for t in range(1, seq):
        tok = torch.where(pick[:, t - 1], successor(tok, probs.numel()), draws[:, t])
        toks[:, t] = tok
    return toks


def synthetic_lm_batch(cfg: ArchConfig, shape: ShapeConfig, step: int, *, seed: int = 0,
                       device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Learnable LM batch for one train step (a pure function of (seed,
    step)): ``tokens`` and ``labels`` (the tokens shifted by one), and the
    frames or patches the family takes, on ``device``."""
    dev = resolve_device(device)
    specs = input_specs(cfg, shape)
    out: Dict[str, torch.Tensor] = {}
    if "tokens" in specs:
        b, s = specs["tokens"][0]
        toks = _markov_tokens(_generator(seed, step), b, s + 1, cfg.vocab)
        out["tokens"] = toks[:, :-1]
        if "labels" in specs:
            out["labels"] = toks[:, 1:]
    for name in ("frames", "patches"):
        if name in specs:
            sp, dtype = specs[name]
            gen = _generator(seed, step, zlib.crc32(name.encode()))
            out[name] = torch.randn(sp, generator=gen).to(dtype)
    return {k: v.contiguous().to(dev) for k, v in out.items()}


def batch_for(cfg: ArchConfig, shape: ShapeConfig, *, seed: int = 0,
              device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Shape-correct random batch for any cell (no learnability)."""
    dev = resolve_device(device)
    gen = _generator(seed)
    out = {}
    for name, (sp, dtype) in input_specs(cfg, shape).items():
        if dtype == torch.int64:
            out[name] = torch.randint(0, cfg.vocab, sp, generator=gen)
        else:
            out[name] = torch.randn(sp, generator=gen).to(dtype)
    return {k: v.to(dev) for k, v in out.items()}


def microbatch(batch: Dict[str, torch.Tensor], k: int) -> Dict[str, torch.Tensor]:
    """(B, ...) -> (k, B/k, ...) for gradient accumulation."""
    if k <= 1:
        return batch
    return {name: x.reshape(k, x.shape[0] // k, *x.shape[1:]) for name, x in batch.items()}
