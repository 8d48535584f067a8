"""The pieces of a served LM's plain forward, which each architecture's
``Reference`` (``portbench/archs/<model_type>.py``) is built of, and the
comparison of served tokens with it.

RMSNorm, rotary embeddings on interleaved pairs, and :class:`PlainLM`:
the weights are the harness's own (``portbench.harness.weights``), each
matrix cast to the compute dtype only while it runs, so the whole model
never sits on the card twice.  Nothing here imports anything of the
program.

``quant="fp8"`` is the control, the model computed in float8: each
product with a weight matrix takes both operands rounded to float8 e4m3
(the activations with one scale a row, the weights one a column), as an
fp8 GEMM does, the rest of the arithmetic that of the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.harness.cells import load_arch


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (H, S, D): rotate the interleaved pairs (x[..., ::2], x[..., 1::2])
    by position * theta^(-2i/D)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
    ang = torch.arange(x.shape[1], dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)


def quantize_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Round ``t`` to float8 e4m3 with one scale along ``dim`` (the largest
    magnitude maps to 448), and back."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class PlainLM:
    """What every architecture's reference shares: its weights, its
    configuration, the compute dtype and the products with a weight
    matrix.  A subclass gives ``logits(tokens)`` -> (S, V) for one token
    sequence (S,)."""

    def __init__(self, weights: Dict, cfg: Dict, *, dtype=torch.float32,
                 quant: Optional[str] = None) -> None:
        self.w = weights
        self.cfg = cfg
        self.dtype = dtype
        self.quant = quant

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for a weight matrix ``w``, in the compute dtype."""
        w = w.to(self.dtype)
        if self.quant == "fp8":
            return quantize_fp8(x, -1) @ quantize_fp8(w, -2)
        return x @ w

    def _v(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)


def Reference(weights: Dict, cfg: Dict, **kw) -> PlainLM:
    """The plain forward of ``cfg``'s ``model_type`` over ``weights``."""
    return load_arch(cfg["model_type"]).Reference(weights, cfg, **kw)


def served_gaps(logits: torch.Tensor, prompt_len: int, served: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each served token lies:
    served token i follows position ``prompt_len - 1 + i``."""
    rows = logits[prompt_len - 1: prompt_len - 1 + served.shape[0]]
    return rows.max(dim=-1).values - rows.gather(1, served[:, None]).squeeze(1)


def control_gaps(ref_logits: torch.Tensor, ctl_logits: torch.Tensor, prompt_len: int,
                 n: int) -> torch.Tensor:
    """The reference's gap of the token the control puts first, at the
    same positions as :func:`served_gaps`."""
    rows = slice(prompt_len - 1, prompt_len - 1 + n)
    pick = ctl_logits[rows].argmax(dim=-1)
    ref = ref_logits[rows]
    return ref.max(dim=-1).values - ref.gather(1, pick[:, None]).squeeze(1)
