"""Plain forward of the served decoder-only MoE model (granite-moe's
layout), teacher-forced over a prompt and its served tokens.

Pre-norm blocks: RMSNorm, grouped-query attention with rotary embeddings on
interleaved pairs, causal softmax at 1/sqrt(head size); RMSNorm, a router
in float32 whose top-k logits are renormalised by a softmax, and SwiGLU
experts summed by those weights; a final RMSNorm and the head: the
embedding's transpose where the configuration ties them.  The
weights are the harness's own (``portbench.harness.weights``): this module
imports nothing of the program.  Layer by layer, one sequence at a time,
each layer's weights cast to the compute dtype only while it runs, so the
whole model never sits on the card twice.

``quant="fp8"`` is the control, the model computed in float8: each
product with a weight matrix takes both operands rounded to float8 e4m3
(the activations with one scale a row, the weights one a column), as an
fp8 GEMM does, the rest of the arithmetic that of the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
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


class Reference:
    """``logits(tokens)`` -> (S, V) for one token sequence (S,)."""

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

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        eps = float(c["rms_norm_eps"])
        h_q, h_kv = int(c["num_attention_heads"]), int(c["num_key_value_heads"])
        d = int(c["hidden_size"])
        hd = d // h_q
        top_k = int(c["num_experts_per_tok"])
        s = tokens.shape[0]
        x = self._v(self.w["embed"][tokens])
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        for layer in self.w["layers"]:
            h = _rmsnorm(x, self._v(layer["ln1"]), eps)
            q = self._mm(h, layer["wq"]).reshape(s, h_q, hd).transpose(0, 1)
            k = self._mm(h, layer["wk"]).reshape(s, h_kv, hd).transpose(0, 1)
            v = self._mm(h, layer["wv"]).reshape(s, h_kv, hd).transpose(0, 1)
            q, k = _rope(q, float(c["rope_theta"])), _rope(k, float(c["rope_theta"]))
            group = h_q // h_kv
            k = k.repeat_interleave(group, dim=0)
            v = v.repeat_interleave(group, dim=0)
            scores = (q @ k.transpose(1, 2)) * hd**-0.5
            p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
            o = (p @ v).transpose(0, 1).reshape(s, h_q * hd)
            x = x + self._mm(o, layer["wo"])
            h = _rmsnorm(x, self._v(layer["ln2"]), eps)
            router = h.float() @ layer["router"].float()
            top_vals, top_idx = torch.topk(router, top_k, dim=-1)
            gate = torch.softmax(top_vals, dim=-1).to(self.dtype)
            out = torch.zeros_like(x)
            for e in torch.unique(top_idx).tolist():
                rows, slot = torch.nonzero(top_idx == e, as_tuple=True)
                he = h[rows]
                ye = self._mm(F.silu(self._mm(he, layer["w_gate"][e]))
                              * self._mm(he, layer["w_up"][e]), layer["w_down"][e])
                out.index_add_(0, rows, ye * gate[rows, slot][:, None])
            x = x + out
        x = _rmsnorm(x, self._v(self.w["ln_f"]), eps)
        head = self.w["embed"].T if c["tie_word_embeddings"] else self.w["unembed"]
        return self._mm(x, head).float()


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

