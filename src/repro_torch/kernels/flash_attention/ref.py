"""Plain PyTorch version of (GQA, causal, optionally sliding-window)
attention: materialises the (B, H, Sq, Sk) scores.

The reference's ``kernels/flash_attention/ref.py`` step for step: K and V
repeated per query head, masked scores at ``-inf`` then ``nan_to_num``
(a fully masked row gives zeros), and ``p`` cast to the query's type before
the PV product.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    _, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    if scale is None:
        scale = d**-0.5
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk).float() * scale
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    logits = torch.where(mask, logits, float("-inf"))
    p = torch.nan_to_num(torch.exp(logits - logits.amax(dim=-1, keepdim=True)))
    p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), vv)
