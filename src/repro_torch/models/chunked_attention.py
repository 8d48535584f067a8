"""Flash-style blocked attention in plain PyTorch.

The reference's ``models/chunked_attention.py``: the whole query against
one block of keys at a time, with a running (max, sum, acc) online softmax,
so the (B, H, S, S) scores never exist; peak memory per block is
(B, H, S, block_k) fp32 scores.  It serves ``attn_impl="chunked"``,
attention with unequal query and key lengths, and, on the card, the
check of the flash kernel at lengths where the materialising plain version
does not fit (32k tokens: 60 GB of scores).

Both products accumulate in fp32 from the inputs' own values, as the
reference's ``preferred_element_type=float32`` does; ``p`` is rounded to
the value type before the PV product.  The reference pads the last key
block; here it is simply shorter, which computes the same sums.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.runtime.sharding import local_attention, maybe_constrain_heads

NEG_INF = -1e30


def _kv_block(qf, kblk, vblk, m, l, acc, k_start: int, s_kv: int, causal: bool,
              window: Optional[int], scale: float, q_start: int = 0):
    """One key block into the running (max, sum, acc) -> the new three."""
    s = qf.shape[2]
    rows = torch.arange(q_start, q_start + s, device=qf.device)[:, None]  # absolute q index
    sc = (qf @ kblk.float().transpose(-1, -2)) * scale  # (B, H, S, bk)
    cols = k_start + torch.arange(kblk.shape[2], device=qf.device)[None, :]
    mask = cols < s_kv
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    sc = torch.where(mask, sc, NEG_INF)
    m_new = torch.maximum(m, sc.amax(dim=-1))
    p = torch.exp(sc - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = alpha * l + p.sum(dim=-1)
    acc = acc * alpha[..., None] + p.to(vblk.dtype).float() @ vblk.float()
    return m_new, l, acc


def attention_chunked(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_k: int = 512,
) -> torch.Tensor:
    b, h, s, d = q.shape
    hkv, s_kv = k.shape[1], k.shape[2]
    group = h // hkv
    if scale is None:
        scale = d**-0.5
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    k = maybe_constrain_heads(k, "kv")
    v = maybe_constrain_heads(v, "kv")
    q = maybe_constrain_heads(q, "q")
    return local_attention(partial(_blocked, causal=causal, window=window, scale=scale,
                                   block_k=block_k), q, k, v)


def _blocked(q, k, v, *, causal, window, scale, block_k, q_start: int = 0):
    """The online-softmax loop over key blocks; ``q_start`` is the absolute
    position of q's first row (a shard of the query rows)."""
    b, h, s, d = q.shape
    s_kv = k.shape[2]
    qf = q.float()
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    bk = min(block_k, s_kv)
    for k_start in range(0, s_kv, bk):
        args = (qf, k[:, :, k_start : k_start + bk], v[:, :, k_start : k_start + bk], m, l, acc,
                k_start, s_kv, causal, window, scale, q_start)
        if remat:
            # No RNG state to keep (a capture of the train step refuses it).
            m, l, acc = checkpoint(_kv_block, *args, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            m, l, acc = _kv_block(*args)
    safe = torch.where(l > 0, l, 1.0)
    return (acc / safe[..., None]).to(q.dtype)
