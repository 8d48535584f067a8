"""GQA attention with RoPE and optional QKV bias: prefill and decode.

The reference's ``models/attention.py``, with its sharding hooks (no-ops
without a policy); the decode cache carries a position per batch row
(``pos`` (B,), ``pos_buf`` (B, W)), so rows admitted at different token
boundaries decode together in one batched step where the reference
``vmap``s a B = 1 step over the slots.  The decode cache is updated in
place (it is the largest state a step touches).

The paged path keeps one block pool for every slot
(:class:`PagedKVCache`); :func:`decode_qkv` and :func:`chunk_qkv` are the
write halves, :func:`attend_view` and :func:`attend_view_chunk` the read
halves over a slot's identity-mapped view of its blocks.  The
encoder-decoder's decoder attends over the encoder's output through
:func:`cross_attention`, its keys and values computed once by
:func:`encode_cross_kv`.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import attention as attn_op
from repro_torch.runtime.sharding import (
    local_heads,
    maybe_constrain,
    maybe_constrain_heads,
    maybe_whole_heads,
    write_cache_slot,
)

from .layers import Params, apply_rope, dense_init, matmul_f32


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    hd = cfg.hd
    p: Params = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype, device=device)
    return p


def _project_qkv(params: Params, x: torch.Tensor, cfg: ArchConfig):
    """(B, S, d) -> q (B, H, S, hd), k and v (B, Hkv, S, hd)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = maybe_whole_heads(q, cfg.n_heads).reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = maybe_whole_heads(k, cfg.n_kv_heads).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = maybe_whole_heads(v, cfg.n_kv_heads).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    # Pin batch->dp / heads->model (no-ops without a policy).
    return (maybe_constrain_heads(q, "q"), maybe_constrain_heads(k, "kv"),
            maybe_constrain_heads(v, "kv"))


def attention_train(
    params: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ArchConfig,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence attention (training forward and prefill) -> (B, S, d)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    if cfg.rope_theta > 0:
        pos = positions if positions is not None else torch.arange(s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = attn_op(
        q.contiguous(), k.contiguous(), v.contiguous(),
        causal=causal, window=cfg.sliding_window, impl=cfg.attn_impl,
        scale=cfg.attention_multiplier,
    )  # (B, H, S, hd)
    # Back to the residual stream's layout before the output projection
    # (a no-op without a policy): the query rows that context parallelism
    # split are gathered here.
    o = maybe_constrain(o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd))
    return o @ params["wo"]


def cross_attention(
    params: Params,
    x: torch.Tensor,  # (B, S, d) decoder stream
    kv: Tuple[torch.Tensor, torch.Tensor],  # encoder keys and values (B, Hkv, F, hd)
    cfg: ArchConfig,
) -> torch.Tensor:
    """Non-causal attention of the decoder's queries over the encoder's keys
    and values -> (B, S, d).  Unequal query and key lengths go to the plain
    blocked loop, as in the reference's dispatch."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.hd).transpose(1, 2)
    k, v = kv
    o = attn_op(q.contiguous(), k, v, causal=False, impl=cfg.attn_impl)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return o @ params["wo"]


def encode_cross_kv(params: Params, enc_out: torch.Tensor, cfg: ArchConfig):
    """Cross-attention keys and values of the encoder output (B, F, d), once
    -> k, v (B, Hkv, F, hd)."""
    b, f, _ = enc_out.shape
    k = (enc_out @ params["wk"]).reshape(b, f, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
    v = (enc_out @ params["wv"]).reshape(b, f, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
    return k.contiguous(), v.contiguous()


# ---------------------------------------------------------------------------
# Decode path (one new token per row against a KV cache)
# ---------------------------------------------------------------------------
class KVCache(NamedTuple):
    """Per-layer-stacked rolling KV cache.

    ``k``/``v``: (L, B, Hkv, W, hd) where W = min(seq_len, sliding_window).
    ``pos_buf``: (B, W) logical position stored in each physical slot of each
    row (-1 = empty), shared across layers.
    """

    k: torch.Tensor
    v: torch.Tensor
    pos_buf: torch.Tensor


def init_kv_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype, device,
                  n_entries: Optional[int] = None) -> KVCache:
    """``n_entries`` caches (default one a layer; the hybrid has one an
    invocation of its shared block)."""
    w = min(seq_len, cfg.sliding_window or seq_len)
    shape = (n_entries or cfg.n_layers, batch, cfg.n_kv_heads, w, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos_buf=torch.full((batch, w), -1, dtype=torch.int64, device=device),
    )


class PagedKVCache(NamedTuple):
    """Shared block-pool KV cache for paged decoding.

    ``k``/``v``: (L, n_block_rows, block_size, Hkv, hd).  Row 0 is a
    reserved scratch block: inactive slots' appends are routed there, so a
    stale slot never writes into blocks that live sequences own.  Slots map
    logical positions to pool rows through the block tables of
    ``lm.PagedDecodeState``.
    """

    k: torch.Tensor
    v: torch.Tensor


def init_paged_kv_cache(cfg: ArchConfig, n_block_rows: int, block_size: int, dtype,
                        device, n_layers: Optional[int] = None) -> PagedKVCache:
    """A pool for ``n_layers`` attention layers (default every layer)."""
    n = cfg.n_layers if n_layers is None else n_layers
    shape = (n, n_block_rows, block_size, cfg.n_kv_heads, cfg.hd)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def decode_qkv(params: Params, x: torch.Tensor, pos: torch.Tensor, cfg: ArchConfig):
    """Project + RoPE one decode position per row: x (B, 1, d), pos (B,) ->
    q (B, H, 1, hd), k and v (B, Hkv, 1, hd)."""
    q, k_new, v_new = _project_qkv(params, x, cfg)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    return q, k_new, v_new


def chunk_qkv(params: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """Project + RoPE a chunk of C positions: x (B, C, d), positions (C,) ->
    q (B, H, C, hd), k and v (B, Hkv, C, hd).

    Projections and RoPE act on each position alone, so position i's k and
    v are the values the per-token path writes there."""
    q, k_new, v_new = _project_qkv(params, x, cfg)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    return q, k_new, v_new


def _attend(params: Params, q: torch.Tensor, view_k: torch.Tensor, view_v: torch.Tensor,
            valid: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """q (B, H, C, hd) against keys and values (B, Hkv, W, hd) under
    ``valid`` (B, C, W) -> (B, C, d).  Scores accumulate the input values
    in fp32 with an fp32 result and no fp32 copy of the keys
    (:func:`~repro_torch.models.layers.matmul_f32`, the reference's
    ``preferred_element_type=float32``) and are scaled by
    ``cfg.attn_scale``; masked scores are -1e30."""
    return local_heads(partial(_read, cfg=cfg), q, view_k, view_v, valid) @ params["wo"]


def _read(q, view_k, view_v, valid, *, cfg: ArchConfig) -> torch.Tensor:
    """:func:`_attend` before the output projection -> (B, C, H * hd)."""
    b, h, c, hd = q.shape
    hkv, w = view_k.shape[1], view_k.shape[2]
    group = h // hkv
    qg = q.reshape(b * hkv, group * c, hd)
    kt = view_k.reshape(b * hkv, w, hd).transpose(1, 2)
    scores = matmul_f32(qg, kt).reshape(b, hkv, group, c, w) * cfg.attn_scale
    scores = torch.where(valid[:, None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p.to(view_v.dtype), view_v)
    return o.permute(0, 3, 1, 2, 4).reshape(b, c, h * hd)


def _valid(j: torch.Tensor, pos: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """A key at position ``j`` is visible from a query at ``pos``: ``j <=
    pos``, and inside the sliding window."""
    valid = j <= pos
    if cfg.sliding_window is not None:
        valid = valid & (j > pos - cfg.sliding_window)
    return valid


def attend_view(
    params: Params,
    q: torch.Tensor,  # (B, H, 1, hd) RoPE'd queries from decode_qkv
    view_k: torch.Tensor,  # (B, Hkv, W, hd) identity-mapped cache view
    view_v: torch.Tensor,
    pos: torch.Tensor,  # (B,) each row's position (already written at index pos)
    cfg: ArchConfig,
) -> torch.Tensor:
    """Attention read against an identity-mapped cache view -> (B, 1, d).

    The view's index is the logical position, so key j is valid where
    ``j <= pos``: element for element the mask :func:`attention_decode`
    derives from ``pos_buf`` while the cache never wraps."""
    j = torch.arange(view_k.shape[2], device=q.device)
    return _attend(params, q, view_k, view_v, _valid(j, pos[:, None, None], cfg), cfg)


def attend_view_chunk(
    params: Params,
    q: torch.Tensor,  # (B, H, C, hd) RoPE'd queries from chunk_qkv
    view_k: torch.Tensor,  # (B, Hkv, W, hd) identity-mapped cache view
    view_v: torch.Tensor,
    positions: torch.Tensor,  # (C,): query i sits at positions[i]
    cfg: ArchConfig,
) -> torch.Tensor:
    """Multi-query attention over an identity-mapped view -> (B, C, d).

    Query i applies :func:`attend_view`'s rule at ``positions[i]``: the
    chunk's own keys are already in the view, later positions masked."""
    j = torch.arange(view_k.shape[2], device=q.device)
    return _attend(params, q, view_k, view_v, _valid(j, positions[None, :, None], cfg), cfg)


def attention_decode(
    params: Params,
    x: torch.Tensor,  # (B, 1, d)
    layer_k: torch.Tensor,  # (B, Hkv, W, hd) this layer's cache
    layer_v: torch.Tensor,
    pos_buf: torch.Tensor,  # (B, W)
    pos: torch.Tensor,  # (B,) current position of each row
    cfg: ArchConfig,
):
    """Returns (out (B, 1, d), layer_k, layer_v, pos_buf); the cache and
    ``pos_buf`` are written in place at slot ``pos % W`` of each row."""
    b = x.shape[0]
    w = layer_k.shape[2]
    q, k_new, v_new = decode_qkv(params, x, pos, cfg)

    rows = torch.arange(b, device=x.device)
    slot = torch.remainder(pos, w)
    write_cache_slot(layer_k, slot, k_new[:, :, 0], rows)
    write_cache_slot(layer_v, slot, v_new[:, :, 0], rows)
    write_cache_slot(pos_buf, slot, pos, rows)

    valid = (pos_buf >= 0) & _valid(pos_buf, pos[:, None], cfg)  # (B, W)
    out = _attend(params, q, layer_k, layer_v, valid[:, None, :], cfg)
    return out, layer_k, layer_v, pos_buf
