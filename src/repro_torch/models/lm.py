"""Decoder-only LM of the dense family: parameters, forward, prefill and
decode.

The reference's ``models/lm.py`` for one card: a Python loop over a list of
per-layer parameter dicts where the reference scans a stacked tree, no
remat and no sharding constraints.  The decode state carries one position
per batch row (see :mod:`repro_torch.models.attention`), so the
continuous-batching pool is simply a batch of rows.  The paged functions
keep one block pool for every slot and per-slot block tables, all on the
device, so a CUDA graph captured over them reads each slot's blocks at
replay.  The MoE, SSM, hybrid and VLM branches are not ported (ROADMAP
Queue 1 item 8): :class:`~repro_torch.configs.base.ArchConfig` refuses
those families, and the training loss waits with item 9.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import NOT_TRAINED, ArchConfig

from .attention import (
    KVCache,
    PagedKVCache,
    attend_view,
    attend_view_chunk,
    attention_decode,
    attention_train,
    chunk_qkv,
    decode_qkv,
    init_attention,
    init_kv_cache,
    init_paged_kv_cache,
)
from .layers import Params, dense_init, dtype_of, embed_init, init_mlp, mlp, rmsnorm, unembed


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _init_block(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_attention(gen, cfg, dtype, device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig, device="cuda") -> Params:
    """Random parameters from ``gen``: ``{"blocks": [per-layer dict, ...],
    "embed", "ln_f"[, "unembed"]}`` with the reference's leaf names."""
    dtype = dtype_of(cfg.param_dtype)
    params: Params = {"blocks": [_init_block(gen, cfg, dtype, device) for _ in range(cfg.n_layers)]}
    params["embed"] = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    params["ln_f"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype, device)
    return params


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------
def _apply_block(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = x + attention_train(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg)
    return x + mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.mlp)


def _head(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and (tied or separate) unembedding -> fp32 logits."""
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(x, params["embed"])
    return x.float() @ params["unembed"].float()


def _trunk(params: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding and every block -> the final residual stream (B, S, d)."""
    x = params["embed"][tokens].to(dtype_of(cfg.compute_dtype))
    for p in params["blocks"]:
        x = _apply_block(p, x, cfg)
    return x


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """-> logits (B, S, V) in fp32, every position."""
    return _head(params, cfg, _trunk(params, cfg, batch["tokens"]))


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward -> last-position logits (B, 1, V).

    The head runs on the last position only: the logits of every position
    would take 19.9 GB a sequence at 32k tokens and qwen2's vocabulary."""
    return _head(params, cfg, _trunk(params, cfg, batch["tokens"])[:, -1:])


# ---------------------------------------------------------------------------
# Serving: decode
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    """What a decode step carries between tokens: the KV cache and each
    row's next position ``pos`` (B,)."""

    kv: KVCache
    pos: torch.Tensor


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, device="cuda") -> DecodeState:
    kv = init_kv_cache(cfg, batch, seq_len, dtype_of(cfg.compute_dtype), device)
    return DecodeState(kv=kv, pos=torch.zeros((batch,), dtype=torch.int64, device=device))


def decode_step(
    params: Params,
    cfg: ArchConfig,
    state: DecodeState,
    tokens: torch.Tensor,  # (B, 1)
) -> Tuple[torch.Tensor, DecodeState]:
    """One token for every row -> (logits (B, 1, V), state).  The cache in
    ``state`` is updated in place."""
    x = params["embed"][tokens].to(dtype_of(cfg.compute_dtype))
    pos = state.pos
    kv = state.kv
    pos_buf = kv.pos_buf
    for layer, p in enumerate(params["blocks"]):
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        o, _, _, pos_buf = attention_decode(p["attn"], h, kv.k[layer], kv.v[layer], pos_buf, pos, cfg)
        x = x + o
        x = x + mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.mlp)
    return _head(params, cfg, x), DecodeState(kv=KVCache(kv.k, kv.v, pos_buf), pos=pos + 1)


def prefill_state(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,  # (B, S) prompt
    cache_len: int,
) -> Tuple[torch.Tensor, DecodeState]:
    """Prefill that also yields the decode state -> (last logits (B, 1, V),
    state): :func:`decode_step` over the prompt positions, as the
    reference's scan."""
    state = init_decode_state(cfg, tokens.shape[0], cache_len, tokens.device)
    logits = None
    for t in range(tokens.shape[1]):
        logits, state = decode_step(params, cfg, state, tokens[:, t : t + 1])
    return logits, state


# ---------------------------------------------------------------------------
# Continuous batching: a pool of slots is a batch of rows
# ---------------------------------------------------------------------------
def pool_decode_state(cfg: ArchConfig, n_slots: int, cache_len: int, device="cuda") -> DecodeState:
    """Decode state for a continuous-batching pool: one row per slot, each
    with its own position."""
    return init_decode_state(cfg, n_slots, cache_len, device)


def slot_insert(pool_state: DecodeState, seq_state: DecodeState, slot: int) -> DecodeState:
    """Write one sequence's B = 1 decode state into pool row ``slot`` (in
    place)."""
    pool_state.kv.k[:, slot] = seq_state.kv.k[:, 0]
    pool_state.kv.v[:, slot] = seq_state.kv.v[:, 0]
    pool_state.kv.pos_buf[slot] = seq_state.kv.pos_buf[0]
    pool_state.pos[slot] = seq_state.pos[0]
    return pool_state


def slot_evict(pool_state: DecodeState, cfg: ArchConfig, cache_len: int, slot: int) -> DecodeState:
    """Reset pool row ``slot`` to the empty state (in place).

    Hygiene only: a freed slot's stale rows are never read (its feed token
    is a dummy and its output is discarded until the next insert overwrites
    the row), so pools may skip eviction."""
    empty = init_decode_state(cfg, 1, cache_len, pool_state.pos.device)
    return slot_insert(pool_state, empty, slot)


# ---------------------------------------------------------------------------
# Paged decoding: one shared KV block pool and per-slot block tables
# ---------------------------------------------------------------------------
class PagedDecodeState(NamedTuple):
    """Pool-wide decode state for paged continuous batching.

    ``kv``: the shared :class:`PagedKVCache` block pool.
    ``tables``: (n_slots, max_blocks) int64 pool rows of each slot;
    unleased entries point at the scratch row 0 and are only read at
    positions that ``pos`` masks out.
    ``pos``: (n_slots,) int64 position of each slot.
    """

    kv: PagedKVCache
    tables: torch.Tensor
    pos: torch.Tensor


def check_paged_support(cfg: ArchConfig, cache_len: int) -> None:
    """Raise if ``cfg`` cannot serve through the paged path.

    A slot's view is a never-wrapping identity map of its positions, so the
    slab cache it stands in for must never wrap either: a sliding window
    shorter than ``cache_len`` makes the slab cache a ring whose layout
    (and summation order) differs."""
    if cfg.sliding_window is not None and cfg.sliding_window < cache_len:
        raise ValueError(
            f"paged decoding requires sliding_window >= cache_len "
            f"({cfg.sliding_window} < {cache_len}): the slab reference wraps"
        )


def init_paged_state(
    cfg: ArchConfig,
    n_slots: int,
    n_block_rows: int,
    block_size: int,
    max_blocks: int,
    cache_len: int,
    device="cuda",
) -> PagedDecodeState:
    check_paged_support(cfg, cache_len)
    kv = init_paged_kv_cache(cfg, n_block_rows, block_size, dtype_of(cfg.compute_dtype), device)
    return PagedDecodeState(
        kv=kv,
        tables=torch.zeros((n_slots, max_blocks), dtype=torch.int64, device=device),
        pos=torch.zeros((n_slots,), dtype=torch.int64, device=device),
    )


def _lm_head_token(params: Params, cfg: ArchConfig, x: torch.Tensor):
    """(B, S, d) final residual -> (greedy ids (B,), fp32 logits (B, 1, V))
    of the last position."""
    logits = _head(params, cfg, x[:, -1:])
    return torch.argmax(logits[:, -1], dim=-1), logits


def _view(pool: torch.Tensor, tables: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Gather each table row's blocks from one layer's pool (R, bs, Hkv, hd)
    into an identity-position view (n, Hkv, cache_len, hd)."""
    n, max_blocks = tables.shape
    _, bs, hkv, hd = pool.shape
    view = pool[tables].reshape(n, max_blocks * bs, hkv, hd)
    return view[:, :cache_len].transpose(1, 2)


def paged_decode_step(
    params: Params,
    cfg: ArchConfig,
    state: PagedDecodeState,
    tokens: torch.Tensor,  # (n_slots,) feed token of each slot
    active: torch.Tensor,  # (n_slots,) bool: False slots neither write nor advance
    cache_len: int,
):
    """One decode step for every active slot -> (state, ids (n_slots,),
    logits (n_slots, 1, V)).

    Each slot's token is appended to its block at ``pos // block_size`` (the
    scratch row 0 for inactive slots) with one scatter a layer, then each
    slot attends over the gather of its table rows.  Everything is computed
    from the state's tensors, so a graph captured over this step reads the
    tables and positions as they are at replay.  The block pool is updated
    in place; the returned state carries the new positions."""
    n = tokens.shape[0]
    pos = state.pos
    kv = state.kv
    bs = kv.k.shape[2]
    slots = torch.arange(n, device=pos.device)
    # A slot evicted at the end of its cache sits at pos == cache_len, one
    # block past its table; it is inactive, so any in-range entry will do.
    last = torch.clamp(pos // bs, max=state.tables.shape[1] - 1)
    blk = torch.where(active, state.tables[slots, last], 0)
    off = pos % bs
    x = params["embed"][tokens.reshape(n, 1)].to(dtype_of(cfg.compute_dtype))
    for layer, p in enumerate(params["blocks"]):
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k_new, v_new = decode_qkv(p["attn"], h, pos, cfg)  # k_new (n, Hkv, 1, hd)
        kv.k[layer][blk, off] = k_new[:, :, 0]
        kv.v[layer][blk, off] = v_new[:, :, 0]
        vk = _view(kv.k[layer], state.tables, cache_len)
        vv = _view(kv.v[layer], state.tables, cache_len)
        x = x + attend_view(p["attn"], q, vk, vv, pos, cfg)
        x = x + mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.mlp)
    ids, logits = _lm_head_token(params, cfg, x)
    return state._replace(pos=pos + active.to(pos.dtype)), ids, logits


def paged_prefill_chunk(
    params: Params,
    cfg: ArchConfig,
    state: PagedDecodeState,
    slot: torch.Tensor,  # 0-d int64
    tokens: torch.Tensor,  # (C,) a chunk of the prompt
    start_pos: torch.Tensor,  # 0-d int64 position of tokens[0]
    cache_len: int,
):
    """Feed one slot a chunk of C positions -> (state, id (1,), logits
    (1, 1, V)) of the chunk's last position.

    The chunk is one batched pass a layer: all C positions projected and
    RoPE'd at once, written into the slot's blocks with one scatter, and
    attended under :func:`attend_view_chunk`'s causal mask.  The head runs
    on the last position only.  ``slot`` and ``start_pos`` are tensors, so
    a graph captured over this function serves every slot and offset."""
    kv = state.kv
    bs = kv.k.shape[2]
    row = state.tables[slot.reshape(1)]  # (1, max_blocks)
    c = tokens.shape[0]
    positions = start_pos + torch.arange(c, device=tokens.device)
    blks = row[0, positions // bs]
    offs = positions % bs
    x = params["embed"][tokens[None, :]].to(dtype_of(cfg.compute_dtype))  # (1, C, d)
    for layer, p in enumerate(params["blocks"]):
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k_new, v_new = chunk_qkv(p["attn"], h, positions, cfg)  # k_new (1, Hkv, C, hd)
        kv.k[layer][blks, offs] = k_new[0].transpose(0, 1)
        kv.v[layer][blks, offs] = v_new[0].transpose(0, 1)
        vk = _view(kv.k[layer], row, cache_len)
        vv = _view(kv.v[layer], row, cache_len)
        x = x + attend_view_chunk(p["attn"], q, vk, vv, positions, cfg)
        x = x + mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.mlp)
    ids, logits = _lm_head_token(params, cfg, x)
    pos = state.pos.scatter(0, slot.reshape(1), (start_pos + c).reshape(1))
    return state._replace(pos=pos), ids, logits


def paged_reset_slot(state: PagedDecodeState, slot: int,
                     row: Union[np.ndarray, torch.Tensor]) -> PagedDecodeState:
    """Point ``slot`` at block-table ``row`` and rewind it to position 0 (in
    place).  The blocks are not cleared: the ``j <= pos`` rule masks stale
    entries until they are overwritten in order."""
    state.tables[slot] = torch.as_tensor(row, dtype=torch.int64).to(state.tables.device)
    state.pos[slot] = 0
    return state


# The reference's training loss, not ported yet.
_REFERENCE_ONLY = ("lm_loss",)


def __getattr__(name: str):
    if name in _REFERENCE_ONLY:
        raise NotImplementedError(f"lm.{name}: {NOT_TRAINED}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
