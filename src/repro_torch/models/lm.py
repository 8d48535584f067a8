"""Decoder-only LM of the dense, MoE, SSM, hybrid and VLM families:
parameters, forward, prefill and decode.

The reference's ``models/lm.py``: a Python loop over a list of per-layer
parameter dicts where the reference scans a stacked tree, with the
reference's sharding hooks (no-ops without a policy; under one, each
block gathers its FSDP-split weights).  Under ``cfg.remat`` the training loss
(:func:`lm_loss`) recomputes each block's activations in the backward
pass, the hybrid's groups as a whole too, as the reference's
``jax.checkpoint``s.  The hybrid (zamba2) keeps its Mamba2
blocks in one list too (the reference's ``blocks`` groups, then
``blocks_tail``) and applies the single parameter-tied ``shared`` attention
block after layers ``every - 1``, ``2 every - 1``, ..., each invocation with
a KV cache of its own.  The layered hybrid (granite-4.0-h, ``layer_types``)
has a mixer in each layer, Mamba2 or attention, each followed by the FFN,
with Granite's multipliers on the embedding, the residual branches and the
logits; its decode state holds KV for its attention layers and SSM state
for its Mamba2 layers only.  An MoE block calls the MoE FFN where a dense
block calls its MLP.  The VLM (llava) is the dense model with a ``projector``
that maps precomputed patch embeddings (B, n_patches, d_vision) into the
stream in front of the tokens (:func:`_embed_inputs`); it serves text
only, as the reference does.

The decode state carries one position per batch row (see
:mod:`repro_torch.models.attention`), so the continuous-batching pool is
simply a batch of rows; the KV cache and the recurrent SSM state are
written in place, so a CUDA graph captured over a step reads and writes
them as they are at replay.  The paged functions keep one block pool for
every slot and per-slot block tables, all on the device; for the SSM
family a "paged" pool is the slot-stacked recurrent state with no blocks;
the layered hybrid's pool is both, blocks for its attention layers beside
slot state for its mixers, and zamba2's caches are refused there, as in
the reference.  The encoder-decoder family is
:mod:`repro_torch.models.encdec`.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.runtime.sharding import (
    gather_params,
    lookup,
    maybe_constrain,
    maybe_constrain_logits,
)

from . import moe
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
from .layers import (
    Params,
    cross_entropy_loss,
    dense_init,
    dtype_of,
    embed_init,
    gelu,
    init_mlp,
    matmul_f32,
    mlp,
    remat_call,
    rmsnorm,
    unembed,
)
from .ssm import init_mamba, mamba_block, mamba_decode_step

MAMBA_FAMILIES = ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _init_attn_block(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    p: Params = {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_attention(gen, cfg, dtype, device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if cfg.moe is not None:
        p["moe"] = moe.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device)
    return p


def _init_mamba_block(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mamba": init_mamba(gen, cfg, dtype, device),
    }


def _init_layered_block(gen: torch.Generator, cfg: ArchConfig, kind: str, dtype,
                        device) -> Params:
    """A layer of the layered hybrid: its mixer (``mamba`` or ``attn``),
    then the FFN, each behind a norm."""
    if kind == "attention":
        return _init_attn_block(gen, cfg, dtype, device)
    p = _init_mamba_block(gen, cfg, dtype, device)
    p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    if cfg.moe is not None:
        p["moe"] = moe.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, device="cuda") -> Params:
    """Random parameters from ``gen``: ``{"blocks": [per-layer dict, ...],
    "embed", "ln_f"[, "unembed"][, "shared"][, "projector"]}`` with the
    reference's leaf names; ``device="meta"`` gives the shapes only."""
    dtype = dtype_of(cfg.param_dtype)
    if cfg.layer_types is not None:
        blocks = [_init_layered_block(gen, cfg, kind, dtype, device) for kind in cfg.layer_types]
    else:
        block = _init_mamba_block if cfg.family in MAMBA_FAMILIES else _init_attn_block
        blocks = [block(gen, cfg, dtype, device) for _ in range(cfg.n_layers)]
    params: Params = {"blocks": blocks}
    if cfg.shared_attn_every:
        # Zamba2's shared block: full-width attention and MLP, one set of
        # tensors used at every invocation.
        params["shared"] = _init_attn_block(gen, cfg, dtype, device)
    params["embed"] = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    params["ln_f"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype, device)
    if cfg.family == "vlm":
        params["projector"] = {
            "w1": dense_init(gen, cfg.d_vision, cfg.d_model, dtype, device),
            "w2": dense_init(gen, cfg.d_model, cfg.d_model, dtype, device),
        }
    return params


def param_count(params: Params) -> int:
    """Elements of every leaf (the shared block counted once)."""

    def count(node) -> int:
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        if isinstance(node, list):
            return sum(count(v) for v in node)
        return node.numel()

    return count(params)


def _mixer_index(cfg: ArchConfig) -> List[int]:
    """Each layer's index among the layers of its mixer kind: where its KV
    (attention) or its SSM state (Mamba2) sits in the decode state."""
    seen: Dict[str, int] = {}
    out = []
    for kind in cfg.mixers():
        out.append(seen.get(kind, 0))
        seen[kind] = out[-1] + 1
    return out


def _n_mixers(cfg: ArchConfig, kind: str) -> int:
    return sum(k == kind for k in cfg.mixers())


def _shared_invocation(cfg: ArchConfig, layer: int) -> Optional[int]:
    """Which invocation of the hybrid's shared block follows ``layer``, if
    any: after every ``shared_attn_every``-th block; the tail has none."""
    every = cfg.shared_attn_every
    if every and (layer + 1) % every == 0:
        return (layer + 1) // every - 1
    return None


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------
def _ffn(p: Params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.moe is not None:
        return moe.moe_ffn(p["moe"], h, cfg.moe)
    return mlp(p["mlp"], h, cfg.mlp)


def _residual(x: torch.Tensor, o: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``x + residual_multiplier * o`` (the product left out at 1)."""
    m = cfg.residual_multiplier
    return x + (o if m == 1.0 else o * m)


def _scale_embed(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def _layered_block(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """A layer of the layered hybrid over the whole sequence:
    ``h = x + m mixer(norm1(x))``, ``h + m ffn(norm2(h))``."""
    p = gather_params(p)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    o = mamba_block(p["mamba"], h, cfg) if "mamba" in p else attention_train(p["attn"], h, cfg)
    x = _residual(x, o, cfg)
    return _residual(x, _ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg), cfg)


def _apply_attn_block(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    p = gather_params(p)
    x = x + attention_train(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg)
    return x + _ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)


def _head(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and (tied or separate) unembedding -> fp32 logits, with no
    fp32 copy of the (un)embedding (:func:`matmul_f32`), divided by
    ``logits_scaling``."""
    params = gather_params({k: params[k] for k in ("ln_f", "embed", "unembed") if k in params})
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(x, params["embed"])
    else:
        logits = matmul_f32(x, params["unembed"])
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return maybe_constrain_logits(logits)


def _embed_inputs(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    """Tokens, and for the VLM the projected patch embeddings in front of
    them -> the (B, S, d) stream in the compute dtype."""
    params = gather_params({k: params[k] for k in ("embed", "projector") if k in params})
    parts = []
    if cfg.family == "vlm" and "patches" in batch:
        pr = params["projector"]
        parts.append(gelu(batch["patches"].to(pr["w1"].dtype) @ pr["w1"]) @ pr["w2"])
    if "tokens" in batch:
        parts.append(lookup(params["embed"], batch["tokens"]))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return _scale_embed(x.to(dtype_of(cfg.compute_dtype)), cfg)


def _block(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.layer_types is not None:
        return _layered_block(p, x, cfg)
    if cfg.family in MAMBA_FAMILIES:
        p = gather_params(p)
        return x + mamba_block(p["mamba"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg)
    return _apply_attn_block(p, x, cfg)


def _group(blocks, shared: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The hybrid's group: ``shared_attn_every`` blocks, then the shared
    block."""
    for p in blocks:
        x = maybe_constrain(remat_call(cfg, _block, p, x, cfg))
    return _apply_attn_block(shared, x, cfg)


def _trunk(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Every block over the embedded stream -> the final residual stream
    (B, S, d).  The hybrid runs its groups, then the tail blocks that
    complete no group (the shared block follows layers ``every - 1``,
    ``2 every - 1``, ...)."""
    x = maybe_constrain(x)
    blocks = params["blocks"]
    every = cfg.shared_attn_every
    if every:
        n_grouped = len(blocks) // every * every
        for g in range(0, n_grouped, every):
            x = remat_call(cfg, _group, blocks[g : g + every], params["shared"], x, cfg)
        blocks = blocks[n_grouped:]
    for p in blocks:
        x = maybe_constrain(remat_call(cfg, _block, p, x, cfg))
    return x


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """-> logits (B, S, V) in fp32, every position (the VLM's patches
    first)."""
    return _head(params, cfg, _trunk(params, cfg, _embed_inputs(params, cfg, batch)))


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward -> last-position logits (B, 1, V).

    The head runs on the last position only: the logits of every position
    would take 19.9 GB a sequence at 32k tokens and qwen2's vocabulary."""
    x = _trunk(params, cfg, _embed_inputs(params, cfg, batch))
    return _head(params, cfg, x[:, -1:])


def lm_loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross entropy at ``batch["labels"]``; the VLM's
    patches carry no labels, so the head runs on the text positions only.
    The MoE family adds 0.01 times the load-balancing loss of the first
    block's router on the embedded inputs (the reference's one-layer
    proxy)."""
    x = _trunk(params, cfg, _embed_inputs(params, cfg, batch))
    labels = batch["labels"]
    loss = cross_entropy_loss(_head(params, cfg, x[:, x.shape[1] - labels.shape[1]:]), labels)
    if cfg.family == "moe":
        x0 = _embed_inputs(params, cfg, batch)
        loss = loss + 0.01 * moe.aux_load_balance_loss(params["blocks"][0]["moe"], x0, cfg.moe)
    return loss


# ---------------------------------------------------------------------------
# Serving: decode
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    """What a decode step carries between tokens: the KV cache (None for the
    SSM family), each row's next position ``pos`` (B,), and for the SSM and
    hybrid families the recurrent state ``ssm_h`` (L, B, H, P, N) in fp32
    and the rolling conv input ``ssm_conv`` (L, B, K-1, conv_dim) in the
    compute dtype (None otherwise).  The layered hybrid's KV holds its
    attention layers and its ``ssm_*`` its Mamba2 layers, each in layer
    order (:func:`_mixer_index`)."""

    kv: Optional[KVCache]
    pos: torch.Tensor
    ssm_h: Optional[torch.Tensor] = None
    ssm_conv: Optional[torch.Tensor] = None


def _init_ssm_state(cfg: ArchConfig, batch: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero recurrent state and conv window of every Mamba2 layer."""
    ssm = cfg.ssm
    n = _n_mixers(cfg, "mamba")
    h = ssm.n_heads(cfg.d_model)
    ssm_h = torch.zeros((n, batch, h, ssm.head_dim, ssm.d_state), dtype=torch.float32,
                        device=device)
    conv_dim = ssm.d_inner(cfg.d_model) + 2 * ssm.d_state
    ssm_conv = torch.zeros((n, batch, ssm.d_conv - 1, conv_dim),
                           dtype=dtype_of(cfg.compute_dtype), device=device)
    return ssm_h, ssm_conv


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, device="cuda") -> DecodeState:
    dtype = dtype_of(cfg.compute_dtype)
    pos = torch.zeros((batch,), dtype=torch.int64, device=device)
    kv = ssm_h = ssm_conv = None
    if cfg.family != "ssm":
        if cfg.shared_attn_every:
            n_entries = cfg.n_layers // cfg.shared_attn_every
        elif cfg.layer_types is not None:
            n_entries = _n_mixers(cfg, "attention")
        else:
            n_entries = None
        kv = init_kv_cache(cfg, batch, seq_len, dtype, device, n_entries)
    if cfg.family in MAMBA_FAMILIES:
        ssm_h, ssm_conv = _init_ssm_state(cfg, batch, device)
    return DecodeState(kv=kv, pos=pos, ssm_h=ssm_h, ssm_conv=ssm_conv)


def _attn_block_decode(p: Params, x, kv: KVCache, entry: int, pos_buf, pos, cfg: ArchConfig):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    o, _, _, pos_buf = attention_decode(p["attn"], h, kv.k[entry], kv.v[entry], pos_buf, pos, cfg)
    x = _residual(x, o, cfg)
    return _residual(x, _ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg), cfg), pos_buf


def _mamba_decode(p: Params, x, ssm_h: torch.Tensor, ssm_conv: torch.Tensor, cfg: ArchConfig,
                  active: Optional[torch.Tensor]) -> torch.Tensor:
    """One token a row through a Mamba2 mixer -> its output (B, 1, d); the
    layer's state ``ssm_h`` (B, H, P, N) and ``ssm_conv`` are written in
    place, except where ``active`` (B,) is False."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    o, new_h, new_conv = mamba_decode_step(p["mamba"], h, ssm_h, ssm_conv, cfg)
    if active is not None:
        new_h = torch.where(active[:, None, None, None], new_h, ssm_h)
        new_conv = torch.where(active[:, None, None], new_conv, ssm_conv)
    ssm_h.copy_(new_h)
    ssm_conv.copy_(new_conv)
    return o


def _decode_trunk(params: Params, cfg: ArchConfig, state: DecodeState, tokens: torch.Tensor,
                  active: Optional[torch.Tensor] = None):
    """One token a row through every block -> (final residual (B, 1, d),
    pos_buf).  Caches and recurrent state are written in place; where
    ``active`` (B,) is False a row's recurrent state keeps its old value
    (the recurrence has no scratch row to absorb a dummy feed)."""
    x = _scale_embed(lookup(params["embed"], tokens).to(dtype_of(cfg.compute_dtype)), cfg)
    pos = state.pos
    kv = state.kv
    pos_buf = kv.pos_buf if kv is not None else None
    index = _mixer_index(cfg)
    for layer, p in enumerate(params["blocks"]):
        j = index[layer]
        if cfg.layer_types is not None:
            if "mamba" in p:
                x = _residual(x, _mamba_decode(p, x, state.ssm_h[j], state.ssm_conv[j], cfg,
                                               active), cfg)
                x = _residual(x, _ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg), cfg)
            else:
                x, pos_buf = _attn_block_decode(p, x, kv, j, pos_buf, pos, cfg)
        elif cfg.family in MAMBA_FAMILIES:
            x = x + _mamba_decode(p, x, state.ssm_h[layer], state.ssm_conv[layer], cfg, active)
            entry = _shared_invocation(cfg, layer)
            if entry is not None:
                x, pos_buf = _attn_block_decode(params["shared"], x, kv, entry, pos_buf, pos, cfg)
        else:
            x, pos_buf = _attn_block_decode(p, x, kv, layer, pos_buf, pos, cfg)
    return x, pos_buf


def decode_step(
    params: Params,
    cfg: ArchConfig,
    state: DecodeState,
    tokens: torch.Tensor,  # (B, 1)
) -> Tuple[torch.Tensor, DecodeState]:
    """One token for every row -> (logits (B, 1, V), state).  The cache and
    recurrent state in ``state`` are updated in place."""
    x, pos_buf = _decode_trunk(params, cfg, state, tokens)
    kv = state.kv if state.kv is None else KVCache(state.kv.k, state.kv.v, pos_buf)
    return _head(params, cfg, x), state._replace(kv=kv, pos=state.pos + 1)


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
    place): caches, recurrent state and position."""
    if pool_state.kv is not None:
        pool_state.kv.k[:, slot] = seq_state.kv.k[:, 0]
        pool_state.kv.v[:, slot] = seq_state.kv.v[:, 0]
        pool_state.kv.pos_buf[slot] = seq_state.kv.pos_buf[0]
    if pool_state.ssm_h is not None:
        pool_state.ssm_h[:, slot] = seq_state.ssm_h[:, 0]
        pool_state.ssm_conv[:, slot] = seq_state.ssm_conv[:, 0]
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

    ``kv``: the shared :class:`PagedKVCache` block pool (None for ssm).
    ``tables``: (n_slots, max_blocks) int64 pool rows of each slot;
    unleased entries point at the scratch row 0 and are only read at
    positions that ``pos`` masks out (None for ssm).
    ``pos``: (n_slots,) int64 position of each slot.
    ``ssm_h`` / ``ssm_conv``: for ssm, the recurrent state of every slot,
    (L, n_slots, H, P, N) and (L, n_slots, K-1, conv_dim) (the reference
    stacks (n_slots, L, 1, ...)).  An SSM sequence's state is O(1), so its
    pool holds no blocks: "paged" is the slot state plus chunked prefill.
    The layered hybrid has both: ``kv`` for its attention layers and
    ``ssm_*`` for its Mamba2 layers (:func:`_mixer_index`).
    """

    kv: Optional[PagedKVCache]
    tables: Optional[torch.Tensor]
    pos: torch.Tensor
    ssm_h: Optional[torch.Tensor] = None
    ssm_conv: Optional[torch.Tensor] = None


def check_paged_support(cfg: ArchConfig, cache_len: int) -> None:
    """Raise if ``cfg`` cannot serve through the paged path.

    The dense, MoE, VLM and SSM families and the layered hybrid
    (``layer_types``: KV blocks for its attention layers, slot state for
    its mixers) serve there.  zamba2's shared attention block keeps one
    cache an invocation and the encoder-decoder a cross-attention cache
    beside its own: neither is block-structured, and both are refused with
    the reference's message, which names their families.  A slot's view is a
    never-wrapping identity map of its positions, so the slab cache it
    stands in for must never wrap either: a sliding window shorter than
    ``cache_len`` makes the slab cache a ring whose layout (and summation
    order) differs."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm") and cfg.layer_types is None:
        raise ValueError(
            f"paged decoding unsupported for family {cfg.family!r} "
            "(hybrid/encdec caches are not block-structured)"
        )
    if cfg.family != "ssm" and cfg.sliding_window is not None and cfg.sliding_window < cache_len:
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
    pos = torch.zeros((n_slots,), dtype=torch.int64, device=device)
    if cfg.family == "ssm":
        rows = init_decode_state(cfg, n_slots, cache_len, device)
        return PagedDecodeState(kv=None, tables=None, pos=pos, ssm_h=rows.ssm_h,
                                ssm_conv=rows.ssm_conv)
    kv = init_paged_kv_cache(cfg, n_block_rows, block_size, dtype_of(cfg.compute_dtype), device,
                             _n_mixers(cfg, "attention"))
    ssm_h = ssm_conv = None
    if cfg.layer_types is not None:
        ssm_h, ssm_conv = _init_ssm_state(cfg, n_slots, device)
    return PagedDecodeState(
        kv=kv,
        tables=torch.zeros((n_slots, max_blocks), dtype=torch.int64, device=device),
        pos=pos,
        ssm_h=ssm_h,
        ssm_conv=ssm_conv,
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
    tables and positions as they are at replay.  The block pool (for ssm
    and the layered hybrid's mixers, the active slots' recurrent state) is
    updated in place; the returned state carries the new positions."""
    n = tokens.shape[0]
    pos = state.pos
    new_pos = pos + active.to(pos.dtype)
    if cfg.family == "ssm":
        rows = DecodeState(kv=None, pos=pos, ssm_h=state.ssm_h, ssm_conv=state.ssm_conv)
        x, _ = _decode_trunk(params, cfg, rows, tokens.reshape(n, 1), active)
        ids, logits = _lm_head_token(params, cfg, x)
        return state._replace(pos=new_pos), ids, logits
    kv = state.kv
    bs = kv.k.shape[2]
    slots = torch.arange(n, device=pos.device)
    # A slot evicted at the end of its cache sits at pos == cache_len, one
    # block past its table; it is inactive, so any in-range entry will do.
    last = torch.clamp(pos // bs, max=state.tables.shape[1] - 1)
    blk = torch.where(active, state.tables[slots, last], 0)
    off = pos % bs
    x = _scale_embed(params["embed"][tokens.reshape(n, 1)].to(dtype_of(cfg.compute_dtype)), cfg)
    index = _mixer_index(cfg)
    for layer, p in enumerate(params["blocks"]):
        j = index[layer]
        if "mamba" in p:
            o = _mamba_decode(p, x, state.ssm_h[j], state.ssm_conv[j], cfg, active)
        else:
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            q, k_new, v_new = decode_qkv(p["attn"], h, pos, cfg)  # k_new (n, Hkv, 1, hd)
            kv.k[j][blk, off] = k_new[:, :, 0]
            kv.v[j][blk, off] = v_new[:, :, 0]
            vk = _view(kv.k[j], state.tables, cache_len)
            vv = _view(kv.v[j], state.tables, cache_len)
            o = attend_view(p["attn"], q, vk, vv, pos, cfg)
        x = _residual(x, o, cfg)
        x = _residual(x, _ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg), cfg)
    ids, logits = _lm_head_token(params, cfg, x)
    return state._replace(pos=new_pos), ids, logits


def paged_prefill_chunk(
    params: Params,
    cfg: ArchConfig,
    state: PagedDecodeState,
    slot: torch.Tensor,  # 0-d int64
    tokens: torch.Tensor,  # (C,) a chunk of the prompt
    start_pos: torch.Tensor,  # 0-d int64 position of tokens[0]
    cache_len: int,
    n_real: Optional[torch.Tensor] = None,  # 0-d int64: tokens[n_real:] are padding
):
    """Feed one slot a chunk of C positions -> (state, id (1,), logits
    (1, 1, V)) of the chunk's last real position.

    For KV families the chunk is one batched pass a layer: all C positions
    projected and RoPE'd at once, written into the slot's blocks with one
    scatter, and attended under :func:`attend_view_chunk`'s causal mask (an
    MoE layer routes the chunk as one sequence, so its capacity follows C).
    The layered hybrid's Mamba2 layers run the chunked scan over the whole
    chunk from the slot's state and conv window (:func:`mamba_block`) and
    write back the state at its end.  The SSM family steps the slot's
    recurrent state through the C tokens one by one (the recurrence is
    sequential).  The head runs on the last real position only.

    With ``n_real``, positions from ``n_real`` on are padding (KV and
    hybrid families): their keys and values go to the scratch row 0, they
    take dt = 0 in the mixers, so no recurrent state moves, the conv window
    is the one the real positions leave, and the slot advances by
    ``n_real``.  No real position reads a padded one, and in the MoE a
    padded pair ranks after every real pair of its expert, so the real
    positions' outputs are those of the unpadded chunk.  ``slot``,
    ``start_pos`` and ``n_real`` are tensors, so a graph captured over this
    function serves every slot, offset and fill of its length."""
    c = tokens.shape[0]
    idx = slot.reshape(1)
    fed = c if n_real is None else n_real
    pos = state.pos.scatter(0, idx, (start_pos + fed).reshape(1))
    if cfg.family == "ssm":
        if n_real is not None:
            raise ValueError("the SSM family's chunk steps its tokens one by one: no padding")
        row = DecodeState(kv=None, pos=start_pos.reshape(1),
                          ssm_h=state.ssm_h.index_select(1, idx),
                          ssm_conv=state.ssm_conv.index_select(1, idx))
        for t in range(c):
            x, _ = _decode_trunk(params, cfg, row, tokens[t : t + 1].reshape(1, 1))
        state.ssm_h.index_copy_(1, idx, row.ssm_h)
        state.ssm_conv.index_copy_(1, idx, row.ssm_conv)
        ids, logits = _lm_head_token(params, cfg, x)
        return state._replace(pos=pos), ids, logits
    kv = state.kv
    bs = kv.k.shape[2]
    row = state.tables[idx]  # (1, max_blocks)
    steps = torch.arange(c, device=tokens.device)
    positions = start_pos + steps
    if n_real is None:
        blks = row[0, positions // bs]
    else:
        # A padded position may lie past the table's end: any entry will
        # do, its write goes to the scratch row.
        last = torch.clamp(positions // bs, max=row.shape[1] - 1)
        blks = torch.where(steps < n_real, row[0, last], 0)
    offs = positions % bs
    x = _scale_embed(params["embed"][tokens[None, :]].to(dtype_of(cfg.compute_dtype)), cfg)
    index = _mixer_index(cfg)
    for layer, p in enumerate(params["blocks"]):
        j = index[layer]
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        if "mamba" in p:
            carried = (state.ssm_h[j].index_select(0, idx), state.ssm_conv[j].index_select(0, idx))
            o, (new_h, new_conv) = mamba_block(p["mamba"], h, cfg, carried, n_real)
            state.ssm_h[j].index_copy_(0, idx, new_h)
            state.ssm_conv[j].index_copy_(0, idx, new_conv)
        else:
            q, k_new, v_new = chunk_qkv(p["attn"], h, positions, cfg)  # k_new (1, Hkv, C, hd)
            kv.k[j][blks, offs] = k_new[0].transpose(0, 1)
            kv.v[j][blks, offs] = v_new[0].transpose(0, 1)
            vk = _view(kv.k[j], row, cache_len)
            vv = _view(kv.v[j], row, cache_len)
            o = attend_view_chunk(p["attn"], q, vk, vv, positions, cfg)
        x = _residual(x, o, cfg)
        x = _residual(x, _ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg), cfg)
    if n_real is not None:
        x = x.index_select(1, (n_real - 1).reshape(1))
    ids, logits = _lm_head_token(params, cfg, x)
    return state._replace(pos=pos), ids, logits


def paged_reset_slot(state: PagedDecodeState, slot: int,
                     row: Union[np.ndarray, torch.Tensor]) -> PagedDecodeState:
    """Point ``slot`` at block-table ``row`` and rewind it to position 0 (in
    place); an SSM or layered hybrid slot's recurrent state is zeroed.  The blocks are not
    cleared: the ``j <= pos`` rule masks stale entries until they are
    overwritten in order."""
    if state.tables is not None:
        state.tables[slot] = torch.as_tensor(row, dtype=torch.int64).to(state.tables.device)
    if state.ssm_h is not None:
        state.ssm_h[:, slot] = 0
        state.ssm_conv[:, slot] = 0
    state.pos[slot] = 0
    return state
