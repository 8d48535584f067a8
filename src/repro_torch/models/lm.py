"""Decoder-only LM of the dense family: parameters, forward, prefill and
decode.

The reference's ``models/lm.py`` for one card: a Python loop over a list of
per-layer parameter dicts where the reference scans a stacked tree, no
remat and no sharding constraints.  The decode state carries one position
per batch row (see :mod:`repro_torch.models.attention`), so the
continuous-batching pool is simply a batch of rows.  The MoE, SSM, hybrid
and VLM branches and the paged decode functions are not ported (ROADMAP
Queue 1 item 10): :class:`~repro_torch.configs.base.ArchConfig` refuses
those families.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import NOT_PORTED, ArchConfig

from .attention import KVCache, attention_decode, attention_train, init_attention, init_kv_cache
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


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """-> logits (B, S, V) in fp32, every position."""
    x = params["embed"][batch["tokens"]].to(dtype_of(cfg.compute_dtype))
    for p in params["blocks"]:
        x = _apply_block(p, x, cfg)
    return _head(params, cfg, x)


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward -> last-position logits (B, 1, V).

    The slice is copied out so that the whole sequence's logits are freed
    on return (at 32k tokens and qwen2's vocabulary they take 19.9 GB per
    sequence)."""
    return forward(params, cfg, batch)[:, -1:, :].clone()


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


# The reference's paged decoding and training loss, not ported yet.
_REFERENCE_ONLY = (
    "PagedDecodeState", "check_paged_support", "init_paged_state", "paged_decode_step",
    "paged_prefill_chunk", "paged_reset_slot", "slot_evict", "lm_loss",
)


def __getattr__(name: str):
    if name in _REFERENCE_ONLY:
        raise NotImplementedError(f"lm.{name}: {NOT_PORTED}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

