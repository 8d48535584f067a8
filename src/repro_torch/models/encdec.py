"""Whisper-style encoder-decoder (the audio family): parameters, encoder,
teacher-forced decoder and the decode step.

The reference's ``models/encdec.py`` for one card: Python loops over
per-layer parameter lists where the reference scans stacked trees; under
``cfg.remat`` each block recomputes its activations in the backward pass.  The conv1d + GELU mel frontend is a stub, as in the reference:
the encoder takes precomputed (B, n_frames, d_model) frame embeddings.
Positions are sinusoidal, added to the frames and to the decoder's token
embeddings; the attention blocks use no RoPE (``rope_theta`` 0).  A decoder
block is causal self-attention, cross-attention over the encoder output,
then the MLP; the head is tied to the token embedding.

Serving: :func:`init_decode_state` runs the encoder once and keeps every
decoder layer's cross-attention keys and values; :func:`decode_step` then
advances each row by one token against its self-attention KV cache, with a
position per row as the decoder-only LMs'.  The serving engine refuses the
family, as the reference's does: it has no ``prefill_state`` (the decode
state comes from the frames).  :func:`lm_loss` is the training loss.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.runtime.sharding import (
    gather_params,
    lookup,
    maybe_constrain,
    maybe_constrain_logits,
)

from .attention import (
    KVCache,
    attention_decode,
    attention_train,
    cross_attention,
    encode_cross_kv,
    init_attention,
    init_kv_cache,
)
from .layers import (
    Params,
    cross_entropy_loss,
    dtype_of,
    embed_init,
    init_mlp,
    mlp,
    remat_call,
    rmsnorm,
    unembed,
)


def _sinusoid(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings of fp32 positions (...,) -> (..., d): sin at
    the even features, cos at the odd ones."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos[..., None] / torch.pow(10000.0, dim / d)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(*pos.shape, d)


def sinusoidal_positions(seq: int, d: int, offset: int = 0, device=None) -> torch.Tensor:
    """(seq, d) fp32 embeddings of positions ``offset .. offset + seq - 1``."""
    return _sinusoid(torch.arange(seq, dtype=torch.float32, device=device) + offset, d)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _init_enc_block(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_attention(gen, cfg, dtype, device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device),
    }


def _init_dec_block(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "self_attn": init_attention(gen, cfg, dtype, device),
        "ln_x": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "cross_attn": init_attention(gen, cfg, dtype, device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig, device="cuda") -> Params:
    """Random parameters from ``gen``: ``{"enc_blocks": [...], "dec_blocks":
    [...], "embed", "ln_enc", "ln_f"}`` with the reference's leaf names;
    ``device="meta"`` gives the shapes only."""
    dtype = dtype_of(cfg.param_dtype)
    return {
        "enc_blocks": [_init_enc_block(gen, cfg, dtype, device)
                       for _ in range(cfg.n_encoder_layers)],
        "dec_blocks": [_init_dec_block(gen, cfg, dtype, device) for _ in range(cfg.n_layers)],
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype, device),
        "ln_enc": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# Encoder and teacher-forced decoder
# ---------------------------------------------------------------------------
def encode(params: Params, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, d) precomputed embeddings -> encoder output (B, F, d):
    non-causal self-attention blocks."""
    dt = dtype_of(cfg.compute_dtype)
    pe = sinusoidal_positions(frames.shape[1], cfg.d_model, device=frames.device)
    x = maybe_constrain(frames.to(dt) + pe.to(dt))
    for p in params["enc_blocks"]:
        x = maybe_constrain(remat_call(cfg, _enc_block, p, x, cfg))
    return rmsnorm(x, gather_params({"ln": params["ln_enc"]})["ln"], cfg.norm_eps)


def _enc_block(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    p = gather_params(p)
    x = x + attention_train(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, causal=False)
    return x + mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.mlp)


def _dec_block(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    p = gather_params(p)
    x = x + attention_train(p["self_attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
                            causal=True)
    kv = encode_cross_kv(p["cross_attn"], enc_out, cfg)
    x = x + cross_attention(p["cross_attn"], rmsnorm(x, p["ln_x"], cfg.norm_eps), kv, cfg)
    return x + mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.mlp)


def _decoder(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
             enc_out: torch.Tensor) -> torch.Tensor:
    """Every decoder block over the tokens (B, S) -> the final residual
    stream (B, S, d), before the final norm."""
    dt = dtype_of(cfg.compute_dtype)
    pe = sinusoidal_positions(tokens.shape[1], cfg.d_model, device=tokens.device)
    embed = gather_params({"embed": params["embed"]})["embed"]
    x = maybe_constrain(lookup(embed, tokens).to(dt) + pe.to(dt))
    for p in params["dec_blocks"]:
        x = maybe_constrain(remat_call(cfg, _dec_block, p, x, enc_out, cfg))
    return x


def _head(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the tied unembedding -> fp32 logits."""
    params = gather_params({k: params[k] for k in ("ln_f", "embed")})
    return maybe_constrain_logits(unembed(rmsnorm(x, params["ln_f"], cfg.norm_eps),
                                          params["embed"]))


def decode_train(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder -> logits (B, S, V) in fp32, every position."""
    return _head(params, cfg, _decoder(params, cfg, tokens, enc_out))


def lm_loss(params: Params, cfg: ArchConfig, batch) -> torch.Tensor:
    """Mean next-token cross entropy of the teacher-forced decoder over the
    encoded ``batch["frames"]`` at ``batch["labels"]``."""
    enc_out = encode(params, cfg, batch["frames"])
    return cross_entropy_loss(decode_train(params, cfg, batch["tokens"], enc_out), batch["labels"])


def prefill(params: Params, cfg: ArchConfig, batch) -> torch.Tensor:
    """Encoder, then the decoder over ``batch["tokens"]`` -> last-position
    logits (B, 1, V): the head runs on the last position only."""
    enc_out = encode(params, cfg, batch["frames"])
    return _head(params, cfg, _decoder(params, cfg, batch["tokens"], enc_out)[:, -1:])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
class EncDecState(NamedTuple):
    """The decoder's self-attention KV cache (L, B, Hkv, W, hd) with its
    ``pos_buf`` (B, W), every layer's cross-attention keys and values
    (L, B, Hkv, F, hd), and each row's next position ``pos`` (B,)."""

    kv: KVCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    pos: torch.Tensor


def init_decode_state(params: Params, cfg: ArchConfig, frames: torch.Tensor,
                      seq_len: int) -> EncDecState:
    """Runs the encoder once and keeps each decoder layer's cross K/V."""
    enc_out = encode(params, cfg, frames)
    pairs = [encode_cross_kv(p["cross_attn"], enc_out, cfg) for p in params["dec_blocks"]]
    b = frames.shape[0]
    kv = init_kv_cache(cfg, b, seq_len, dtype_of(cfg.compute_dtype), frames.device)
    return EncDecState(
        kv=kv,
        cross_k=torch.stack([k for k, _ in pairs]),
        cross_v=torch.stack([v for _, v in pairs]),
        pos=torch.zeros((b,), dtype=torch.int64, device=frames.device),
    )


def decode_step(params: Params, cfg: ArchConfig, state: EncDecState,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, EncDecState]:
    """One token for every row (B, 1) -> (logits (B, 1, V), state).  The
    self-attention cache in ``state`` is updated in place."""
    dt = dtype_of(cfg.compute_dtype)
    pos = state.pos
    pe = _sinusoid(pos.to(torch.float32), cfg.d_model)[:, None]  # (B, 1, d)
    x = lookup(params["embed"], tokens).to(dt) + pe.to(dt)
    kv = state.kv
    pos_buf = kv.pos_buf
    for layer, p in enumerate(params["dec_blocks"]):
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        o, _, _, pos_buf = attention_decode(p["self_attn"], h, kv.k[layer], kv.v[layer], pos_buf,
                                            pos, cfg)
        x = x + o
        x = x + cross_attention(p["cross_attn"], rmsnorm(x, p["ln_x"], cfg.norm_eps),
                                (state.cross_k[layer], state.cross_v[layer]), cfg)
        x = x + mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.mlp)
    return _head(params, cfg, x), state._replace(kv=KVCache(kv.k, kv.v, pos_buf), pos=pos + 1)
