"""Mamba2 (SSD, state-space duality) blocks.

The reference's ``models/ssm.py`` for one card, the scalar-A-per-head SSD
form of arXiv:2405.21060:

    h_t = exp(dt_t A) h_{t-1} + dt_t (B_t ⊗ x_t)
    y_t = C_t · h_t + D x_t

:func:`ssd_chunked` splits the sequence into Q-token chunks: within a chunk
the terms are a masked (Q, Q) matmul, across chunks a loop over the chunk
states (H, P, N) (the reference's ``lax.scan``).  Every contraction of
three operands is two steps with an intermediate no larger than ``x``, and
the (Q, Q) tensors live one layer at a time.  :func:`ssd_naive` is the
oracle recurrence.

Decode carries the (H, P, N) state exactly, O(1) a token.  The depthwise
causal conv of :func:`mamba_block` and the rolling conv of
:func:`mamba_decode_step` are the same sum of K shifted products in the
same order, so a prefill through the block and one through the decode
steps see the same conv outputs.  Given a sequence's SSM state and conv
window, :func:`mamba_block` continues it over a whole chunk of positions
in one pass and returns the state and window at the chunk's end (a paged
prefill chunk); positions past ``n_real`` are padding that moves neither.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.runtime.sharding import rowwise

from .layers import Params, dense_init, normal_init, rmsnorm


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` = max(x, 0) + log1p(exp(-|x|));
    ``F.softplus`` turns linear above a threshold of 20."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------
def ssd_naive(x, dt, A, B, C, D, state=None):
    """Oracle recurrence.  x: (L, H, P), dt: (L, H), A: (H,), B/C: (L, N),
    D: (H,).  One group: B and C are shared across heads.  From ``state``
    (H, P, N) where given, and then -> (y, final state)."""
    l, h, p = x.shape
    h0 = state
    state = x.new_zeros((h, p, B.shape[-1])) if h0 is None else h0
    ys = []
    for t in range(l):
        decay = torch.exp(dt[t] * A)  # (H,)
        upd = dt[t][:, None, None] * (x[t][:, :, None] * B[t][None, None, :])
        state = decay[:, None, None] * state + upd
        ys.append(torch.einsum("hpn,n->hp", state, C[t]))
    y = torch.stack(ys) + D[None, :, None] * x
    return y if h0 is None else (y, state)


def ssd_chunked(x, dt, A, B, C, D, chunk: int, state=None):
    """Chunked SSD.  Shapes as :func:`ssd_naive`, with optional leading batch
    dims on x, dt, B and C (and ``state``); L % chunk == 0 (the caller
    pads).  Returns (..., L, H, P); from ``state`` (..., H, P, N) where
    given, and then (y, the state after position L - 1)."""
    if x.ndim == 3:
        h0 = None if state is None else state[None]
        y, h = _ssd_chunked(x[None], dt[None], A, B[None], C[None], D, chunk, h0)
        return y[0] if state is None else (y[0], h[0])
    y, h = _ssd_chunked(x, dt, A, B, C, D, chunk, state)
    return y if state is None else (y, h)


def _ssd_chunked(x, dt, A, B, C, D, q: int, h0=None):
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // q
    xq = x.reshape(b, nc, q, h, p)
    dtq = dt.reshape(b, nc, q, h)
    Bq = B.reshape(b, nc, q, n)
    Cq = C.reshape(b, nc, q, n)

    cum = torch.cumsum(dtq * A, dim=2)  # (b, nc, q, h): log decay from chunk start
    # Within a chunk: scores[i, j] = C_i·B_j exp(cum_i - cum_j) dt_j, j <= i,
    # laid out (b, nc, h, i, j).
    cum_h = cum.transpose(2, 3)  # (b, nc, h, q)
    seg = cum_h[..., :, None] - cum_h[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    # Double where: the masked entries have seg > 0 and exp(seg) overflows;
    # inf * 0 in a cotangent would NaN a backward pass.
    seg = torch.where(mask, seg, 0.0)
    decay = torch.where(mask, torch.exp(seg), 0.0)
    del seg
    cb = Cq @ Bq.transpose(-1, -2)  # (b, nc, i, j)
    scores = cb[:, :, None] * decay * dtq.transpose(2, 3)[..., None, :]
    del decay
    y = (scores @ xq.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)  # (b, nc, q, h, p)
    del scores

    # Chunk summary state S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j, in
    # two steps: the weighted x (b, nc, q, h, p), then the product with B.
    tail = torch.exp(cum[:, :, -1:, :] - cum)  # (b, nc, q, h): decay j -> chunk end
    wx = (tail * dtq)[..., None] * xq
    sb = (wx.reshape(b, nc, q, h * p).transpose(-1, -2) @ Bq).reshape(b, nc, h, p, n)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, h)

    # The state entering each chunk: a loop over the chunks, from h0.
    s_in = torch.empty_like(sb)
    state = sb.new_zeros((b, h, p, n)) if h0 is None else h0
    for c in range(nc):
        s_in[:, c] = state
        state = chunk_decay[:, c, :, None, None] * state + sb[:, c]

    # Across chunks: y_inter[i] = exp(cum_i) (C_i · S_in), two steps.
    cs = Cq @ s_in.permute(0, 1, 4, 2, 3).reshape(b, nc, n, h * p)  # (b, nc, q, h p)
    y = y + cs.reshape(b, nc, q, h, p) * torch.exp(cum)[..., None]
    return y.reshape(b, l, h, p) + D[:, None] * x, state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------
def init_mamba(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    """The reference's leaves; ``dt_bias``, ``A_log`` and ``D`` are fp32
    whatever ``dtype``."""
    ssm = cfg.ssm
    d = cfg.d_model
    di = ssm.d_inner(d)
    nh = ssm.n_heads(d)
    n = ssm.d_state
    conv_dim = di + 2 * n

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * n + nh, dtype, device),
        "conv_w": normal_init(gen, (ssm.d_conv, conv_dim), 1.0 / math.sqrt(ssm.d_conv), dtype,
                              device),
        "conv_b": full((conv_dim,), 0.0, dtype),
        "dt_bias": full((nh,), 0.0, torch.float32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32)).to(device),
        "D": full((nh,), 1.0, torch.float32),
        "norm_w": full((di,), 1.0, dtype),
        "out_proj": dense_init(gen, di, d, dtype, device),
    }


def _conv_sum(windows, w: torch.Tensor) -> torch.Tensor:
    """sum_i windows[i] * w[i], added in order i = 0 .. K-1."""
    out = windows[0] * w[0]
    for i in range(1, w.shape[0]):
        out = out + windows[i] * w[i]
    return out


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d then SiLU.  x: (B, L, C), w: (K, C); the
    K - 1 inputs before x are ``window`` (B, K-1, C), or zeros.  A sum of
    shifted slices, as the reference (not ``F.conv1d``, which may run in
    TF32)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0)) if window is None else torch.cat([window, x], dim=1)
    return F.silu(_conv_sum([xp[:, i : i + s] for i in range(k)], w) + b)


def _split(zxbcdt: torch.Tensor, di: int, n: int):
    return zxbcdt[..., :di], zxbcdt[..., di : 2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n :]


def mamba_block(params: Params, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                n_real: Optional[torch.Tensor] = None):
    """x: (B, S, d) -> (B, S, d).

    With ``state`` = (SSM state (B, H, P, N) fp32, conv window (B, K-1,
    conv_dim)) the block continues each sequence from them and returns
    (y, (state, window)) after its last position.  ``n_real`` (0-d) marks
    positions from ``n_real`` on as padding: they take dt = 0, so the SSM
    state passes them unchanged, and the window returned holds the last
    K - 1 inputs before ``n_real``.  The scan's chunks are ``ssm.chunk``
    positions, or S where S is shorter (no padding within)."""
    ssm = cfg.ssm
    b, s, d = x.shape
    di, nh, n = ssm.d_inner(d), ssm.n_heads(d), ssm.d_state

    z, xbc_in, dt_raw = _split(x @ params["in_proj"], di, n)
    window = None if state is None else state[1]
    xbc = _causal_conv(xbc_in, params["conv_w"], params["conv_b"], window)
    xs, B, C = xbc[..., :di], xbc[..., di : di + n], xbc[..., di + n :]
    dt = softplus(dt_raw.float() + params["dt_bias"])  # (B, S, H)
    if n_real is not None:
        dt = dt * (torch.arange(s, device=x.device) < n_real)[None, :, None]
    A = -torch.exp(params["A_log"])  # (H,)

    q = min(ssm.chunk, s)
    pad = (-s) % q
    if pad:
        xs, dt, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (xs, dt, B, C))
    xh = xs.reshape(b, s + pad, nh, ssm.head_dim)
    if state is None:
        y = rowwise(ssd_chunked, xh.float(), dt, A, B.float(), C.float(), params["D"], q,
                    batched=(True, True, False, True, True, False, False))
    else:
        y, h = ssd_chunked(xh.float(), dt, A, B.float(), C.float(), params["D"], q, state[0])
    y = y[:, :s].reshape(b, s, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params["norm_w"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if state is None:
        return out
    # The window after the last real position: inputs n_real - K + 1 ..
    # n_real - 1, which sit at n_real .. n_real + K - 2 of [window, inputs].
    full = torch.cat([window, xbc_in], dim=1)
    k1 = window.shape[1]
    if n_real is None:
        new_window = full[:, s:]
    else:
        new_window = full.index_select(1, n_real + torch.arange(k1, device=x.device))
    return out, (h, new_window)


def mamba_decode_step(
    params: Params,
    x: torch.Tensor,  # (B, 1, d)
    h_state: torch.Tensor,  # (B, H, P, N) fp32
    conv_state: torch.Tensor,  # (B, K-1, conv_dim)
    cfg: ArchConfig,
):
    """O(1) decode -> (y (B, 1, d), new_h, new_conv); the states are new
    tensors (the caller decides where they are written)."""
    ssm = cfg.ssm
    b, _, d = x.shape
    di, nh, n = ssm.d_inner(d), ssm.n_heads(d), ssm.d_state

    z, xbc, dt_raw = _split((x @ params["in_proj"])[:, 0], di, n)
    # Rolling conv: append, convolve, keep the last K-1.
    full = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # (B, K, C)
    w = params["conv_w"]
    xbc = F.silu(_conv_sum([full[:, i] for i in range(w.shape[0])], w) + params["conv_b"])
    new_conv = full[:, 1:]

    xs, B, C = xbc[..., :di], xbc[..., di : di + n], xbc[..., di + n :]
    dt = softplus(dt_raw.float() + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(b, nh, ssm.head_dim).float()

    decay = torch.exp(dt * A)  # (B, H)
    upd = dt[:, :, None, None] * (xh[:, :, :, None] * B[:, None, None, :].float())
    new_h = decay[:, :, None, None] * h_state + upd
    # An elementwise product and a sum over N, not an einsum: the reference's
    # batch-invariance repair (DESIGN.md §10), which keeps a pooled decode
    # equal to a single-sequence one there.
    y = (new_h * C.float()[:, None, None, :]).sum(-1)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(b, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params["norm_w"], cfg.norm_eps)
    return (y @ params["out_proj"])[:, None, :], new_h, new_conv
