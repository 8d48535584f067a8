"""Shared transformer primitives (plain PyTorch, parameters as dicts)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.runtime.sharding import maybe_constrain_ffn, maybe_reduce

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


# -- init helpers ------------------------------------------------------------
def normal_init(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """fp32 normals times ``scale`` from ``gen`` (drawn on the generator's own
    device), in ``dtype`` on ``device``.  On the ``meta`` device nothing is
    drawn: the tensor has the shape and dtype only (parameter counts)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * scale
    return w.to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in**-0.5
    return normal_init(gen, (d_in, d_out), scale, dtype, device)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return normal_init(gen, (vocab, d), 0.02, dtype, device)


# -- norms -------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# -- rotary embeddings ---------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, S, D); positions: (S,) or (B, S).

    Rotates the interleaved pairs ``(x[..., ::2], x[..., 1::2])`` and
    interleaves them back, as the reference does (not the rotate-half
    layout)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (D/2,)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., S, D/2)
    ang = ang[None, None] if ang.ndim == 2 else ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# -- products accumulated in fp32 ------------------------------------------------
def _mm_out_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cuBLAS's bf16 GEMM with an fp32 output (``out_dtype``): no fp32 copy
    of either operand.  PyTorch has no derivative for this overload."""
    if b.ndim == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.bmm(a, b, out_dtype=torch.float32)


class MatmulF32(torch.autograd.Function):
    """``product(a, b)``, an fp32 product of two operands of a lower
    precision, with the backward of the reference's
    ``einsum(a.astype(float32), b.astype(float32))``: each operand's
    gradient is an fp32 product of the fp32 cotangent with the other
    operand upcast, cast back to the operand's own dtype."""

    @staticmethod
    def forward(ctx, a, b, product):
        ctx.save_for_backward(a, b)
        return product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if b.ndim == 2:
            g2 = g.reshape(-1, g.shape[-1])
            if ctx.needs_input_grad[0]:
                ga = (g2 @ b.float().T).reshape(a.shape).to(a.dtype)
            if ctx.needs_input_grad[1]:
                gb = (a.reshape(-1, a.shape[-1]).float().T @ g2).to(b.dtype)
        else:
            if ctx.needs_input_grad[0]:
                ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
            if ctx.needs_input_grad[1]:
                gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb, None


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in fp32 with an fp32 result, for (..., M, K) x
    (K, N) or batched (P, M, K) x (P, K, N): the reference's
    ``preferred_element_type=float32``.

    bf16 operands on the card go to cuBLAS with an fp32 output
    (``out_dtype``), so neither operand is copied to fp32: a bf16 x bf16
    product is exact in fp32, and only the order of the sums can differ
    from the fp32 product of the upcast operands, which is what the CPU
    (which has no such kernel) computes.  That route is differentiable
    through :class:`MatmulF32`."""
    if not (a.dtype == b.dtype == torch.bfloat16 and a.device.type == "cuda"):
        return a.float() @ b.float()  # .float() of an fp32 tensor is itself
    return MatmulF32.apply(a, b, _mm_out_f32)


# -- rematerialisation -----------------------------------------------------------
def remat_call(cfg, fn, *args):
    """``fn(*args)``; under ``cfg.remat``, while autograd records a tensor
    argument, through ``torch.utils.checkpoint``: the backward pass
    recomputes ``fn``'s activations instead of keeping them (the
    reference's ``jax.checkpoint`` of a block).  Recomputing runs the same
    operations on the same values, so the gradients are the same bits.

    The blocks draw no random numbers, so no RNG state is stashed for the
    recompute (``preserve_rng_state=False``): reading the card's generator
    state is refused while a CUDA graph captures the train step."""
    if cfg.remat and torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


# -- MLP variants --------------------------------------------------------------
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str, dtype, device) -> Params:
    if kind == "swiglu":
        return {
            "w_gate": dense_init(gen, d_model, d_ff, dtype, device),
            "w_up": dense_init(gen, d_model, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d_model, dtype, device),
        }
    if kind in ("sqrelu", "gelu"):
        return {
            "w_up": dense_init(gen, d_model, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d_model, dtype, device),
        }
    raise ValueError(kind)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (``F.gelu``'s
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def mlp(params: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif kind == "sqrelu":
        h = torch.square(F.relu(x @ params["w_up"]))
    elif kind == "gelu":
        h = gelu(x @ params["w_up"])
    else:
        raise ValueError(kind)
    return maybe_constrain_ffn(h) @ params["w_down"]


def unembed(x: torch.Tensor, w_embed: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: (..., d) x (V, d) -> (..., V) in fp32, with no fp32
    copy of the embedding (:func:`matmul_f32`)."""
    return matmul_f32(x, w_embed.T)


def _gold(shifted: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``shifted[..., labels]``: a gather; for a DTensor (a sharded step)
    the reference's one-hot contraction instead, as a ``where`` and a sum
    over the vocabulary (the gather's backward would scatter into a
    replicated full-size zeros, and a vocab-sharded gather leaves partial
    values).  Every term of the sum but one is +0, so the value is the
    gathered one, bit for bit, and so is its gradient."""
    if type(shifted) is torch.Tensor:
        return torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    ids = torch.arange(shifted.shape[-1], device=labels.device)
    return maybe_reduce(torch.where(labels[..., None] == ids, shifted, 0.0).sum(-1))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of fp32 logits (B, S, V) at labels
    (B, S): logsumexp about the detached row maximum, less the gold logit.
    The reference takes the gold logit by a one-hot contraction (for its
    sharded vocabulary); a gather reads the same value."""
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    logz = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    gold = _gold(shifted, labels) + m[..., 0]
    return (logz - gold).mean()
