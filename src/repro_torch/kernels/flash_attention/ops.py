"""Wrapper of the flash-attention kernels (``csrc/flash_attention.cu``) and
the attention dispatch of the reference's ``kernels/flash_attention/ops.py``.

:func:`attention` picks the implementation: ``"xla"`` runs the plain
version, ``"chunked"`` (or unequal query and key lengths) the plain blocked
loop, and ``"kernel"`` a CUDA kernel for CUDA tensors (it launches or
raises) or the plain version for CPU tensors.  Which CUDA kernel serves a
call is decided by :func:`route` from the dtype alone: bf16 goes to the
tensor-core kernel (wgmma + TMA), fp32 to the CUDA-core kernel (TF32 tensor
cores cannot meet the fp32 bound of 3e-5).  Neither falls back to the
other.  The kernels have no backward (training takes ``"chunked"``).

DTensor inputs (a sharded prefill) reach the kernel through ``local_map``
(:func:`_attention_sharded`): each rank runs it on its local shards, laid
out where the kernel can take them, and never on a DTensor itself.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

from .ref import attention_ref

IMPLS = ("kernel", "chunked", "xla")
HEAD_DIMS = (32, 64, 128, 192)
# dtype -> (route, C entry point of csrc/flash_attention.cu)
ROUTES = {
    torch.bfloat16: ("tensor_core", "flash_attention_fwd_bf16"),
    torch.float32: ("cuda_core", "flash_attention_fwd_fp32"),
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k, v, o, B, H, Hkv, S, D, causal, window, scale, stream)
_SIGNATURES = {fn: (_I, [_P] * 4 + [_I] * 7 + [_F, _P]) for _, fn in ROUTES.values()}
# One launch counter per route.
LAUNCHES = {
    "tensor_core": build.counter("flash_attention_tc"),
    "cuda_core": build.counter("flash_attention_fp32"),
}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that serves a call: ``"tensor_core"`` for bf16,
    ``"cuda_core"`` for fp32.  Raises for what neither kernel takes."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {head_dim} not in {HEAD_DIMS}")
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention: want float32 or bfloat16, got {dtype}")
    return ROUTES[dtype][0]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel of :func:`route`: q (B, H, S, D), k and v
    (B, Hkv, S, D), all on one card, contiguous, fp32 or bf16 -> (B, H, S, D)
    in q's type."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"want (B,H,S,D), (B,Hkv,S,D) x2, got {q.shape}, {k.shape}, {v.shape}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and kv {tuple(k.shape)} "
                         "disagree (GQA needs H % Hkv == 0 and equal B, S, D)")
    which = route(q.dtype, d)
    build.require_plain((q, k, v), "flash_attention")
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("flash_attention: q, k and v must lie on the same card")
        if t.dtype != q.dtype:
            raise TypeError("flash_attention: q, k and v must share one dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: inputs must be contiguous and 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds the grid's 65535")
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    lib = build.LIBRARY.load("flash_attention", _SIGNATURES)
    err = getattr(lib, ROUTES[q.dtype][1])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, hkv, s, d, int(causal), 0 if window is None else int(window),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(err, f"flash_attention ({which})")
    LAUNCHES[which].add()
    return out


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    impl: str = "kernel",
) -> torch.Tensor:
    """Multi-head GQA attention: q (B,H,S,D), k/v (B,Hkv,Skv,D) -> (B,H,S,D)."""
    if impl not in IMPLS:
        raise ValueError(f"impl '{impl}' not in {IMPLS}")
    if impl == "kernel" and q.shape[2] == k.shape[2] and type(q) is not torch.Tensor:
        from torch.distributed.tensor import DTensor

        if isinstance(q, DTensor):
            return _attention_sharded(q, k, v, causal=causal, window=window, scale=scale)
    if impl == "xla":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if impl == "chunked" or q.shape[2] != k.shape[2]:
        from repro_torch.models.chunked_attention import attention_chunked

        return attention_chunked(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    return flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def kernel_placements(q, k):
    """Placements on which every rank can run the kernel on its own shards:
    per mesh dim, the batch split as it is; the heads split only where the
    dim's size divides both H and Hkv (whole GQA groups on each rank); the
    sequence and head dim whole (the kernel takes no query offset, so a
    sequence shard would be masked as if it started at position 0)."""
    from torch.distributed.tensor import Replicate, Shard

    h, hkv = q.shape[1], k.shape[1]
    out = []
    for size, pq, pk in zip(q.device_mesh.shape, q.placements, k.placements):
        if pq.is_shard(0) and pk.is_shard(0):
            out.append(Shard(0))
        elif pq.is_shard(1) and h % size == 0 and hkv % size == 0:
            out.append(Shard(1))
        else:
            out.append(Replicate())
    return out


def _attention_sharded(q, k, v, *, causal, window, scale):
    """The kernel (the plain version on CPU shards) on each rank's local
    shards, through ``local_map``, with q, k and v first laid out by
    :func:`kernel_placements` (the collectives XLA inserts around a custom
    call it cannot partition)."""
    from torch.distributed.tensor.experimental import local_map

    pl = kernel_placements(q, k)
    mesh = q.device_mesh
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))

    def local(ql, kl, vl):
        return attention(ql.contiguous(), kl.contiguous(), vl.contiguous(), causal=causal,
                         window=window, scale=scale, impl="kernel")

    return local_map(local, out_placements=pl, in_placements=(pl, pl, pl),
                     redistribute_inputs=False, device_mesh=mesh)(q, k, v)
