"""Wrappers of the SWE flux kernels (``csrc/swe_flux.cu``).

``swe_step`` is the single-grid drop-in for :func:`repro_torch.swe.solver.step`:
two directional sweep kernels, the Euler update in PyTorch.
``swe_step_batched`` advances a stacked ``(B, ny, nx)`` batch by one step
in one launch of the fused kernel, and ``solve_batched`` runs a whole
batched solve: a loop of fused steps over two ping-pong state buffers, each
step writing its probe values into the ``(B, T, P)`` series in-kernel.

A wrapper launches its kernel for CUDA tensors (raising if the kernel
cannot be built or launched) and runs the plain version of ``ref.py`` for
CPU tensors; nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.swe.solver import SWEConfig, SWEState, euler_update

from .ref import swe_fused_step_ref, swe_sweep_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "swe_fused_step": (_I, [_P] * 10 + [_I] * 6 + [_F] * 4 + [_P]),
    "swe_sweep": (_I, [_P] * 7 + [_I] * 4 + [_F] * 2 + [_P]),
}
FUSED_LAUNCHES = build.counter("swe_fused_step")
SWEEP_LAUNCHES = build.counter("swe_sweep")


def _lib() -> ctypes.CDLL:
    return build.LIBRARY.load("swe_flux", _SIGNATURES)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(tensors: Sequence[torch.Tensor], shape: Tuple[int, ...], what: str) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: all inputs must lie on the card, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: want float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: want shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def swe_sweep(
    h: torch.Tensor,
    hu: torch.Tensor,
    hv: torch.Tensor,
    b: torch.Tensor,
    *,
    axis: int,
    g: float,
    d: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One directional sweep over ``(..., ny, nx)`` planes (``b`` is
    ``(ny, nx)``): the ``(dh, dhu, dhv) / d`` tendencies of every cell."""
    if h.device.type == "cpu":
        return swe_sweep_ref(h, hu, hv, b, axis=axis, g=g, d=d)
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 (x) or 1 (y), got {axis}")
    ny, nx = h.shape[-2:]
    _check((h, hu, hv), h.shape, "swe_sweep")
    _check((b,), (ny, nx), "swe_sweep bathymetry")
    out = [torch.empty_like(h) for _ in range(3)]
    lib = _lib()
    err = lib.swe_sweep(
        h.data_ptr(), hu.data_ptr(), hv.data_ptr(), b.data_ptr(),
        *(o.data_ptr() for o in out),
        h.numel() // (ny * nx), ny, nx, axis, g, d, _stream(),
    )
    build.check_launch(err, "swe_sweep")
    SWEEP_LAUNCHES.add()
    return tuple(out)


def swe_step(state: SWEState, b: torch.Tensor, dt: float, *, cfg: SWEConfig) -> SWEState:
    """Drop-in for :func:`repro_torch.swe.solver.step`: x and y sweep
    kernels, then the Euler update, positivity clamp and wet mask."""
    h, hu, hv = state
    tx = swe_sweep(h, hu, hv, b, axis=0, g=cfg.g, d=cfg.dx)
    ty = swe_sweep(h, hu, hv, b, axis=1, g=cfg.g, d=cfg.dy)
    return euler_update(state, tx, ty, dt)


def swe_step_batched(
    state: SWEState,
    b: torch.Tensor,
    dt: float,
    *,
    cfg: SWEConfig,
    out: Optional[SWEState] = None,
    series: Optional[torch.Tensor] = None,
    t: int = 0,
    probes: Optional[torch.Tensor] = None,
) -> SWEState:
    """One fused step for a stacked ``(B, ny, nx)`` batch.

    ``out`` (optional) receives the new state; with ``series`` (``(B, T,
    P)``) and ``probes`` (``(2, P)`` int row/column indices) the step's
    probe values ``h + b`` are written to ``series[:, t]``.
    """
    h = state.h
    if h.device.type == "cpu":
        new = swe_fused_step_ref(state, b, dt, cfg=cfg)
        if out is not None:
            for dst, src in zip(out, new):
                dst.copy_(src)
            new = out
        if series is not None:
            series[:, t] = new.h[:, probes[0], probes[1]] + b[probes[0], probes[1]]
        return new
    if out is None:
        out = SWEState(*(torch.empty_like(h) for _ in range(3)))
    launch = _fused_launcher(state, out, b, series, probes, cfg, dt)
    launch(state, out, t)
    return out


def _fused_launcher(
    state: SWEState,
    out: SWEState,
    b: torch.Tensor,
    series: Optional[torch.Tensor],
    probes: Optional[torch.Tensor],
    cfg: SWEConfig,
    dt: float,
):
    """Check the buffers of a fused step once; return ``launch(src, dst, t)``
    that steps ``src`` into ``dst`` (both among the checked buffers)."""
    B, ny, nx = state.h.shape
    _check(state, (B, ny, nx), "swe_step_batched")
    _check(out, (B, ny, nx), "swe_step_batched output")
    _check((b,), (ny, nx), "swe_step_batched bathymetry")
    if series is not None:
        if probes is None or probes.dtype != torch.int32 or probes.device != b.device:
            raise ValueError("series output needs int32 probes on the card")
        if probes.ndim != 2 or probes.shape[0] != 2 or not probes.is_contiguous():
            raise ValueError("probes must be a contiguous (2, P) tensor")
        n_probes, n_steps = probes.shape[1], series.shape[1]
        _check((series,), (B, n_steps, n_probes), "swe_step_batched series")
        ptrs = (series.data_ptr(), probes[0].data_ptr(), probes[1].data_ptr())
    else:
        n_probes, n_steps, ptrs = 0, 0, (None, None, None)
    fn = _lib().swe_fused_step
    stream = _stream()
    consts = (B, ny, nx, cfg.g, cfg.dx, cfg.dy, dt, stream)

    def launch(src: SWEState, dst: SWEState, t: int) -> None:
        if series is not None and not 0 <= t < n_steps:
            raise ValueError(f"step {t} outside the series' {n_steps} steps")
        err = fn(
            src.h.data_ptr(), src.hu.data_ptr(), src.hv.data_ptr(), b.data_ptr(),
            dst.h.data_ptr(), dst.hu.data_ptr(), dst.hv.data_ptr(), *ptrs,
            n_probes, t, n_steps, *consts,
        )
        build.check_launch(err, "swe_fused_step")
        FUSED_LAUNCHES.add()

    return launch


def solve_batched(
    state: SWEState,
    b: torch.Tensor,
    dt: float,
    n_steps: int,
    pi: torch.Tensor,
    pj: torch.Tensor,
    *,
    cfg: SWEConfig,
) -> Tuple[torch.Tensor, SWEState]:
    """``n_steps`` fused steps from ``state``: ``((B, T, P) series, final)``.

    Two state buffers alternate as input and output (the step kernel reads
    its neighbours, so it cannot update in place): ``state``'s own tensors,
    when contiguous, are one of them and are overwritten.  The probe gauge
    of each step is written by the kernel itself, so a step is one launch.
    """
    B = state.h.shape[0]
    probes = torch.stack([pi, pj]).to(torch.int32).contiguous()
    series = torch.empty(
        (B, n_steps, probes.shape[1]), dtype=torch.float32, device=b.device
    )
    cur = SWEState(*(x.contiguous() for x in state))
    nxt = SWEState(*(torch.empty_like(cur.h) for _ in range(3)))
    if b.device.type == "cpu":
        for t in range(n_steps):
            swe_step_batched(
                cur, b, dt, cfg=cfg, out=nxt, series=series, t=t, probes=probes
            )
            cur, nxt = nxt, cur
        return series, cur
    # Buffers are checked once; each step is then one bare launch.
    launch = _fused_launcher(cur, nxt, b, series, probes, cfg, dt)
    for t in range(n_steps):
        launch(cur, nxt, t)
        cur, nxt = nxt, cur
    return series, cur
