"""Bytes and operations of one launch of the fused shallow-water step
(``swe_fused_step_kernel``): a stacked ``(B, ny, nx)`` batch advanced by one
forward-Euler step.

Each input byte is counted once and each output byte once: the three state
planes of every member read and written (h, hu, hv), the bathymetry plane
read once, and each member's probe values written.  The operations are
none of the bound: at 4 bytes a cell the step is bound by memory.
"""
from __future__ import annotations

from .peaks import HBM_BYTES_PER_S

F32 = 4


def fused_step_bytes(batch: int, ny: int, nx: int, n_probes: int = 2) -> int:
    plane = ny * nx * F32
    return 2 * 3 * batch * plane + plane + batch * n_probes * F32


def fused_step_bound_s(batch: int, ny: int, nx: int, n_probes: int = 2) -> float:
    """The least time one launch can take: its bytes at the HBM peak."""
    return fused_step_bytes(batch, ny, nx, n_probes) / HBM_BYTES_PER_S
