"""Plain PyTorch versions of the SWE flux kernels: the solver's own math.

Used for CPU tensors by :mod:`.ops` and, on the card, as the yardstick the
CUDA kernels are held against.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.swe.solver import SWEConfig, SWEState, _x_update, _y_update, step


def swe_sweep_ref(
    h: torch.Tensor,
    hu: torch.Tensor,
    hv: torch.Tensor,
    b: torch.Tensor,
    *,
    axis: int,
    g: float,
    d: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One directional sweep (axis 0 = x, 1 = y): ``(dh, dhu, dhv) / d``."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 (x) or 1 (y), got {axis}")
    update = _x_update if axis == 0 else _y_update
    return update(h, hu, hv, b, d, g)


def swe_fused_step_ref(
    state: SWEState, b: torch.Tensor, dt: float, *, cfg: SWEConfig
) -> SWEState:
    """One full step (both sweeps + Euler update) for ``(..., ny, nx)``."""
    return step(state, b, cfg, dt)
