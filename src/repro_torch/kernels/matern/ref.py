"""Plain PyTorch version of the Matérn-5/2 kernel-matrix kernel.

Same arithmetic as ``csrc/matern.cu``: the distance from direct differences
over ``d``, a safe sqrt, then ``s (1 + sqrt5 r + 5 r^2 / 3) exp(-sqrt5 r)``.
Rows are computed one at a time.  A CPU elementwise loop runs its
vectorised and its scalar ``exp`` on different elements depending on the
tensor's length, and the two can differ in the last bit; one row per call
keeps row ``i`` a function of ``a[i]`` alone, whatever the number of rows,
as the CUDA kernel's rows are.
"""
from __future__ import annotations

import math

import torch

SQRT5 = math.sqrt(5.0)


def _row(a_i: torch.Tensor, b: torch.Tensor, outputscale) -> torch.Tensor:
    diff = a_i[None, :] - b  # (m, d)
    d2 = torch.sum(diff * diff, dim=-1)
    safe = torch.where(d2 > 1e-24, d2, 1.0)
    r = torch.where(d2 > 1e-24, torch.sqrt(safe), 0.0)
    s = SQRT5 * r
    return outputscale * (1.0 + s + s * s / 3.0) * torch.exp(-s)


def matern52_ref(a: torch.Tensor, b: torch.Tensor, outputscale) -> torch.Tensor:
    """k(a, b) for inputs pre-scaled by the lengthscales: (n, d) x (m, d)
    -> (n, m)."""
    if a.shape[0] == 0:
        return a.new_empty((0, b.shape[0]))
    return torch.stack([_row(a[i], b, outputscale) for i in range(a.shape[0])])
