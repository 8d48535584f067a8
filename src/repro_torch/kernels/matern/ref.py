"""Plain PyTorch versions of the Matérn-5/2 kernels.

Same arithmetic as ``csrc/matern.cu``: the distance from direct differences
over ``d``, a safe sqrt, then ``s (1 + sqrt5 r + 5 r^2 / 3) exp(-sqrt5 r)``.
Rows are computed one at a time.  A CPU elementwise loop runs its
vectorised and its scalar ``exp`` on different elements depending on the
tensor's length, and the two can differ in the last bit; one row per call
keeps row ``i`` a function of ``a[i]`` alone, whatever the number of rows,
as the CUDA kernel's rows are.

The posterior mean multiplies the kernel matrix by ``alpha`` elementwise
and sums over the training points by pairwise halving
(:func:`fixed_order_sum`), in the order the mean kernel sums its tree.
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


def tree_width(n: int) -> int:
    """The next power of two >= max(n, 1): the length the halving sum pads
    ``n`` terms to."""
    return 1 << max(n - 1, 0).bit_length()


def fixed_order_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` by pairwise halving, an order fixed by that axis'
    length alone.

    Every step is an elementwise add, so an output element does not depend
    on the sizes of the other axes: a reduction kernel may pick its
    blocking (and so its summation order) by the whole tensor's shape.
    """
    n = x.shape[dim]
    width = tree_width(n)
    if width != n:
        pad = list(x.shape)
        pad[dim] = width - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    while x.shape[dim] > 1:
        half = x.shape[dim] // 2
        x = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
    return x.squeeze(dim)


def posterior_mean_from_matrix(
    ks: torch.Tensor, alpha: torch.Tensor, y_scale: torch.Tensor, y_mean: torch.Tensor
) -> torch.Tensor:
    """The posterior mean from the kernel matrix ``ks`` (B, n): an
    elementwise product and a fixed-order sum instead of ``ks @ alpha``, so
    that row ``i`` does not depend on the number of rows."""
    return fixed_order_sum(ks[:, :, None] * alpha[None, :, :], dim=1) * y_scale + y_mean


def matern52_mean_ref(
    x: torch.Tensor,
    ls: torch.Tensor,
    x_scaled: torch.Tensor,
    alpha: torch.Tensor,
    y_scale: torch.Tensor,
    y_mean: torch.Tensor,
    outputscale,
) -> torch.Tensor:
    """Posterior mean (B, p) at raw points ``x`` (B, d), as
    ``csrc/matern.cu``'s ``matern52_mean`` computes it."""
    ks = matern52_ref(x / ls, x_scaled, outputscale)
    return posterior_mean_from_matrix(ks, alpha, y_scale, y_mean)
