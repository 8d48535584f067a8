"""Wrappers of the Matérn-5/2 kernels (``csrc/matern.cu``).

:func:`matern52_mean` is the GP's posterior mean at raw query points in one
launch: the level-0 path of :meth:`repro_torch.core.gp.GaussianProcess.predict`.
:func:`matern52_scaled` is the kernel matrix for pre-scaled inputs, which
the posterior variance needs; :func:`matern52` the same matrix with the ARD
scaling done here.  For CUDA tensors a wrapper launches its kernel (and
raises if it cannot); for CPU tensors it runs the plain version.  No wrapper
has a backward: training uses the differentiable plain ``core.gp.matern52``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

from .ref import matern52_mean_ref, matern52_ref, tree_width

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "matern52": (_I, [_P] * 3 + [_I] * 3 + [_F, _P]),
    "matern52_mean": (_I, [_P] * 7 + [_I] * 7 + [_F, _P]),
}
LAUNCHES = build.counter("matern52")
MEAN_LAUNCHES = build.counter("matern52_mean")
_BY_P = "matern52_mean p="
# The mean kernel's budget of shared memory for its summation trees: 48 KiB,
# what a block may take without opting in to more.
MEAN_SMEM_BYTES = 48 * 1024
# The most outputs a block takes when its trees' top levels run in
# registers (the kernel's kRegTile).
MEAN_REG_TILE = 4


def mean_plan(n: int, p: int) -> Tuple[int, int]:
    """How the mean kernel fits ``n`` training points and ``p`` outputs in
    its shared-memory budget: ``(qt, levels)``, blocks of ``qt`` outputs
    each, whose trees (``tree_width(n)`` terms) run their first ``levels``
    halving levels in registers.

    One tile and no register level wherever the whole tree fits, as at the
    main path's shape.  Otherwise tiles of at least ``MEAN_REG_TILE``
    outputs (or all ``p``), as even as the tile count allows, and as few
    register levels as make ``tree_width(n) / 2^levels * qt`` floats fit.
    """
    budget = MEAN_SMEM_BYTES // 4
    width = tree_width(n)
    if width * p <= budget:
        return p, 0
    qt = min(p, max(MEAN_REG_TILE, budget // width))
    tiles = -(-p // qt)
    qt = -(-p // tiles)
    levels = 0
    while (width >> levels) * qt > budget:
        levels += 1
    return qt, levels


def mean_launches_at(p: int) -> build.LaunchCounter:
    """The mean kernel's launches at ``p`` outputs (each launch also adds
    to ``MEAN_LAUNCHES``)."""
    return build.counter(f"{_BY_P}{p}")


def mean_launches_by_p() -> Dict[int, int]:
    """The mean kernel's launches counted so far, by output count p (the
    counts above 0)."""
    return {int(name[len(_BY_P):]): c.value for name, c in list(build.COUNTERS.items())
            if name.startswith(_BY_P) and c.value}


def _check_card(tensors, what: str) -> None:
    for t in tensors:
        if t.device.type != "cuda" or t.device != tensors[0].device:
            raise ValueError(f"{what}: all inputs must lie on the same card")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def matern52_scaled(a: torch.Tensor, b: torch.Tensor, outputscale: float) -> torch.Tensor:
    """k(a, b) for pre-scaled inputs ``a`` (n, d) and ``b`` (m, d)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"want (n, d) x (m, d), got {tuple(a.shape)} x {tuple(b.shape)}")
    if a.device.type == "cpu":
        return matern52_ref(a, b, outputscale)
    _check_card((a, b), "matern52")
    for t in (a, b):
        if t.dtype != torch.float32:
            raise TypeError(f"matern52: want float32, got {t.dtype}")
    n, d = a.shape
    m = b.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=a.device)
    lib = build.LIBRARY.load("matern", _SIGNATURES)
    err = lib.matern52(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, m, d, float(outputscale),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check_launch(err, "matern52")
    LAUNCHES.add()
    return out


def matern52_mean(
    x: torch.Tensor,
    ls: torch.Tensor,
    x_scaled: torch.Tensor,
    alpha: torch.Tensor,
    y_scale: torch.Tensor,
    y_mean: torch.Tensor,
    outputscale: float,
    plan: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Posterior mean (B, p) at raw points ``x`` (B, d): lengthscales ``ls``
    (d,), scaled training inputs ``x_scaled`` (n, d), ``alpha`` (n, p),
    ``y_scale`` and ``y_mean`` (p,).  Row ``i`` depends on ``x[i]`` alone.
    Every shape is taken: ``plan`` is ``mean_plan(n, p)``, which a caller
    with fixed n and p computes once (computed here when None)."""
    args = (x, ls, x_scaled, alpha, y_scale, y_mean)
    if x.ndim != 2 or x_scaled.ndim != 2 or alpha.ndim != 2:
        raise ValueError("matern52_mean: want x (B, d), x_scaled (n, d), alpha (n, p)")
    (B, d), (n, p) = x.shape, alpha.shape
    want = ((B, d), (d,), (n, d), (n, p), (p,), (p,))
    got = tuple(tuple(t.shape) for t in args)
    if got != want:
        raise ValueError(f"matern52_mean: want shapes {want}, got {got}")
    for t in args:
        if t.dtype != torch.float32:
            raise TypeError(f"matern52_mean: want float32, got {t.dtype}")
    if x.device.type == "cpu":
        return matern52_mean_ref(*args, outputscale)
    _check_card(args, "matern52_mean")
    out = torch.empty((B, p), dtype=torch.float32, device=x.device)
    qt, levels = plan or mean_plan(n, p)
    lib = build.LIBRARY.load("matern", _SIGNATURES)
    err = lib.matern52_mean(
        *(t.data_ptr() for t in args), out.data_ptr(), B, n, d, p, tree_width(n), qt,
        levels, float(outputscale), torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check_launch(err, "matern52_mean")
    MEAN_LAUNCHES.add()
    mean_launches_at(p).add()
    return out


def matern52(x1: torch.Tensor, x2: torch.Tensor, params) -> torch.Tensor:
    """Matérn-5/2 ARD kernel matrix ``k(x1, x2)``: (n, d) x (m, d) -> (n, m).

    ``params`` is a :class:`repro_torch.core.gp.GPParams`.
    """
    ls = torch.exp(params.log_lengthscales)
    a = (x1 / ls).contiguous()
    b = (x2 / ls).contiguous()
    if a.device.type == "cpu":
        return matern52_ref(a, b, torch.exp(params.log_outputscale))
    return matern52_scaled(a, b, float(torch.exp(params.log_outputscale)))
