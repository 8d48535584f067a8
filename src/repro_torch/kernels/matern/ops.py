"""Wrapper of the Matérn-5/2 kernel (``csrc/matern.cu``).

:func:`matern52` is the drop-in for :func:`repro_torch.core.gp.matern52` in
the GP's posterior mean: the ARD scaling happens here, so the kernel stays
a pure geometry primitive.  For CUDA tensors it launches the kernel (and
raises if it cannot); for CPU tensors it runs the plain version.  It has no
backward: training uses the differentiable plain ``core.gp.matern52``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

from .ref import matern52_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"matern52": (_I, [_P] * 3 + [_I] * 3 + [_F, _P])}
LAUNCHES = build.counter("matern52")


def matern52_scaled(a: torch.Tensor, b: torch.Tensor, outputscale: float) -> torch.Tensor:
    """k(a, b) for pre-scaled inputs ``a`` (n, d) and ``b`` (m, d)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"want (n, d) x (m, d), got {tuple(a.shape)} x {tuple(b.shape)}")
    if a.device.type == "cpu":
        return matern52_ref(a, b, outputscale)
    for t in (a, b):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError("matern52: both inputs must lie on the same card")
        if t.dtype != torch.float32:
            raise TypeError(f"matern52: want float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("matern52: inputs must be contiguous")
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
