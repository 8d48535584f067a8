"""Gaussian-process surrogate (paper §6.1, level 0 of the MLDA hierarchy).

The port of the JAX package's ``core/gp.py``: Matérn-5/2 kernel, zero
mean, one lengthscale per input dimension (ARD), hyperparameters fitted by
Adam on the marginal likelihood; vector-valued outputs share one kernel.

Training (:func:`fit_gp`, :func:`neg_log_marginal_likelihood`) runs the
plain, differentiable :func:`matern52` through autograd.  Prediction
(:meth:`GaussianProcess.predict`) goes through
:mod:`repro_torch.kernels.matern`: the posterior mean in one kernel launch
on the card, the kernel matrix as well where the variance is asked for;
their plain versions on the CPU.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.matern import ops as matern_ops

SQRT5 = math.sqrt(5.0)
NOISE_FLOOR = 1e-5  # keeps fp32 Cholesky well-conditioned on normalised y
JITTER_LADDER = (1e-4, 1e-3, 1e-2, 1e-1)


class GPParams(NamedTuple):
    log_lengthscales: torch.Tensor  # (d,) ARD
    log_outputscale: torch.Tensor  # ()
    log_noise: torch.Tensor  # ()


def matern52(x1: torch.Tensor, x2: torch.Tensor, params: GPParams) -> torch.Tensor:
    """Matérn-5/2 ARD kernel matrix k(x1, x2): (n, d) x (m, d) -> (n, m).

    Plain and differentiable, in the reference's expanded form
    ``|a|^2 + |b|^2 - 2 a.b``.
    """
    ls = torch.exp(params.log_lengthscales)
    a = x1 / ls
    b = x2 / ls
    d2 = torch.sum(a * a, -1)[:, None] + torch.sum(b * b, -1)[None, :] - 2.0 * a @ b.T
    d2 = torch.clamp_min(d2, 0.0)
    # The double where keeps the gradient of sqrt finite at d2 == 0.
    safe = torch.where(d2 > 1e-24, d2, 1.0)
    d = torch.where(d2 > 1e-24, torch.sqrt(safe), 0.0)
    s = SQRT5 * d
    return torch.exp(params.log_outputscale) * (1.0 + s + s * s / 3.0) * torch.exp(-s)


def neg_log_marginal_likelihood(
    params: GPParams, x: torch.Tensor, y: torch.Tensor, jitter: float = 1e-5
) -> torch.Tensor:
    """-log p(y | x, params); y may be (n,) or (n, p) (independent outputs).

    A kernel matrix that does not factorise gives NaN, as the reference's
    Cholesky does (``torch.linalg.cholesky`` would raise instead).
    """
    n = x.shape[0]
    y2 = y if y.ndim == 2 else y[:, None]
    noise = NOISE_FLOOR + torch.exp(params.log_noise)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    k = matern52(x, x, params) + (noise + jitter) * eye
    chol, info = torch.linalg.cholesky_ex(k)
    alpha = torch.cholesky_solve(y2, chol)
    p = y2.shape[1]
    quad = torch.sum(y2 * alpha)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    nll = 0.5 * quad + 0.5 * p * logdet + 0.5 * n * p * math.log(2.0 * math.pi)
    return torch.where(info == 0, nll, torch.nan)


@dataclass
class GaussianProcess:
    """Trained GP surrogate; construct via :func:`fit_gp` or
    :func:`gp_from_arrays`."""

    x_train: torch.Tensor  # (n, d)
    y_train: torch.Tensor  # (n, p)
    y_mean: torch.Tensor  # (p,) outputs are centred (zero-mean GP)
    y_scale: torch.Tensor  # (p,)
    params: GPParams
    chol: torch.Tensor  # (n, n)
    alpha: torch.Tensor  # (n, p)
    # Prediction constants, fixed once the parameters are: the lengthscales,
    # the scaled training inputs, the output scale as a host float (no
    # per-call launch or sync) and the mean kernel's plan for (n, p).
    _ls: torch.Tensor = field(init=False, repr=False)
    _x_scaled: torch.Tensor = field(init=False, repr=False)
    _outputscale: float = field(init=False, repr=False)
    _mean_plan: tuple = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self._ls = torch.exp(self.params.log_lengthscales).contiguous()
        self._x_scaled = (self.x_train / self._ls).contiguous()
        self._outputscale = float(torch.exp(self.params.log_outputscale))
        self._mean_plan = (matern_ops.mean_plan(*self.alpha.shape)
                           if self.alpha.ndim == 2 else None)
        self.alpha, self.y_scale, self.y_mean = (
            t.contiguous() for t in (self.alpha, self.y_scale, self.y_mean)
        )

    @property
    def device(self) -> torch.device:
        return self.x_train.device

    def to(self, device: DeviceLike) -> "GaussianProcess":
        """This GP on ``device`` (itself if it is there already).  The copy's
        prediction constants are copies of this GP's, not recomputed there,
        so both compute the same bits: a sharded level-0 pool's rows do not
        depend on the device that ran them."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev == self.device:
            return self
        gp = copy.copy(self)
        for name in ("x_train", "y_train", "y_mean", "y_scale", "chol", "alpha",
                     "_ls", "_x_scaled"):
            setattr(gp, name, getattr(self, name).to(dev))
        gp.params = GPParams(*(p.to(dev) for p in self.params))
        return gp

    def predict(self, x: torch.Tensor, return_var: bool = False):
        """Posterior mean (and variance) at x: (m, d) -> (m, p)."""
        x = torch.atleast_2d(x.to(device=self.device, dtype=torch.float32)).contiguous()
        # One launch on the card; a row does not depend on the number of rows
        # (batched results equal per-request results bit for bit).
        mean = matern_ops.matern52_mean(
            x, self._ls, self._x_scaled, self.alpha, self.y_scale, self.y_mean,
            self._outputscale, self._mean_plan,
        )
        if not return_var:
            return mean
        a = (x / self._ls).contiguous()
        ks = matern_ops.matern52_scaled(a, self._x_scaled, self._outputscale)
        v = torch.linalg.solve_triangular(self.chol, ks.T, upper=False)
        kss = torch.exp(self.params.log_outputscale)
        var = torch.clamp_min(kss - torch.sum(v * v, dim=0), 1e-12)
        return mean, var[:, None] * self.y_scale**2

    def __call__(self, theta: torch.Tensor) -> torch.Tensor:
        """UM-Bridge model interface: single-point evaluation."""
        return self.predict(torch.atleast_2d(theta))[0]

    def batch_call(self, thetas: torch.Tensor) -> torch.Tensor:
        """Batched posterior mean for a stacked ``(B, d)`` parameter array:
        the level-0 ``BatchServer`` handler.  Row ``i`` is bit-identical to
        ``__call__(thetas[i])`` whatever ``B`` is."""
        return self.predict(torch.atleast_2d(thetas))


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    # jnp.median averages the two middle values of an even count;
    # torch.median returns the lower one.  quantile(0.5) interpolates.
    return torch.quantile(x, 0.5, dim=dim)


def fit_gp(
    x,
    y,
    *,
    steps: int = 200,
    lr: float = 0.05,
    jitter: float = 1e-5,
    init_noise: float = 1e-2,
    device: DeviceLike = "cuda",
) -> GaussianProcess:
    """ML-II hyperparameter optimisation by Adam on the marginal likelihood.

    ``x`` (n, d) and ``y`` (n,) or (n, p) may be numpy arrays or tensors;
    they are cast to float32 on ``device``.  Adam runs through autograd
    with global-norm clipping; a step whose loss or new parameters are not
    finite (a failed Cholesky) is rejected and the previous parameters
    kept.  The final factorisation climbs a jitter ladder until it succeeds.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    y = torch.as_tensor(np.asarray(y) if not torch.is_tensor(y) else y)
    x = x.to(device=dev, dtype=torch.float32)
    y = y.to(device=dev, dtype=torch.float32)
    y2 = y if y.ndim == 2 else y[:, None]
    y_mean = torch.mean(y2, dim=0)
    y_scale = torch.clamp_min(torch.std(y2, dim=0, correction=0), 1e-12)
    y_n = (y2 - y_mean) / y_scale

    # Median-heuristic lengthscale init.
    med = torch.clamp_min(_median(torch.abs(x - _median(x, 0)), 0), 1e-3)
    params = [
        torch.log(med * 2.0),
        torch.zeros((), device=dev),
        torch.log(torch.tensor(init_noise, dtype=torch.float32, device=dev)),
    ]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8

    for t in range(1, steps + 1):
        leaves = [p.detach().requires_grad_(True) for p in params]
        loss = neg_log_marginal_likelihood(GPParams(*leaves), x, y_n, jitter)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            # Clip the global gradient norm: ML-II objectives have cliffs
            # where the kernel matrix nears singularity.
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp_max(10.0 / (gnorm + 1e-12), 1.0)
            grads = [g * scale for g in grads]
            m = [b1 * a + (1 - b1) * g for a, g in zip(m, grads)]
            v = [b2 * a + (1 - b2) * g * g for a, g in zip(v, grads)]
            new = [
                p - lr * (a / (1 - b1**t)) / (torch.sqrt(c / (1 - b2**t)) + eps)
                for p, a, c in zip(params, m, v)
            ]
            # Reject non-finite steps on the device (no host sync per step).
            ok = torch.isfinite(loss) & torch.stack(
                [torch.all(torch.isfinite(p)) for p in new]
            ).all()
            params = [torch.where(ok, a, b) for a, b in zip(new, params)]

    params = GPParams(*params)
    n = x.shape[0]
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    with torch.no_grad():
        noise = NOISE_FLOOR + torch.exp(params.log_noise)
        k0 = matern52(x, x, params)
        # Adaptive jitter ladder: the smallest jitter that factorises cleanly
        # in fp32 (standard GPML practice).
        chol = None
        for j in (jitter, *JITTER_LADDER):
            c, info = torch.linalg.cholesky_ex(k0 + (noise + j) * eye)
            if int(info) == 0 and bool(torch.all(torch.isfinite(c))):
                chol = c
                break
        if chol is None:
            raise FloatingPointError("GP kernel matrix could not be factorised")
        alpha = torch.cholesky_solve(y_n, chol)
    return GaussianProcess(
        x_train=x, y_train=y2, y_mean=y_mean, y_scale=y_scale,
        params=params, chol=chol, alpha=alpha,
    )


GP_FIELDS = (
    "x_train", "y_train", "y_mean", "y_scale", "log_lengthscales",
    "log_outputscale", "log_noise", "chol", "alpha",
)


def gp_from_arrays(d: Dict[str, np.ndarray], device: DeviceLike = "cuda") -> GaussianProcess:
    """A :class:`GaussianProcess` from another implementation's fitted
    fields as numpy arrays (the keys of :data:`GP_FIELDS`), cast to float32
    on ``device``: the surrogate's "weights"."""
    dev = resolve_device(device)
    missing = [k for k in GP_FIELDS if k not in d]
    if missing:
        raise KeyError(f"gp_from_arrays: missing fields {missing}")
    t = {k: torch.tensor(np.asarray(d[k], dtype=np.float32), device=dev) for k in GP_FIELDS}
    return GaussianProcess(
        x_train=t["x_train"],
        y_train=t["y_train"],
        y_mean=t["y_mean"],
        y_scale=t["y_scale"],
        params=GPParams(t["log_lengthscales"], t["log_outputscale"], t["log_noise"]),
        chol=t["chol"],
        alpha=t["alpha"],
    )
