"""UM-Bridge-style model abstraction.

The port of the JAX package's ``core/model.py``.  The paper (Section 2.1)
abstracts a forward model as a map ``F: R^n -> R^m`` evaluated at
client-chosen points, optionally exposing derivative information
(Jacobians, gradients, Hessians).  :class:`Model` is anything with
``__call__(theta) -> obs``; :class:`TorchModel` wraps a PyTorch function on
one device (the counterpart of ``JaxModel``) and derives gradients and
Jacobians with ``torch.func``.

The port's CUDA kernels have no backward (the reference's Pallas kernels
have no VJP either): a gradient or Jacobian of a function that launches one
raises (:func:`repro_torch.kernels.build.require_plain`); nothing falls
back to the kernel's plain version.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@runtime_checkable
class Model(Protocol):
    """Minimal UM-Bridge model protocol: a map F: R^n -> R^m."""

    name: str

    def __call__(self, theta) -> Any:  # pragma: no cover - protocol
        ...


@dataclass
class ModelInfo:
    """Static metadata mirroring UM-Bridge's protocol negotiation."""

    name: str
    input_dim: int
    output_dim: int
    supports_gradient: bool = False
    supports_jacobian: bool = False
    supports_hessian: bool = False


class TorchModel:
    """A persistent PyTorch forward model on one device.

    ``fn`` maps one float32 ``theta`` tensor to its observables on
    ``device`` (the card unless the caller asks for the CPU).  Calls take
    numpy arrays, sequences or tensors, run on the model's device and
    return float32 tensors there, after the device has finished them (the
    counterpart of ``block_until_ready``), so a server's busy time covers
    the work.

    Parameters
    ----------
    fn: ``theta -> obs`` PyTorch function of one parameter vector.
    input_dim / output_dim: shapes of the abstract map.
    cost_s: optional *simulated* extra wall time, used by scheduling
        benchmarks to reproduce the paper's six-orders-of-magnitude
        heterogeneity on scaled problems.  ``0.0`` disables it.
    with_derivatives: expose :meth:`gradient` (``torch.func.grad`` of
        ``sum(fn(theta))``, as the reference differentiates ``jnp.sum``)
        and :meth:`jacobian` (``torch.func.jacfwd``).
    """

    def __init__(
        self,
        fn: Callable,
        *,
        name: str,
        input_dim: int,
        output_dim: int,
        cost_s: float = 0.0,
        with_derivatives: bool = True,
        device: DeviceLike = "cuda",
    ) -> None:
        self.name = name
        self.info = ModelInfo(
            name=name,
            input_dim=input_dim,
            output_dim=output_dim,
            supports_gradient=with_derivatives,
            supports_jacobian=with_derivatives,
            supports_hessian=with_derivatives,
        )
        self.cost_s = float(cost_s)
        self.device = resolve_device(device)
        self._fn = fn
        self._grad = (
            torch.func.grad(lambda t: torch.sum(fn(t))) if with_derivatives else None
        )
        self._jac = torch.func.jacfwd(fn) if with_derivatives else None
        self._batched = torch.func.vmap(fn)
        self.n_calls = 0
        self._lock = threading.Lock()

    def _tensor(self, theta) -> torch.Tensor:
        if not torch.is_tensor(theta):
            theta = np.asarray(theta, dtype=np.float32)
        return torch.as_tensor(theta, dtype=torch.float32, device=self.device)

    def _ready(self, out: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out

    # -- UM-Bridge protocol ------------------------------------------------
    def __call__(self, theta) -> torch.Tensor:
        with self._lock:
            self.n_calls += 1
        out = self._ready(self._fn(self._tensor(theta)))
        if self.cost_s > 0.0:
            time.sleep(self.cost_s)
        return out

    def evaluate_batch(self, thetas) -> torch.Tensor:
        """Batched evaluation (``torch.func.vmap`` of ``fn``): micro-task
        fusion beyond the paper."""
        with self._lock:
            self.n_calls += len(thetas)
        out = self._ready(self._batched(self._tensor(thetas)))
        if self.cost_s > 0.0:
            time.sleep(self.cost_s)
        return out

    def gradient(self, theta) -> torch.Tensor:
        if self._grad is None:
            raise NotImplementedError(f"{self.name} does not expose gradients")
        return self._ready(self._grad(self._tensor(theta)))

    def jacobian(self, theta) -> torch.Tensor:
        if self._jac is None:
            raise NotImplementedError(f"{self.name} does not expose Jacobians")
        return self._ready(self._jac(self._tensor(theta)))


@dataclass
class LogDensityModel:
    """Wraps a forward model + likelihood + prior into an unnormalised
    log-posterior, the object MCMC actually targets.

    ``log_density(theta) = log L(y | F(theta)) + log pi_0(theta)``
    """

    name: str
    forward: Callable
    log_likelihood: Callable  # obs -> float
    log_prior: Callable  # theta -> float

    def __call__(self, theta):
        theta = np.asarray(theta)
        lp = float(self.log_prior(theta))
        # Short-circuit -inf prior support without a forward solve.
        if np.isneginf(lp):
            return float("-inf")
        obs = self.forward(theta)
        return float(lp + self.log_likelihood(obs))
