"""MALA — gradient-based MCMC through UM-Bridge's derivative protocol.

The port of the JAX package's ``core/mala.py``.  The paper's §7 names
'evaluating the load balancer on gradient-based MCMC methods that place
additional heterogeneous demands on the scheduler' as future work; this
implements it.  The Metropolis-adjusted Langevin proposal

    theta' = theta + (eps^2/2) * grad log pi(theta) + eps * xi

needs both a density and a gradient evaluation per step — two request
*kinds* per model level, which is exactly the extra scheduling heterogeneity
the paper anticipates.  ``BalancedGradDensity`` routes value and gradient
requests through the balancer under different tags so they can be served by
different pools.  Gradients come from ``torch.func.grad`` of the forward
model (:meth:`repro_torch.core.model.TorchModel.gradient`), matching
UM-Bridge's Jacobian/gradient exchange (§2.1); a gradient that comes back
as a tensor (on the card or the CPU) is copied to the host here.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.balancer import LoadBalancer
from .mh import ChainStats


def _on_host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class BalancedGradDensity:
    """(log pi, grad log pi) with forward/gradient solves via the balancer."""

    def __init__(
        self,
        balancer: LoadBalancer,
        tag: str,
        log_density: Callable[[np.ndarray], float],
        grad_log_density: Callable[[np.ndarray], np.ndarray],
    ) -> None:
        self.balancer = balancer
        self.tag = tag
        self._value_fn = log_density
        self._grad_fn = grad_log_density

    def value(self, theta) -> float:
        return float(self.balancer.submit(theta, tag=f"{self.tag}:value"))

    def grad(self, theta) -> np.ndarray:
        return _on_host(self.balancer.submit(theta, tag=f"{self.tag}:grad"))


def mala_step(
    value_fn: Callable[[np.ndarray], float],
    grad_fn: Callable[[np.ndarray], np.ndarray],
    rng: np.random.Generator,
    theta: np.ndarray,
    logp: float,
    glog: np.ndarray,
    eps: float,
    stats: Optional[ChainStats] = None,
) -> Tuple[np.ndarray, float, np.ndarray, bool]:
    """One MALA transition with the exact asymmetric MH correction."""
    e2 = eps * eps
    mean_fwd = theta + 0.5 * e2 * glog
    cand = mean_fwd + eps * rng.standard_normal(theta.shape)
    logp_c = float(value_fn(cand))
    if not np.isfinite(logp_c):
        if stats is not None:
            stats.n_proposed += 1
            stats.n_evals += 1
        return theta, logp, glog, False
    glog_c = _on_host(grad_fn(cand))
    mean_rev = cand + 0.5 * e2 * glog_c
    # q(theta | cand) / q(cand | theta)
    log_q_rev = -float(np.sum((theta - mean_rev) ** 2)) / (2 * e2)
    log_q_fwd = -float(np.sum((cand - mean_fwd) ** 2)) / (2 * e2)
    log_alpha = (logp_c - logp) + (log_q_rev - log_q_fwd)
    if stats is not None:
        stats.n_proposed += 1
        stats.n_evals += 2  # value + gradient
    if np.log(rng.uniform()) < log_alpha:
        if stats is not None:
            stats.n_accepted += 1
        return cand, logp_c, glog_c, True
    return theta, logp, glog, False


def mala(
    value_fn: Callable[[np.ndarray], float],
    grad_fn: Callable[[np.ndarray], np.ndarray],
    theta0: np.ndarray,
    n_steps: int,
    rng: np.random.Generator,
    *,
    eps: float = 0.5,
    adapt_target: Optional[float] = 0.57,  # MALA's optimal acceptance
) -> Tuple[np.ndarray, ChainStats]:
    """MALA chain with optional Robbins-Monro step-size adaptation."""
    theta = np.asarray(theta0, dtype=float)
    logp = float(value_fn(theta))
    glog = _on_host(grad_fn(theta))
    stats = ChainStats(n_evals=2)
    chain = np.empty((n_steps, theta.size))
    log_eps = np.log(eps)
    for i in range(n_steps):
        theta, logp, glog, accepted = mala_step(
            value_fn, grad_fn, rng, theta, logp, glog, float(np.exp(log_eps)), stats
        )
        if adapt_target is not None and i < n_steps // 2:
            log_eps += (float(accepted) - adapt_target) / max(i + 1, 10) ** 0.6
        chain[i] = theta
    return chain, stats
