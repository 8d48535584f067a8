"""Metropolis-Hastings and proposal distributions (paper §5, Algorithm 2's
building block).  These are the *client-side* samplers: forward-model
evaluations inside the log-posterior may be routed through the load balancer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


# --------------------------------------------------------------------------
# Proposals
# --------------------------------------------------------------------------
class Proposal:
    """q(. | theta). Symmetric proposals return 0 from log_ratio."""

    def sample(self, rng: np.random.Generator, theta: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def log_ratio(self, theta_new: np.ndarray, theta_old: np.ndarray) -> float:
        return 0.0  # symmetric by default

    def state(self) -> Dict[str, Any]:
        return {}

    def restore(self, state: Dict[str, Any]) -> None:
        pass


@dataclass
class GaussianRandomWalk(Proposal):
    """Random-walk Metropolis proposal with (optionally per-dim) scale."""

    scale: Any = 1.0

    def sample(self, rng, theta):
        return theta + rng.normal(size=theta.shape) * np.asarray(self.scale)


@dataclass
class AdaptiveMetropolis(Proposal):
    """Haario-style adaptive random walk: covariance adapted from history.

    Adaptation freezes information into the scale matrix; it is standard for
    MLDA coarse chains (tinyDA exposes the same).
    """

    dim: int = 2
    s_d: float = 0.0  # 2.38^2/d by default, set in __post_init__
    eps: float = 1e-8
    adapt_start: int = 100
    _mean: np.ndarray = field(default=None, repr=False)
    _cov: np.ndarray = field(default=None, repr=False)
    _n: int = 0

    def __post_init__(self):
        if self.s_d == 0.0:
            self.s_d = 2.38**2 / self.dim
        if self._mean is None:
            self._mean = np.zeros(self.dim)
        if self._cov is None:
            self._cov = np.eye(self.dim)

    def update(self, theta: np.ndarray) -> None:
        self._n += 1
        w = 1.0 / self._n
        delta = theta - self._mean
        self._mean = self._mean + w * delta
        self._cov = self._cov + w * (np.outer(delta, theta - self._mean) - self._cov)

    def sample(self, rng, theta):
        if self._n < self.adapt_start:
            return theta + rng.normal(size=theta.shape) * 0.1
        cov = self.s_d * self._cov + self.s_d * self.eps * np.eye(self.dim)
        return rng.multivariate_normal(theta, cov)

    def state(self):
        return {"mean": self._mean.tolist(), "cov": self._cov.tolist(), "n": self._n}

    def restore(self, state):
        self._mean = np.asarray(state["mean"])
        self._cov = np.asarray(state["cov"])
        self._n = int(state["n"])


@dataclass
class PCNProposal(Proposal):
    """Preconditioned Crank-Nicolson for Gaussian priors (dimension-robust)."""

    beta: float = 0.2
    prior_mean: Any = 0.0
    prior_std: Any = 1.0

    def sample(self, rng, theta):
        mu = np.asarray(self.prior_mean)
        sd = np.asarray(self.prior_std)
        xi = rng.normal(size=theta.shape) * sd
        return mu + np.sqrt(1 - self.beta**2) * (theta - mu) + self.beta * xi

    def log_ratio(self, theta_new, theta_old):
        # pCN is reversible w.r.t. the prior; the ratio cancels the prior term.
        return 0.0


# --------------------------------------------------------------------------
# Metropolis-Hastings kernel
# --------------------------------------------------------------------------
@dataclass
class ChainStats:
    n_proposed: int = 0
    n_accepted: int = 0
    n_evals: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.n_accepted / max(self.n_proposed, 1)


def mh_step_steps(
    eval_steps: Callable,
    proposal: Proposal,
    rng: np.random.Generator,
    theta: np.ndarray,
    logp: float,
    stats: Optional[ChainStats] = None,
):
    """Generator form of one MH transition (the step-machine building block).

    ``eval_steps(cand)`` must be a sub-generator that yields pending
    density-evaluation actions (see :class:`repro_torch.core.mlda.PendingEval`)
    and returns the log-density — the blocking :func:`mh_step` drives it
    eagerly, the MLDA step machine forwards its yields to an async driver.
    The RNG draw order (proposal sample, then accept uniform) is identical
    to the blocking path, so chains are bit-for-bit reproducible either way.

    Returns ``(theta', logp', accepted)`` via ``StopIteration.value``.
    """
    cand = np.asarray(proposal.sample(rng, theta))
    logp_cand = yield from eval_steps(cand)
    if stats is not None:
        stats.n_proposed += 1
        stats.n_evals += 1
    log_alpha = float(logp_cand) - logp + proposal.log_ratio(cand, theta)
    if np.log(rng.uniform()) < log_alpha:
        if stats is not None:
            stats.n_accepted += 1
        return cand, float(logp_cand), True
    return theta, logp, False


def mh_step(
    log_post: Callable[[np.ndarray], float],
    proposal: Proposal,
    rng: np.random.Generator,
    theta: np.ndarray,
    logp: float,
    stats: Optional[ChainStats] = None,
) -> Tuple[np.ndarray, float, bool]:
    """One MH transition; returns (theta', logp', accepted)."""

    def eval_now(cand):
        return float(log_post(cand))
        yield  # unreachable — marks this as a sub-generator for yield-from

    gen = mh_step_steps(eval_now, proposal, rng, theta, logp, stats)
    try:
        next(gen)
    except StopIteration as e:
        return e.value
    raise RuntimeError("mh_step_steps yielded despite an eager evaluator")


def metropolis_hastings(
    log_post: Callable[[np.ndarray], float],
    proposal: Proposal,
    theta0: np.ndarray,
    n_steps: int,
    rng: np.random.Generator,
    *,
    logp0: Optional[float] = None,
    adapt: bool = False,
) -> Tuple[np.ndarray, np.ndarray, ChainStats]:
    """Plain MH chain (paper's level-0 recursion base, Algorithm 2 line 5)."""
    theta = np.asarray(theta0, dtype=float)
    logp = float(log_post(theta)) if logp0 is None else float(logp0)
    stats = ChainStats(n_evals=0 if logp0 is not None else 1)
    chain = np.empty((n_steps, theta.size))
    logps = np.empty(n_steps)
    for i in range(n_steps):
        theta, logp, _ = mh_step(log_post, proposal, rng, theta, logp, stats)
        if adapt and isinstance(proposal, AdaptiveMetropolis):
            proposal.update(theta)
        chain[i] = theta
        logps[i] = logp
    return chain, logps, stats
