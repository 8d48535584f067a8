"""MCMC diagnostics and the multilevel telescoping estimator (paper Eq. 7)."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def autocorrelation(x: np.ndarray, max_lag: int | None = None) -> np.ndarray:
    """Normalised autocorrelation of a 1-D chain via FFT."""
    x = np.asarray(x, dtype=float)
    n = len(x)
    if max_lag is None:
        max_lag = n // 2
    xc = x - x.mean()
    f = np.fft.rfft(xc, 2 * n)
    acf = np.fft.irfft(f * np.conj(f))[: max_lag + 1]
    denom = acf[0] if acf[0] > 0 else 1.0
    return acf / denom


def effective_sample_size(x: np.ndarray) -> float:
    """ESS via Geyer's initial positive sequence estimator."""
    x = np.asarray(x, dtype=float)
    n = len(x)
    if n < 4 or np.var(x) == 0:
        return float(n)
    rho = autocorrelation(x)
    # Geyer: sum consecutive pairs until a pair sum goes non-positive.
    tau = 1.0
    for k in range(1, len(rho) // 2):
        pair = rho[2 * k - 1] + rho[2 * k]
        if pair <= 0:
            break
        tau += 2.0 * pair
    return float(n / max(tau, 1.0))


def gelman_rubin(chains: np.ndarray, *, split: bool = True):
    """Split-R-hat across chains (Gelman et al., BDA3 §11.4).

    ``chains`` is ``(n_chains, n_samples)`` for scalar chains (returns a
    float, as before) or ``(n_chains, n_samples, dim)`` for vector chains
    (returns a ``(dim,)`` array — R-hat per coordinate).  With ``split``
    (default) each chain is halved first, so within-chain non-stationarity
    inflates the statistic instead of hiding in the within-chain variance;
    this also makes the single-chain case well-defined.  Pass
    ``split=False`` for the classic estimator (requires >= 2 chains, else
    NaN).
    """
    chains = np.asarray(chains, dtype=float)
    if chains.ndim == 2:
        return float(_rhat(chains[:, :, None], split)[0])
    if chains.ndim != 3:
        raise ValueError(
            f"chains must be (n_chains, n_samples[, dim]), got {chains.shape}"
        )
    return _rhat(chains, split)


def _rhat(chains: np.ndarray, split: bool) -> np.ndarray:
    m, n, d = chains.shape
    if split and n >= 4:
        half = n // 2
        chains = np.concatenate(
            [chains[:, :half], chains[:, n - half :]], axis=0
        )
        m, n = 2 * m, half
    if m < 2:
        return np.full(d, float("nan"))
    means = chains.mean(axis=1)  # (m, d)
    b = n * means.var(axis=0, ddof=1)
    w = chains.var(axis=1, ddof=1).mean(axis=0)
    var_plus = (n - 1) / n * w + b / n
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.sqrt(var_plus / w)
    return np.where(w == 0, 1.0, out)


def telescoping_estimate(level_samples: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
    """Multilevel telescoping-sum estimator (paper Eq. 7).

    E[phi_L] = E[phi_0] + sum_l (E[phi_l] - E[phi_{l-1}]), with the variance
    decomposition showing the per-level correction terms.  ``level_samples``
    is a list of (n_l, d) arrays coarse -> fine.
    """
    means = [np.asarray(s).mean(axis=0) for s in level_samples]
    variances = [np.asarray(s).var(axis=0) for s in level_samples]
    corrections = [means[0]] + [means[l] - means[l - 1] for l in range(1, len(means))]
    return {
        "level_means": np.stack(means),
        "level_variances": np.stack(variances),
        "corrections": np.stack(corrections),
        "telescoped_mean": np.sum(np.stack(corrections), axis=0),
    }


def variance_reduction_check(level_samples: Sequence[np.ndarray]) -> List[bool]:
    """Paper §6.1: variance should (weakly) decrease up the hierarchy."""
    v = [float(np.asarray(s).var(axis=0).mean()) for s in level_samples]
    return [v[i + 1] <= v[i] for i in range(len(v) - 1)]


def summarize_chain(chain: np.ndarray) -> Dict[str, object]:
    chain = np.atleast_2d(np.asarray(chain, dtype=float))
    if chain.shape[0] < chain.shape[1]:  # ensure (n, d)
        chain = chain.T
    return {
        "mean": chain.mean(axis=0).tolist(),
        "var": chain.var(axis=0).tolist(),
        "ess": [effective_sample_size(chain[:, j]) for j in range(chain.shape[1])],
        "n": int(chain.shape[0]),
    }
