"""Plain reference of the paper's Tōhoku inversion, in any floating dtype.

A frozen copy of the port's plain shallow-water model (first-order
hydrostatic reconstruction with a Rusanov flux and forward Euler, Audusse
et al. 2004), of its synthetic Tōhoku scenario (domain, bathymetry, bump,
probes, observation operator) and of its Matérn-5/2 GP surrogate (Adam on
the marginal likelihood, 512 Latin-hypercube level-1 solves), written here
so that a later change to the program cannot change the yardstick.  It
imports nothing of the program.  Every function is vectorised over a
leading batch axis; the dtype of the inputs is the dtype of the whole
computation (float64 for the reference, bfloat16 for the control).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

G = 9.81
H_EPS = 1e-3
SQRT2 = math.sqrt(2.0)
SQRT5 = math.sqrt(5.0)
KM = 1000.0
DOMAIN_X = (-499.0, 1299.0)
DOMAIN_Y = (-949.0, 849.0)
PRIOR_LO = np.array([-200.0, -200.0])
PRIOR_HI = np.array([200.0, 200.0])
PROBES_KM = ((480.0, 380.0), (700.0, -420.0))
AMPLITUDE = 5.0
SIGMA_KM = 60.0
ARRIVAL_THRESHOLD = 0.05
CFL = 0.45
U_MARGIN = 15.0
# Likelihood: noise of [hmax_1, tarr_1, hmax_2, tarr_2] and the synthetic
# observations' source and noise seed (paper §4).
NOISE_SIGMA = np.array([0.04, 0.012, 0.04, 0.012])
THETA_TRUE = (0.0, 0.0)
OBS_SEED = 1234
# GP surrogate training (paper §6.1).
NOISE_FLOOR = 1e-5
JITTER_LADDER = (1e-4, 1e-3, 1e-2, 1e-1)
LHS_SEED = 0
GP_BATCH = 64


# ---------------------------------------------------------------------------
# Shallow-water step
# ---------------------------------------------------------------------------
def _velocity(h, hq, eps=H_EPS):
    h2 = h * h
    h4 = h2 * h2
    return SQRT2 * h * hq / torch.sqrt(h4 + torch.clamp_min(h4, eps**4))


def _flux(hL, uL, vL, hR, uR, vR, g):
    huL, hvL = hL * uL, hL * vL
    huR, hvR = hR * uR, hR * vR
    cL = torch.abs(uL) + torch.where(hL > 0, torch.sqrt(g * torch.where(hL > 0, hL, 1.0)), 0.0)
    cR = torch.abs(uR) + torch.where(hR > 0, torch.sqrt(g * torch.where(hR > 0, hR, 1.0)), 0.0)
    a = torch.maximum(cL, cR)
    f0 = 0.5 * (huL + huR) - 0.5 * a * (hR - hL)
    f1 = 0.5 * (huL * uL + huR * uR) - 0.5 * a * (huR - huL)
    f2 = 0.5 * (hvL * uL + hvR * uR) - 0.5 * a * (hvR - hvL)
    return f0, f1, f2


def _pad(q):
    return torch.cat([q[..., :1], q, q[..., -1:]], dim=-1)


def _x_update(h, hu, hv, b, dx, g):
    hp, hup, hvp, bp = _pad(h), _pad(hu), _pad(hv), _pad(b)
    bL, bR = bp[..., :-1], bp[..., 1:]
    bstar = torch.maximum(bL, bR)
    hL = torch.clamp_min(hp[..., :-1] + bL - bstar, 0.0)
    hR = torch.clamp_min(hp[..., 1:] + bR - bstar, 0.0)
    uL = _velocity(hp[..., :-1], hup[..., :-1])
    vL = _velocity(hp[..., :-1], hvp[..., :-1])
    uR = _velocity(hp[..., 1:], hup[..., 1:])
    vR = _velocity(hp[..., 1:], hvp[..., 1:])
    f0, f1, f2 = _flux(hL, uL, vL, hR, uR, vR, g)
    dh = f0[..., 1:] - f0[..., :-1]
    dhu = f1[..., 1:] - f1[..., :-1]
    dhv = f2[..., 1:] - f2[..., :-1]
    hLr, hRr, hLl, hRl = hL[..., 1:], hR[..., 1:], hL[..., :-1], hR[..., :-1]
    dhu = dhu + 0.25 * g * ((hRr - hLr) * (hRr + hLr) + (hRl - hLl) * (hRl + hLl))
    return dh / dx, dhu / dx, dhv / dx


def _y_update(h, hu, hv, b, dy, g):
    T = lambda q: q.transpose(-1, -2)  # noqa: E731
    dh, dhv, dhu = _x_update(T(h), T(hv), T(hu), T(b), dy, g)
    return T(dh), T(dhu), T(dhv)


def swe_step(h, hu, hv, b, dx, dy, dt, g=G):
    """One forward-Euler step of the well-balanced scheme."""
    dhx, dhux, dhvx = _x_update(h, hu, hv, b, dx, g)
    dhy, dhuy, dhvy = _y_update(h, hu, hv, b, dy, g)
    h_new = torch.clamp_min(h - dt * (dhx + dhy), 0.0)
    hu_new = hu - dt * (dhux + dhuy)
    hv_new = hv - dt * (dhvx + dhvy)
    wet = h_new > H_EPS
    return h_new, torch.where(wet, hu_new, 0.0), torch.where(wet, hv_new, 0.0)


# ---------------------------------------------------------------------------
# Scenario
# ---------------------------------------------------------------------------
@dataclass
class Grid:
    """One level's grid of the scenario, its bathymetry, probes and steps."""

    nx: int
    ny: int
    t_end: float
    dtype: torch.dtype
    device: torch.device

    def __post_init__(self) -> None:
        f64 = dict(dtype=torch.float64, device=self.device)
        x = torch.linspace(DOMAIN_X[0], DOMAIN_X[1], self.nx + 1, **f64)
        y = torch.linspace(DOMAIN_Y[0], DOMAIN_Y[1], self.ny + 1, **f64)
        xc, yc = 0.5 * (x[:-1] + x[1:]), 0.5 * (y[:-1] + y[1:])
        Y, X = torch.meshgrid(yc, xc, indexing="ij")
        shelf = 6950.0 * torch.exp(-(((X - DOMAIN_X[0]) / 220.0) ** 2))
        trench = -1500.0 * torch.exp(-(((X - 120.0) / 90.0) ** 2))
        ridge = 800.0 * torch.exp(-(((X - 700.0) / 260.0) ** 2 + ((Y - 250.0) / 330.0) ** 2))
        b = torch.where(X < DOMAIN_X[0] + 40.0, 50.0, -7000.0 + shelf + trench + ridge)
        self.X, self.Y = X.to(self.dtype), Y.to(self.dtype)
        self.b = b.to(self.dtype)
        self.h_rest = torch.clamp_min(-self.b, 0.0)
        self.dx = (DOMAIN_X[1] - DOMAIN_X[0]) * KM / self.nx
        self.dy = (DOMAIN_Y[1] - DOMAIN_Y[0]) * KM / self.ny
        h_max = float(torch.clamp_min(-b, 0.0).max())
        self.dt = CFL * min(self.dx, self.dy) / (math.sqrt(G * max(h_max, 1.0)) + U_MARGIN)
        self.n_steps = int(math.ceil(self.t_end / self.dt))
        self.probes = [(int(torch.argmin(torch.abs(yc - py))), int(torch.argmin(torch.abs(xc - px))))
                       for px, py in PROBES_KM]

    def bump(self, thetas: torch.Tensor) -> torch.Tensor:
        """(B, 2) source centres (km) -> (B, ny, nx) initial displacements."""
        t = thetas.to(self.dtype)[:, :, None, None]
        r2 = ((self.X - t[:, 0]) ** 2 + (self.Y - t[:, 1]) ** 2) / SIGMA_KM**2
        return AMPLITUDE * torch.exp(-0.5 * r2)

    def series(self, thetas: torch.Tensor) -> torch.Tensor:
        """(B, 2) -> (B, n_steps, n_probes) sea-surface height at the probes."""
        eta0 = self.bump(thetas)
        h = torch.clamp_min(self.h_rest + eta0, 0.0)
        h = torch.where(self.h_rest > H_EPS, h, self.h_rest.expand_as(h))
        hu = torch.zeros_like(h)
        hv = torch.zeros_like(h)
        pi = torch.tensor([p[0] for p in self.probes], device=self.device)
        pj = torch.tensor([p[1] for p in self.probes], device=self.device)
        b_probe = self.b[pi, pj]
        out = torch.empty((h.shape[0], self.n_steps, len(self.probes)), dtype=self.dtype,
                          device=self.device)
        for t in range(self.n_steps):
            h, hu, hv = swe_step(h, hu, hv, self.b, self.dx, self.dy, self.dt)
            out[:, t] = h[:, pi, pj] + b_probe
        return out

    def observables(self, thetas: torch.Tensor, batch: int = 64) -> torch.Tensor:
        """(B, 2) -> (B, 4): [hmax_1, t_arrival_1, hmax_2, t_arrival_2]."""
        rows = []
        for i in range(0, thetas.shape[0], batch):
            rows.append(observe(self.series(thetas[i:i + batch]), self.dt, self.n_steps))
        return torch.cat(rows)


def observe(series: torch.Tensor, dt: float, n_steps: int) -> torch.Tensor:
    """(B, T, P) -> (B, 4): each probe's largest height and its soft arrival
    time (the first crossing of the threshold), over the simulated time."""
    hmax = torch.amax(series, dim=1)
    k = 40.0 / ARRIVAL_THRESHOLD
    not_yet = torch.cumprod(1.0 - torch.sigmoid(k * (series - ARRIVAL_THRESHOLD)), dim=1)
    t_arr = torch.sum(not_yet, dim=1) * dt / (n_steps * dt)
    return torch.stack([hmax[:, 0], t_arr[:, 0], hmax[:, 1], t_arr[:, 1]], dim=1)


# ---------------------------------------------------------------------------
# GP surrogate
# ---------------------------------------------------------------------------
def latin_hypercube(n: int, d: int, seed: int = LHS_SEED) -> torch.Tensor:
    """n points in [0, 1]^d, one a stratum a dimension (float32, CPU)."""
    gen = torch.Generator().manual_seed(seed)
    perms = torch.stack([torch.randperm(n, generator=gen) for _ in range(d)], dim=1)
    return (perms + torch.rand((n, d), generator=gen)) / n


def lhs_design(n: int) -> torch.Tensor:
    """The GP's training inputs: LHS draws over the prior box, float32."""
    u = latin_hypercube(n, 2)
    lo = torch.as_tensor(PRIOR_LO, dtype=u.dtype)
    hi = torch.as_tensor(PRIOR_HI, dtype=u.dtype)
    return lo + u * (hi - lo)


def _matern(a: torch.Tensor, b: torch.Tensor, outputscale) -> torch.Tensor:
    """k(a, b) of pre-scaled inputs (n, d) x (m, d) by direct differences."""
    diff = a[:, None, :] - b[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    safe = torch.where(d2 > 1e-24, d2, 1.0)
    r = torch.where(d2 > 1e-24, torch.sqrt(safe), 0.0)
    s = SQRT5 * r
    return outputscale * (1.0 + s + s * s / 3.0) * torch.exp(-s)


def _matern_train(x1, x2, log_ls, log_os):
    ls = torch.exp(log_ls)
    a, b = x1 / ls, x2 / ls
    d2 = torch.sum(a * a, -1)[:, None] + torch.sum(b * b, -1)[None, :] - 2.0 * a @ b.T
    d2 = torch.clamp_min(d2, 0.0)
    safe = torch.where(d2 > 1e-24, d2, 1.0)
    d = torch.where(d2 > 1e-24, torch.sqrt(safe), 0.0)
    s = SQRT5 * d
    return torch.exp(log_os) * (1.0 + s + s * s / 3.0) * torch.exp(-s)


def _nll(params, x, y, jitter):
    log_ls, log_os, log_noise = params
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    k = _matern_train(x, x, log_ls, log_os) + (NOISE_FLOOR + torch.exp(log_noise) + jitter) * eye
    chol, info = torch.linalg.cholesky_ex(k)
    alpha = torch.cholesky_solve(y, chol)
    p = y.shape[1]
    nll = (0.5 * torch.sum(y * alpha) + p * torch.sum(torch.log(torch.diagonal(chol)))
           + 0.5 * n * p * math.log(2.0 * math.pi))
    return torch.where(info == 0, nll, torch.nan)


@dataclass
class GP:
    x_scaled: torch.Tensor
    ls: torch.Tensor
    outputscale: float
    alpha: torch.Tensor
    y_mean: torch.Tensor
    y_scale: torch.Tensor

    def mean(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Posterior mean (B, p) at (B, d), computed in ``dtype`` (the GP's
        own by default)."""
        dt = dtype or self.alpha.dtype
        cast = lambda t: t.to(dt)  # noqa: E731
        ks = _matern(cast(x.to(self.ls.dtype) / self.ls), cast(self.x_scaled), self.outputscale)
        return (ks @ cast(self.alpha)) * cast(self.y_scale) + cast(self.y_mean)


def fit_gp(x: torch.Tensor, y: torch.Tensor, *, steps: int, lr: float = 0.05,
           jitter: float = 1e-5, init_noise: float = 1e-2) -> GP:
    """ML-II by Adam with global-norm clipping 10, non-finite steps
    rejected, median-heuristic lengthscales; the final factorisation takes
    the smallest jitter of the ladder that succeeds."""
    y_mean = torch.mean(y, dim=0)
    y_scale = torch.clamp_min(torch.std(y, dim=0, correction=0), 1e-12)
    y_n = (y - y_mean) / y_scale
    med = torch.clamp_min(torch.quantile(torch.abs(x - torch.quantile(x, 0.5, dim=0)), 0.5, dim=0),
                          1e-3)
    params = [torch.log(med * 2.0), torch.zeros((), dtype=x.dtype, device=x.device),
              torch.log(torch.tensor(init_noise, dtype=x.dtype, device=x.device))]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, steps + 1):
        leaves = [p.detach().requires_grad_(True) for p in params]
        loss = _nll(leaves, x, y_n, jitter)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp_max(10.0 / (gnorm + 1e-12), 1.0)
            grads = [g * scale for g in grads]
            m = [b1 * a + (1 - b1) * g for a, g in zip(m, grads)]
            v = [b2 * a + (1 - b2) * g * g for a, g in zip(v, grads)]
            new = [p - lr * (a / (1 - b1**t)) / (torch.sqrt(c / (1 - b2**t)) + eps)
                   for p, a, c in zip(params, m, v)]
            ok = torch.isfinite(loss) & torch.stack([torch.all(torch.isfinite(p)) for p in new]).all()
            params = [torch.where(ok, a, b) for a, b in zip(new, params)]
    log_ls, log_os, log_noise = params
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    with torch.no_grad():
        k0 = _matern_train(x, x, log_ls, log_os)
        noise = NOISE_FLOOR + torch.exp(log_noise)
        for j in (jitter, *JITTER_LADDER):
            chol, info = torch.linalg.cholesky_ex(k0 + (noise + j) * eye)
            if int(info) == 0 and bool(torch.all(torch.isfinite(chol))):
                break
        else:
            raise FloatingPointError("GP kernel matrix could not be factorised")
        alpha = torch.cholesky_solve(y_n, chol)
    ls = torch.exp(log_ls)
    return GP(x_scaled=x / ls, ls=ls, outputscale=float(torch.exp(log_os)), alpha=alpha,
              y_mean=y_mean, y_scale=y_scale)


# ---------------------------------------------------------------------------
# The whole hierarchy
# ---------------------------------------------------------------------------
class Tohoku:
    """The three levels of the inversion for a configuration's grids:
    level 0 the GP, level 1 the coarse solve, level 2 the fine solve."""

    def __init__(self, config: Dict, *, dtype=torch.float64, device="cuda") -> None:
        self.config = config
        self.dtype = dtype
        self.device = torch.device(device)
        t_end = float(config["t_end_s"])
        self.coarse = Grid(*config["coarse_grid"], t_end, dtype, self.device)
        self.fine = Grid(*config["fine_grid"], t_end, dtype, self.device)
        self._gp: Optional[GP] = None
        self._y_obs: Optional[np.ndarray] = None

    def _t(self, thetas) -> torch.Tensor:
        # The program's servers take thetas as float32: so does the reference.
        x = torch.as_tensor(np.asarray(thetas, dtype=np.float32))
        return x.to(device=self.device, dtype=self.dtype)

    def level(self, lvl: int, thetas, *, gp_dtype=None) -> np.ndarray:
        """Observables (B, 4) of ``thetas`` (B, 2) at level ``lvl``."""
        x = self._t(thetas)
        if lvl == 0:
            out = self.gp().mean(x, gp_dtype)
        else:
            out = (self.coarse if lvl == 1 else self.fine).observables(x)
        return out.double().cpu().numpy()

    def gp(self, fit_dtype: torch.dtype = torch.float64) -> GP:
        """The level-0 surrogate, refitted from this reference's own level-1
        solves of the LHS design."""
        if self._gp is None:
            n = int(self.config["gp_train_points"])
            x32 = lhs_design(n)
            x = x32.to(device=self.device, dtype=fit_dtype)
            grid = self.coarse if fit_dtype == self.dtype else Grid(
                *self.config["coarse_grid"], float(self.config["t_end_s"]), fit_dtype, self.device)
            y = grid.observables(x, batch=GP_BATCH)
            self._gp = fit_gp(x, y, steps=int(self.config["gp_opt_steps"]))
        return self._gp

    def y_obs(self) -> np.ndarray:
        """The synthetic data: the fine model at the true source, plus
        Gaussian noise of the stated sigmas from the stated seed."""
        if self._y_obs is None:
            clean = self.level(2, np.array([THETA_TRUE]))[0]
            rng = np.random.default_rng(OBS_SEED)
            self._y_obs = clean + rng.normal(size=clean.shape) * NOISE_SIGMA
        return self._y_obs

    def log_density(self, lvl: int, thetas, *, gp_dtype=None) -> np.ndarray:
        """log prior + log likelihood at level ``lvl`` (B,)."""
        t = np.asarray(thetas, dtype=np.float64)
        obs = self.level(lvl, thetas, gp_dtype=gp_dtype)
        r = (obs - self.y_obs()) / NOISE_SIGMA
        inside = np.all((t >= PRIOR_LO) & (t <= PRIOR_HI), axis=1)
        lp = -float(np.sum(np.log(PRIOR_HI - PRIOR_LO)))
        return np.where(inside, lp - 0.5 * np.sum(r * r, axis=1), -np.inf)


def obs_error_sigma(prog: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap of the program's observables from the reference's,
    each component in units of its likelihood sigma (NaN reads infinite)."""
    err = np.abs(np.asarray(prog, np.float64) - np.asarray(ref, np.float64)) / NOISE_SIGMA
    return float(np.nan_to_num(err, nan=np.inf).max()) if err.size else float("nan")


def sample_batches(batches: Sequence[Tuple[np.ndarray, np.ndarray]], k: int,
                   rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """The rows of whole recorded batches, drawn from ``rng``: batches of
    two or more rows until they hold half of ``k`` rows (the last may pass
    it), and single-row batches for the other half; where one kind runs
    out, the other fills the rest.  A fault that touches only the later
    rows of a batch, or only batches of one row, is in the sample whenever
    the window had such a batch."""
    sizes = np.array([len(np.asarray(o).reshape(-1, 4)) for _, o in batches])
    multi = [int(i) for i in rng.permutation(np.nonzero(sizes > 1)[0])]
    single = [int(i) for i in rng.permutation(np.nonzero(sizes == 1)[0])]
    chosen, rows = [], 0
    while multi and rows < max(k - len(single), (k + 1) // 2):
        chosen.append(multi.pop(0))
        rows += int(sizes[chosen[-1]])
    chosen += single[:max(k - rows, k // 2)]
    return stack_rows([batches[i] for i in sorted(chosen)])


def stack_rows(batches: Sequence[Tuple[np.ndarray, np.ndarray]]) -> Tuple[np.ndarray, np.ndarray]:
    """Recorded (thetas (B, 2), replies (B, 4)) batches -> all rows."""
    if not batches:
        return np.zeros((0, 2)), np.zeros((0, 4))
    th = np.concatenate([np.asarray(t, np.float64).reshape(-1, 2) for t, _ in batches])
    ob = np.concatenate([np.asarray(o, np.float64).reshape(-1, 4) for _, o in batches])
    return th, ob
