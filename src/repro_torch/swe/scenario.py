"""Tōhoku-like tsunami scenario (paper §3.2, §4).

The port of the JAX package's ``swe/scenario.py``: a synthetic
trench-shaped bathymetry on the paper's domain ``[-499, 1299] x [-949,
849] km``, an initial displacement bump centred at ``theta = (x0, y0)``,
and the observation operator (wave height and soft arrival time at two
DART-like probes).  Observations come from the fine model at a known
source plus numpy measurement noise.

Each scenario lives on one device (``device``, the card by default).  The
forwards take and return float32 tensors on that device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

from .solver import GraphBatchCache, SWEConfig, make_solver

KM = 1000.0

# Paper domain (km).
DOMAIN_X = (-499.0, 1299.0)
DOMAIN_Y = (-949.0, 849.0)
# Displacement translation window (paper Fig. 4, red box).
PRIOR_X = (-200.0, 200.0)
PRIOR_Y = (-200.0, 200.0)
# DART-like probe positions (km), east of the source region.
PROBES_KM = ((480.0, 380.0), (700.0, -420.0))


def observe(series: torch.Tensor, dt: float, t_norm: float, thr: float) -> torch.Tensor:
    """Observation operator for ONE solve: ``(T, P)`` probe series ->
    ``(4,)`` ``[hmax_1, tarr_1, hmax_2, tarr_2]``.

    Arrival time is the soft first crossing of ``thr`` (smooth in theta),
    normalised to the simulation window.  Batched forwards call this once
    per member, so a member's observables never depend on the batch size:
    a reduction over ``(B, T, P)`` may pick its order by ``B``, and a CPU
    elementwise loop rounds ``exp`` differently at different offsets.
    """
    hmax = torch.amax(series, dim=0)
    # t_arr = sum_t dt * prod_{s<=t} (1 - sigmoid(k (eta_s - thr)))
    k = 40.0 / thr
    crossed = torch.sigmoid(k * (series - thr))
    not_yet = torch.cumprod(1.0 - crossed, dim=0)
    t_arr = torch.sum(not_yet, dim=0) * dt / t_norm
    return torch.stack([hmax[0], t_arr[0], hmax[1], t_arr[1]])


@dataclass(frozen=True)
class TohokuScenario:
    """Grid-resolution-parameterised scenario; one instance per MLDA level."""

    nx: int = 96
    ny: int = 96
    t_end: float = 4.0 * 3600.0  # 4 h of simulated tsunami propagation
    amplitude: float = 5.0  # initial displacement height [m]
    sigma_km: float = 60.0  # displacement half-width
    arrival_threshold: float = 0.05  # [m] SSHA for arrival detection
    device: str = "cuda"

    @property
    def torch_device(self) -> torch.device:
        return resolve_device(self.device)

    @property
    def cfg(self) -> SWEConfig:
        lx = (DOMAIN_X[1] - DOMAIN_X[0]) * KM
        ly = (DOMAIN_Y[1] - DOMAIN_Y[0]) * KM
        return SWEConfig(
            nx=self.nx, ny=self.ny, dx=lx / self.nx, dy=ly / self.ny, t_end=self.t_end
        )

    # -- geometry -----------------------------------------------------------
    def cell_centers(self) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = self.torch_device
        x = torch.linspace(DOMAIN_X[0], DOMAIN_X[1], self.nx + 1, device=dev)
        y = torch.linspace(DOMAIN_Y[0], DOMAIN_Y[1], self.ny + 1, device=dev)
        xc = 0.5 * (x[:-1] + x[1:])
        yc = 0.5 * (y[:-1] + y[1:])
        return xc, yc  # km

    def bathymetry(self) -> torch.Tensor:
        """Synthetic bed elevation b(x, y) [m] (negative = below sea level)."""
        X, Y = self._grid()
        # Deep plain ~ -7000 m; shelf rises towards the west (Japan side).
        plain = -7000.0
        shelf = 6950.0 * torch.exp(-(((X - DOMAIN_X[0]) / 220.0) ** 2))
        # Japan trench: a deeper trough running north-south near x ~ 120 km.
        trench = -1500.0 * torch.exp(-(((X - 120.0) / 90.0) ** 2))
        # Gentle seamount ridge to keep the field non-trivial away from land.
        ridge = 800.0 * torch.exp(
            -(((X - 700.0) / 260.0) ** 2 + ((Y - 250.0) / 330.0) ** 2)
        )
        b = plain + shelf + trench + ridge
        # Dry land strip on the far west edge.
        return torch.where(X < DOMAIN_X[0] + 40.0, 50.0, b).contiguous()

    def probe_indices(self) -> Sequence[Tuple[int, int]]:
        xc, yc = (c.cpu() for c in self.cell_centers())
        out = []
        for (px, py) in PROBES_KM:
            j = int(torch.argmin(torch.abs(xc - px)))
            i = int(torch.argmin(torch.abs(yc - py)))
            out.append((i, j))
        return out

    def _grid(self) -> Tuple[torch.Tensor, torch.Tensor]:
        xc, yc = self.cell_centers()
        Y, X = torch.meshgrid(yc, xc, indexing="ij")  # (ny, nx)
        return X, Y

    def _bump(self, X: torch.Tensor, Y: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        r2 = ((X - theta[0]) ** 2 + (Y - theta[1]) ** 2) / self.sigma_km**2
        return self.amplitude * torch.exp(-0.5 * r2)

    def displacement(self, theta: torch.Tensor) -> torch.Tensor:
        """Initial SSHA bump centred at theta = (x0, y0) km (paper §3.2)."""
        return self._bump(*self._grid(), self._theta(theta))

    def _theta(self, theta) -> torch.Tensor:
        return torch.as_tensor(theta, dtype=torch.float32).to(self.torch_device)

    # -- forward model --------------------------------------------------------
    def _single(self, eager: Callable, name: str, n_steps: int, dt: float) -> Callable:
        """``eager`` (theta (2,) -> tensor) as one CUDA-graph replay a call
        on the card: a :class:`GraphBatchCache` of batch 1 keyed ``(ny,
        nx)``, one graph per calling thread; eager on the CPU.
        ``forward.eager`` is ``eager`` itself, ``forward.executables`` the
        graphs."""
        cache = GraphBatchCache(
            lambda th: eager(th[0]), key=(self.ny, self.nx), pad="zeros",
            name=f"{name} {self.ny}x{self.nx}",
        )

        def forward(theta) -> torch.Tensor:
            out, _ = cache(self._theta(theta).reshape(1, 2))
            return out

        forward.n_steps = n_steps
        forward.dt = dt
        forward.device = self.torch_device
        forward.eager = eager
        forward.executables = cache.executables
        return forward

    def build_forward(self) -> Callable:
        """theta (2,) -> observables (4,): [hmax_1, tarr_1, hmax_2, tarr_2].

        On the card the solve steps through the directional sweep kernel, and
        a call replays it as one CUDA graph (``forward.eager`` issues every
        launch from Python).
        """
        solver = make_solver(self.cfg, self.bathymetry(), self.probe_indices())
        n_steps, dt = solver.n_steps, solver.dt
        t_norm = n_steps * dt
        X, Y = self._grid()

        def eager(theta) -> torch.Tensor:
            series, _ = solver(self._bump(X, Y, self._theta(theta)))
            return observe(series, dt, t_norm, self.arrival_threshold)

        return self._single(eager, "single forward", n_steps, dt)

    def _batched(self, readout: Callable, name: str) -> Callable:
        """thetas (B, 2) -> ``readout(series, dt, t_norm)`` of ONE batched
        solve, under one :class:`GraphBatchCache` keyed ``(ny, nx)`` that
        pads by repeating member 0 (a valid theta): on the card a call is
        one copy in, one graph replay and one copy out, and the solve
        inside the graph is the uncached stacked solve.  ``forward.eager``
        is the same forward, unpadded, with every launch issued from
        Python; ``forward.executables`` holds the graphs."""
        solver = make_solver(
            self.cfg, self.bathymetry(), self.probe_indices(), batch=True
        )
        n_steps, dt, solve = solver.n_steps, solver.dt, solver.eager
        t_norm = n_steps * dt
        X, Y = self._grid()

        def stacked(thetas: torch.Tensor) -> torch.Tensor:
            # One bump per member: the same shapes as the single forward.
            eta0 = torch.stack([self._bump(X, Y, t) for t in thetas])
            series, _ = solve(eta0)  # (B, n_steps, n_probes)
            return readout(series, dt, t_norm)

        cache = GraphBatchCache(
            stacked, key=(self.ny, self.nx), pad="repeat",
            name=f"{name} {self.ny}x{self.nx}",
        )

        def forward(thetas) -> torch.Tensor:
            out, n = cache(torch.atleast_2d(self._theta(thetas)))
            return out[:n]

        forward.n_steps = n_steps
        forward.dt = dt
        forward.device = self.torch_device
        forward.eager = lambda thetas: stacked(torch.atleast_2d(self._theta(thetas)))
        forward.executables = cache.executables
        return forward

    def build_batch_forward(self) -> Callable:
        """thetas (B, 2) -> observables (B, 4) in ONE batched solve.

        The ``BatchServer`` handler of this level: displacements per member,
        one batched time loop (on the card one fused-kernel launch per step
        for the whole batch), then the observation operator per member.  A
        row does not depend on B; on the CPU it equals
        ``build_forward()(thetas[i])`` bit for bit.  Graphs as
        :meth:`_batched` says.
        """
        thr = self.arrival_threshold
        return self._batched(
            lambda series, dt, t_norm: torch.stack(
                [observe(s, dt, t_norm, thr) for s in series]
            ),
            "forward",
        )

    def build_series_forward(self) -> Callable:
        """theta -> full probe-0 SSHA time series (n_steps,), through the
        sweep kernel, one CUDA-graph replay a call on the card (as
        :meth:`build_forward`)."""
        solver = make_solver(self.cfg, self.bathymetry(), self.probe_indices())

        def eager(theta) -> torch.Tensor:
            series, _ = solver(self.displacement(theta))
            return series[:, 0]

        return self._single(eager, "single series", solver.n_steps, solver.dt)

    def build_batch_series_forward(self) -> Callable:
        """thetas (B, 2) -> (B, n_steps) probe-0 SSHA series in ONE batched
        solve: the Fig. 6 series GP's design solves.  A row does not depend
        on B; on the CPU it equals ``build_series_forward()(thetas[i])`` bit
        for bit.  Graphs as :meth:`_batched` says."""
        return self._batched(
            lambda series, dt, t_norm: series[:, :, 0].contiguous(), "series"
        )


# ---------------------------------------------------------------------------
# Inverse problem assembly (paper §4)
# ---------------------------------------------------------------------------
@dataclass
class TohokuInverseProblem:
    """Uniform prior (Fig. 4) + Gaussian likelihood on (height, arrival)."""

    scenario_fine: TohokuScenario
    noise_height: float = 0.04  # [m] probe noise + model discrepancy
    noise_arrival: float = 0.012  # normalised-time units
    theta_true: Tuple[float, float] = (0.0, 0.0)
    obs_seed: int = 1234
    y_obs: Optional[np.ndarray] = None

    def prior_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.array([PRIOR_X[0], PRIOR_Y[0]])
        hi = np.array([PRIOR_X[1], PRIOR_Y[1]])
        return lo, hi

    def log_prior(self, theta) -> float:
        lo, hi = self.prior_bounds()
        t = np.asarray(theta)
        if np.any(t < lo) or np.any(t > hi):
            return float("-inf")
        return -float(np.sum(np.log(hi - lo)))

    def log_prior_torch(self, theta: torch.Tensor) -> torch.Tensor:
        """Batched log prior: ``(B, 2)`` float32 parameters -> ``(B,)``
        float32, ``-inf`` outside the box.  The counterpart of the
        reference's ``log_prior_jax``, a row per member; only scalar
        constants, so it copies nothing to the device and never syncs
        (it runs inside captured graphs)."""
        lo, hi = self.prior_bounds()
        inside = torch.ones_like(theta[:, 0], dtype=torch.bool)
        for j in range(theta.shape[1]):
            inside = inside & (theta[:, j] >= float(lo[j])) & (theta[:, j] <= float(hi[j]))
        const = -float(np.sum(np.log((hi - lo).astype(np.float32))))
        return torch.full_like(theta[:, 0], const).masked_fill(~inside, -math.inf)

    def sample_prior(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        lo, hi = self.prior_bounds()
        return rng.uniform(lo, hi, size=(n, 2))

    def noise_sigma(self) -> np.ndarray:
        return np.array(
            [self.noise_height, self.noise_arrival, self.noise_height, self.noise_arrival]
        )

    def generate_observations(self, forward_fine: Callable) -> np.ndarray:
        """Synthetic y: fine model at theta_true + measurement noise."""
        if self.y_obs is None:
            rng = np.random.default_rng(self.obs_seed)
            theta = torch.tensor(self.theta_true, dtype=torch.float32)
            clean = forward_fine(theta).cpu().numpy()
            self.y_obs = clean + rng.normal(size=clean.shape) * self.noise_sigma()
        return self.y_obs

    def log_likelihood(self, obs) -> float:
        if self.y_obs is None:
            raise RuntimeError("call generate_observations first")
        r = (np.asarray(obs) - self.y_obs) / self.noise_sigma()
        return -0.5 * float(np.sum(r * r))

    def log_likelihood_torch(self, obs: torch.Tensor) -> torch.Tensor:
        """Batched Gaussian log likelihood: ``(B, 4)`` float32 observables
        -> ``(B,)`` float32.  The counterpart of the reference's
        ``log_likelihood_jax``; the four squared residuals are summed in a
        fixed order, column by column, so a row never depends on B.  Scalar
        constants only, as :meth:`log_prior_torch`."""
        if self.y_obs is None:
            raise RuntimeError("call generate_observations first")
        total = None
        for i, (y, sigma) in enumerate(zip(self.y_obs, self.noise_sigma())):
            r = (obs[:, i] - float(y)) / float(sigma)
            total = r * r if total is None else total + r * r
        return -0.5 * total


def make_hierarchy(
    *,
    fine: TohokuScenario,
    coarse: TohokuScenario,
    problem: Optional[TohokuInverseProblem] = None,
) -> Dict[str, object]:
    """Assemble the paper's three-level setup: GP / coarse PDE / fine PDE.

    Returns forwards + the inverse problem; GP training happens in
    :func:`train_level0_gp` because it needs level-1 solves (paper §6.1).
    """
    problem = problem or TohokuInverseProblem(scenario_fine=fine)
    f_fine = fine.build_forward()
    f_coarse = coarse.build_forward()
    problem.generate_observations(f_fine)
    return {
        "problem": problem,
        "forward_fine": f_fine,
        "forward_coarse": f_coarse,
        # Stacked (B, 2) -> (B, 4) handlers for the BatchServer pools.
        "forward_fine_batch": fine.build_batch_forward(),
        "forward_coarse_batch": coarse.build_batch_forward(),
    }


def device_densities(
    problem: TohokuInverseProblem, gp, forward_coarse_batch: Callable
) -> List[Callable]:
    """The device-resident densities ``[lp_gp, lp_coarse]`` of levels 0 and
    1 for :func:`repro_torch.core.balanced_mlda` ``(device_resident=True)``
    and :class:`repro_torch.core.DeviceEnsemble`: batched ``(B, 2)`` ->
    ``(B,)`` float32 on the GP's and forward's device (the counterpart of
    the reference benchmark's ``_jax_densities``).

    ``lp_gp`` is the prior plus the likelihood of ``gp.predict`` (one
    posterior-mean launch for all rows); ``lp_coarse`` that of the batched
    coarse forward's ``eager`` solve (one fused-step launch a time step for
    all rows): not its cached graph, because a graph replay cannot run
    inside the ensemble's own capture.  Neither syncs with the host, and a
    row depends on its member alone.
    """
    coarse = forward_coarse_batch.eager

    def lp_gp(thetas: torch.Tensor) -> torch.Tensor:
        return problem.log_prior_torch(thetas) + problem.log_likelihood_torch(
            gp.predict(thetas))

    def lp_coarse(thetas: torch.Tensor) -> torch.Tensor:
        return problem.log_prior_torch(thetas) + problem.log_likelihood_torch(
            coarse(thetas))

    return [lp_gp, lp_coarse]


def build_hierarchy(w, device) -> Dict[str, object]:
    """:func:`make_hierarchy` over workload ``w``'s coarse and fine
    scenarios on ``device`` (a ``MLDAWorkloadConfig``'s grids and end time);
    the coarse scenario is kept as ``h["coarse"]`` for the series GP."""
    fine = TohokuScenario(
        nx=w.fine_grid[0], ny=w.fine_grid[1], t_end=w.t_end_s, device=str(device)
    )
    coarse = TohokuScenario(
        nx=w.coarse_grid[0], ny=w.coarse_grid[1], t_end=w.t_end_s, device=str(device)
    )
    h = make_hierarchy(fine=fine, coarse=coarse)
    h["coarse"] = coarse
    return h


def train_level0_gp(
    forward_coarse_batch: Callable,
    problem: TohokuInverseProblem,
    *,
    n_train: int = 512,
    seed: int = 0,
    steps: int = 200,
    batch_size: int = 64,
):
    """Paper §6.1: GP on ``n_train`` LHS draws of the level-1 (coarse) model.

    The design is solved by the batched coarse forward in chunks of
    ``batch_size``; the GP lives on the forward's device.
    """
    from repro_torch.core.gp import fit_gp
    from repro_torch.core.lhs import latin_hypercube, scale_to_bounds

    lo, hi = problem.prior_bounds()
    u = latin_hypercube(torch.Generator().manual_seed(seed), n_train, 2)
    x = scale_to_bounds(u, lo, hi).to(forward_coarse_batch.device)
    ys = torch.cat(
        [forward_coarse_batch(x[i : i + batch_size]) for i in range(0, n_train, batch_size)]
    )
    return fit_gp(x, ys, steps=steps, device=forward_coarse_batch.device)
