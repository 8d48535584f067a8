"""Well-balanced finite-volume shallow-water solver in PyTorch (paper §3).

The port of the JAX package's ``swe/solver.py``: first-order
hydrostatic-reconstruction finite volumes (Audusse et al. 2004) with a
Rusanov interface flux, which keeps lake-at-rest exact over any
bathymetry and the water depth non-negative.

The state is ``(h, hu, hv)`` on a structured cell-centred grid with static
bathymetry ``b``.  Every function here is the plain PyTorch version and is
axis-generic over leading batch dimensions: the last two axes are always
``(y, x)``.  :func:`make_solver` routes the time loop through the CUDA
kernels of :mod:`repro_torch.kernels.swe_flux` when the bathymetry lies on
the card, and through :func:`step` on the CPU; a batched solve on the card
is one CUDA-graph replay (:class:`GraphBatchCache`).
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.graphs import StaticGraph

G = 9.81  # m/s^2
H_EPS = 1e-3  # wet/dry threshold [m]
SQRT2 = math.sqrt(2.0)


class SWEState(NamedTuple):
    h: torch.Tensor  # (..., ny, nx) water depth >= 0
    hu: torch.Tensor  # (..., ny, nx) x-momentum
    hv: torch.Tensor  # (..., ny, nx) y-momentum


@dataclass(frozen=True)
class SWEConfig:
    nx: int
    ny: int
    dx: float  # [m]
    dy: float  # [m]
    t_end: float  # [s]
    cfl: float = 0.45
    g: float = G
    dt_override: Optional[float] = None


def desingularized_velocity(
    h: torch.Tensor, hq: torch.Tensor, eps: float = H_EPS
) -> torch.Tensor:
    """u = hu/h without dividing by ~0 in dry cells (Kurganov-Petrova)."""
    h2 = h * h
    h4 = h2 * h2  # (h^2)^2, as XLA expands h**4; torch.pow rounds differently
    return SQRT2 * h * hq / torch.sqrt(h4 + torch.clamp_min(h4, eps**4))


def _interface_flux_1d(hL, uL, vL, hR, uR, vR, g):
    """Rusanov flux through an x-interface for reconstructed states.

    The momentum flux is returned without its pressure part: the caller
    assembles pressure + bed source in deviation form, which is fp32-stable
    where the per-face g/2 h^2 terms (~2.4e8 on a 7 km ocean) are not.
    """
    huL, hvL = hL * uL, hL * vL
    huR, hvR = hR * uR, hR * vR
    # Safe sqrt: keeps the backward pass finite at dry cells.
    cL = torch.abs(uL) + torch.where(
        hL > 0, torch.sqrt(g * torch.where(hL > 0, hL, 1.0)), 0.0
    )
    cR = torch.abs(uR) + torch.where(
        hR > 0, torch.sqrt(g * torch.where(hR > 0, hR, 1.0)), 0.0
    )
    a = torch.maximum(cL, cR)
    f0 = 0.5 * (huL + huR) - 0.5 * a * (hR - hL)
    f1 = 0.5 * (huL * uL + huR * uR) - 0.5 * a * (huR - huL)  # advective only
    f2 = 0.5 * (hvL * uL + hvR * uR) - 0.5 * a * (hvR - hvL)
    return f0, f1, f2


def _pad_x(q: torch.Tensor) -> torch.Tensor:
    """Zero-gradient (outflow) ghost cells along the last axis."""
    return torch.cat([q[..., :1], q, q[..., -1:]], dim=-1)


def _x_update(h, hu, hv, b, dx, g):
    """Flux difference + well-balanced source along x (the last axis).

    Hydrostatic reconstruction at the interface between cells L and R:
    ``b* = max(b_L, b_R)``, ``h_L* = max(0, h_L + b_L - b*)``,
    ``h_R* = max(0, h_R + b_R - b*)``.  Returns ``(dh, dhu, dhv) / dx``.
    """
    hp, hup, hvp, bp = _pad_x(h), _pad_x(hu), _pad_x(hv), _pad_x(b)

    bL, bR = bp[..., :-1], bp[..., 1:]
    bstar = torch.maximum(bL, bR)
    hL = torch.clamp_min(hp[..., :-1] + bL - bstar, 0.0)
    hR = torch.clamp_min(hp[..., 1:] + bR - bstar, 0.0)
    # Momenta rescaled to the reconstructed depth (velocity preserved).
    uL = desingularized_velocity(hp[..., :-1], hup[..., :-1])
    vL = desingularized_velocity(hp[..., :-1], hvp[..., :-1])
    uR = desingularized_velocity(hp[..., 1:], hup[..., 1:])
    vR = desingularized_velocity(hp[..., 1:], hvp[..., 1:])
    f0, f1, f2 = _interface_flux_1d(hL, uL, vL, hR, uR, vR, g)

    # Per-cell flux difference; interface j is between cells j-1 and j.
    dh = f0[..., 1:] - f0[..., :-1]
    dhu = f1[..., 1:] - f1[..., :-1]
    dhv = f2[..., 1:] - f2[..., :-1]
    # Pressure + well-balanced source in deviation form: per face, (small
    # difference) x (large sum), never the ~g/2 h^2 terms themselves.
    hLr = hL[..., 1:]  # own reconstruction at the right face
    hRr = hR[..., 1:]  # neighbour reconstruction at the right face
    hLl = hL[..., :-1]  # neighbour reconstruction at the left face
    hRl = hR[..., :-1]  # own reconstruction at the left face
    press = 0.25 * g * ((hRr - hLr) * (hRr + hLr) + (hRl - hLl) * (hRl + hLl))
    dhu = dhu + press
    return dh / dx, dhu / dx, dhv / dx


def _y_update(h, hu, hv, b, dy, g):
    """Same as :func:`_x_update` along y, by transposition + (u, v) swap."""
    T = lambda q: q.transpose(-1, -2)
    dh, dhv, dhu = _x_update(T(h), T(hv), T(hu), T(b), dy, g)
    return T(dh), T(dhu), T(dhv)


def euler_update(state: SWEState, tx, ty, dt: float) -> SWEState:
    """Forward-Euler update from the x and y tendencies, with the
    positivity clamp and the wet-cell momentum mask."""
    h, hu, hv = state
    dhx, dhux, dhvx = tx
    dhy, dhuy, dhvy = ty
    h_new = torch.clamp_min(h - dt * (dhx + dhy), 0.0)
    hu_new = hu - dt * (dhux + dhuy)
    hv_new = hv - dt * (dhvx + dhvy)
    # Positivity + drying: no update removes more water than is there.
    wet = h_new > H_EPS
    return SWEState(
        h_new, torch.where(wet, hu_new, 0.0), torch.where(wet, hv_new, 0.0)
    )


def step(state: SWEState, b: torch.Tensor, cfg: SWEConfig, dt: float) -> SWEState:
    """One unsplit forward-Euler step of the well-balanced FV scheme."""
    h, hu, hv = state
    tx = _x_update(h, hu, hv, b, cfg.dx, cfg.g)
    ty = _y_update(h, hu, hv, b, cfg.dy, cfg.g)
    return euler_update(state, tx, ty, dt)


def stable_dt(cfg: SWEConfig, h_max: float, u_margin: float = 15.0) -> float:
    """CFL-derived fixed dt (a fixed step count per grid)."""
    c = math.sqrt(cfg.g * max(h_max, 1.0)) + u_margin
    return cfg.cfl * min(cfg.dx, cfg.dy) / c


def pow2_batch(n: int) -> int:
    """Next power of two >= n: the graph cache's batch bucketing."""
    if n < 1:
        raise ValueError("batch size must be >= 1")
    return 1 << (n - 1).bit_length()


class GraphBatchCache:
    """Power-of-two padded, per-``(*key, B)`` CUDA-graph cache: the port's
    counterpart of the reference's ``AOTBatchCache``.

    ``stacked_fn`` takes one or more ``(B, ...)`` tensors whose leading axis
    is the batch and returns tensors (or tuples of them) with the same
    leading axis.  A call pads its inputs to ``pow2_batch(B)`` rows,
    ``"zeros"`` filling the padding with zeros and ``"repeat"`` with copies
    of row 0 (for inputs where zeros are not valid), and runs the
    :class:`~repro_torch.graphs.StaticGraph` of that size: captured at the
    first call of each size on the card, eager on the CPU.  It returns
    ``(outputs, n)`` with the *padded* leading axis; the caller slices back
    to ``n``.

    ``executables`` maps ``(*key, B_pad)`` to that size's graphs, one per
    calling thread: the balancer's workers may run two servers that share
    one forward at once, and a graph's static buffers serve one caller at a
    time.  A lock guards only the bookkeeping; captures and replays of
    different threads run concurrently.
    """

    def __init__(self, stacked_fn: Callable, *, key: Tuple, pad: str = "zeros",
                 name: str) -> None:
        if pad not in ("zeros", "repeat"):
            raise ValueError(f"unknown pad mode '{pad}'")
        self.stacked_fn = stacked_fn
        self.key = tuple(key)
        self.pad = pad
        self.name = name
        self.executables: Dict[Tuple, Dict[int, StaticGraph]] = {}
        self._lock = threading.Lock()

    def __call__(self, *stacked: torch.Tensor):
        n = stacked[0].shape[0]
        n_pad = pow2_batch(n)
        if n_pad != n:
            stacked = tuple(torch.cat([x, self._fill(x, n_pad - n)]) for x in stacked)
        key, thread = (*self.key, n_pad), threading.get_ident()
        with self._lock:
            graph = self.executables.setdefault(key, {}).get(thread)
        if graph is None:
            graph = StaticGraph(self.stacked_fn, stacked, name=self.name)
            with self._lock:
                self.executables[key][thread] = graph
        return graph(*stacked), n

    def _fill(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        shape = (rows, *x.shape[1:])
        return x.new_zeros(shape) if self.pad == "zeros" else x[:1].expand(shape)


def _rest_depth(b: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(-b, 0.0)


def initial_state(h_rest: torch.Tensor, eta0: torch.Tensor) -> SWEState:
    """Lake at rest plus the displacement ``eta0`` on wet cells."""
    h0 = torch.clamp_min(h_rest + eta0, 0.0)
    # Displacement only applies to wet cells (paper: filtered bed change).
    h0 = torch.where(h_rest > H_EPS, h0, h_rest)
    return SWEState(h0, torch.zeros_like(h0), torch.zeros_like(h0))


def make_solver(
    cfg: SWEConfig,
    b: torch.Tensor,
    probe_ij: Sequence[Tuple[int, int]],
    *,
    batch: bool = False,
) -> Callable:
    """Build ``solve(eta0) -> (eta_series, final_state)``.

    ``eta0`` is the initial sea-surface displacement added to the
    lake-at-rest depth; ``eta_series`` is ``(n_steps, n_probes)`` SSHA at
    the probes.  The solver runs where ``b`` lies: on the card the single
    solve steps through the directional sweep kernel and the batched one
    through the fused kernel; on the CPU both step through :func:`step`.

    With ``batch=True`` the callable takes a stacked ``(B, ny, nx)``
    displacement and returns ``((B, n_steps, n_probes) series, batched
    final state)``; the whole batch advances in one time loop.  Each member
    runs the same elementwise arithmetic as the unbatched CPU solver, so on
    the CPU batched rows equal unbatched rows bit for bit, and on the card
    a row of the fused kernel does not depend on the batch size.  The whole
    stacked solve (the initial state, then the loop of fused steps) runs
    under a :class:`GraphBatchCache` keyed ``(ny, nx)`` with zero padding,
    whose graphs are ``solve_batch.executables``; ``solve_batch.eager`` is
    the same solve, unpadded, with every launch issued from Python.
    """
    b = b.to(torch.float32).contiguous()
    if b.shape != (cfg.ny, cfg.nx):
        raise ValueError(f"bathymetry {tuple(b.shape)} != grid {(cfg.ny, cfg.nx)}")
    h_rest = _rest_depth(b)
    h_max = float(torch.max(h_rest))
    if cfg.dt_override is not None:
        # NOT `dt_override or stable_dt(...)`: 0.0 is falsy and would mask
        # an invalid explicit override.
        if cfg.dt_override <= 0.0:
            raise ValueError(f"dt_override must be positive, got {cfg.dt_override}")
        dt = cfg.dt_override
    else:
        dt = stable_dt(cfg, h_max)
    n_steps = int(math.ceil(cfg.t_end / dt))
    pi = torch.tensor([ij[0] for ij in probe_ij], dtype=torch.int64, device=b.device)
    pj = torch.tensor([ij[1] for ij in probe_ij], dtype=torch.int64, device=b.device)
    # The wrappers launch the CUDA kernels for tensors on the card and run
    # the plain versions (this module's step) for tensors on the CPU.
    from repro_torch.kernels.swe_flux import ops as swe_ops

    def solve(eta0: torch.Tensor):
        state = initial_state(h_rest, eta0.to(torch.float32))
        series = torch.empty(
            (n_steps, len(probe_ij)), dtype=torch.float32, device=b.device
        )
        b_probe = b[pi, pj]
        for t in range(n_steps):
            state = swe_ops.swe_step(state, b, dt, cfg=cfg)
            series[t] = state.h[pi, pj] + b_probe  # SSHA where wet: h + b
        return series, state

    solve.n_steps = n_steps
    solve.dt = dt
    if not batch:
        return solve

    def stacked(eta0_b: torch.Tensor):
        state = initial_state(h_rest[None], eta0_b.to(torch.float32))
        return swe_ops.solve_batched(state, b, dt, n_steps, pi, pj, cfg=cfg)

    # Zero-displacement padding members are lake-at-rest solves.
    cache = GraphBatchCache(
        stacked, key=(cfg.ny, cfg.nx), pad="zeros", name=f"solve {cfg.ny}x{cfg.nx}"
    )

    def solve_batch(eta0_b: torch.Tensor):
        if eta0_b.ndim != 3:
            raise ValueError(
                f"batched solver wants (B, ny, nx), got {tuple(eta0_b.shape)}"
            )
        (series, final), n = cache(eta0_b.to(device=b.device, dtype=torch.float32))
        return series[:n], SWEState(*(x[:n] for x in final))

    solve_batch.n_steps = n_steps
    solve_batch.dt = dt
    solve_batch.solve_one = solve
    solve_batch.eager = stacked
    solve_batch.executables = cache.executables
    return solve_batch


def lake_at_rest_error(cfg: SWEConfig, b: torch.Tensor, n_steps: int = 50) -> float:
    """Max |eta| + |momentum| drift from the lake-at-rest steady state."""
    b = b.to(torch.float32)
    h = _rest_depth(b)
    state = SWEState(h, torch.zeros_like(h), torch.zeros_like(h))
    dt = stable_dt(cfg, float(torch.max(h)))
    for _ in range(n_steps):
        state = step(state, b, cfg, dt)
    wet = h > H_EPS
    eta_err = torch.max(torch.abs(torch.where(wet, (state.h + b) - (h + b), 0.0)))
    u_err = torch.max(torch.abs(desingularized_velocity(state.h, state.hu)))
    v_err = torch.max(torch.abs(desingularized_velocity(state.h, state.hv)))
    return float(eta_err + u_err + v_err)
