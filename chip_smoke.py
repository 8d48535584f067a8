#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):

1. print the card's name and power limit; build the CUDA kernels of
   ``src/repro_torch/csrc`` with nvcc (one process per source, in parallel)
   and print each build's ``-Xptxas -v`` report;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (fused SWE step at 288x288 and 96x96 with B = 8, the
   directional sweep at 288x288 in x and y, Matérn at (8, 2) x (512, 2) and
   (130, 2+3) x (70, 5)), check lake-at-rest through the kernels, and time
   kernel and plain version with CUDA events;
3. check batch invariance: B = 1 rows against B = 8 rows, bit for bit, for
   the coarse and fine batched forwards and for ``GaussianProcess.batch_call``;
4. drive the main path, ``repro_torch.launch.tsunami.run``, at the ``paper``
   preset's widths (96x96 and 288x288 grids, 512 LHS points, 200 Adam steps,
   5 chains through the balancer) with fewer fine samples per chain, with
   the launch counters set to 0 just before; every kernel must launch;
   check the outputs against the plain path;
5. print the ``kernels`` JSON line, then the result line.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

# Fine samples per chain on the main path: the paper preset's own 150, no
# cut (about 200 s of sampling on an H100).  Lower it here if later phases
# need the time.
N_FINE_SAMPLES = 150
# Card peaks for the bound: H100 SXM, NVIDIA data sheet.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# Tolerances of each kernel against its plain version on the same inputs.
# The SWE kernels are compared one step at a time from the same input: over
# several steps a 1-ulp difference in h at 7 km depth (0.5 mm of sea
# surface; PyTorch's CUDA division by a Python scalar is not IEEE-rounded,
# the kernel's division is) feeds back into the momenta at ~1e-4 of their size.
SWE_REL_TOL = 1e-5  # max |kernel - plain| / max(max |plain|, 1), per step
SWEEP_REL_TOL = 1e-5  # same measure for one sweep's tendencies
MATERN_ATOL = 5e-6  # as the reference's kernel test; the kernel contracts FMAs
# Single-theta (sweep kernel) against batched (fused kernel) observables,
# and the main path's observables against the plain path's, over a whole
# solve.  Probe heights are h + b with h ~ 7 km, so they come in steps of
# 4.9e-4 m (one fp32 ulp of h); 5e-3 is ten such steps and an eighth of
# the height noise (0.04 m).
OBS_ATOL = 5e-3
# Operation counts per cell for the bound (sqrt and division count as one):
# one face flux ~74 (4 velocities x 8, reconstruction 7, momenta 4, wave
# speeds 9, three fluxes 22); a cell needs one x and one y face of its own
# plus its two tendencies (2 x 14) and the Euler update (12).
SWE_FACE_FLOPS = 74
FUSED_FLOPS_PER_CELL = 2 * SWE_FACE_FLOPS + 28 + 12
SWEEP_FLOPS_PER_CELL = SWE_FACE_FLOPS + 14


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` per call, from CUDA events.

    A call costs the host tens of microseconds of Python and ctypes, more
    than a kernel at these shapes takes on the card.  So the stream is first
    held by a spin kernel (``torch.cuda._sleep``) longer than the host needs
    to enqueue all ``iters`` calls; the events then bracket the calls as the
    card runs them back to back, without the host's gaps.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2.0e9) + 1_000_000)  # > 2x the enqueue time
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels.build import LIBRARY

    t0 = time.perf_counter()
    LIBRARY.build(["swe_flux", "matern"])
    print(f"[1] built kernels in {time.perf_counter() - t0:.1f}s into {LIBRARY.build_dir}")
    for name, log in sorted(LIBRARY.ptxas_log.items()):
        print(f"[1] nvcc -Xptxas -v ({name}.cu):")
        for line in log.strip().splitlines():
            print(f"      {line}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def _swe_batch(torch, sc, thetas, n_plain_steps: int):
    """Stacked state of ``thetas`` after ``n_plain_steps`` plain steps (so
    momenta are non-zero), plus the grid's bathymetry and dt."""
    from repro_torch.swe.solver import initial_state, stable_dt, step

    b = sc.bathymetry()
    h_rest = torch.clamp_min(-b, 0.0)
    eta0 = torch.stack([sc.displacement(t) for t in thetas])
    state = initial_state(h_rest[None], eta0)
    dt = stable_dt(sc.cfg, float(h_rest.max()))
    for _ in range(n_plain_steps):
        state = step(state, b, sc.cfg, dt)
    return state, b, dt


def phase_kernels(torch, rows):
    from repro_torch.kernels.matern import ops as matern_ops
    from repro_torch.kernels.matern.ref import matern52_ref
    from repro_torch.kernels.swe_flux import ops as swe_ops
    from repro_torch.kernels.swe_flux.ref import swe_fused_step_ref, swe_sweep_ref
    from repro_torch.swe import TohokuScenario
    from repro_torch.swe.solver import H_EPS, SWEState

    gen = torch.Generator().manual_seed(0)
    thetas = (torch.rand((8, 2), generator=gen) * 400.0 - 200.0).cuda()

    # -- fused step: kernel vs plain, one step at a time from the plain ------
    # trajectory's state (errors do not compound), over 4 steps
    fused_err = 0.0
    for n in (288, 96):
        sc = TohokuScenario(nx=n, ny=n)
        state, b, dt = _swe_batch(torch, sc, thetas, 3)
        p_state = state
        for t in range(4):
            k_state = swe_ops.swe_step_batched(p_state, b, dt, cfg=sc.cfg)
            p_next = swe_fused_step_ref(p_state, b, dt, cfg=sc.cfg)
            torch.cuda.synchronize()
            for name, k, p in zip("h hu hv".split(), k_state, p_next):
                err = rel_err(k, p)
                fused_err = max(fused_err, float((k - p).abs().max()))
                print(f"[2] swe_fused_step {n}x{n} B=8 step {t} {name}: rel err {err:.3e}")
                if not err < SWE_REL_TOL:
                    fail(f"fused step {n}x{n} {name} rel err {err} >= {SWE_REL_TOL}")
            p_state = p_next
        if n == 288:
            fused_case = (sc, state, b, dt)

    # -- sweep: one sweep in x and in y at 288x288 ---------------------------
    sc, state, b, dt = fused_case
    one = SWEState(*(x[0].contiguous() for x in state))
    sweep_err = 0.0
    for axis, d in ((0, sc.cfg.dx), (1, sc.cfg.dy)):
        k = swe_ops.swe_sweep(*one, b, axis=axis, g=sc.cfg.g, d=d)
        p = swe_sweep_ref(*one, b, axis=axis, g=sc.cfg.g, d=d)
        torch.cuda.synchronize()
        for name, kk, pp in zip(("dh", "dhu", "dhv"), k, p):
            err = float((kk - pp).abs().max()) / max(float(pp.abs().max()), 1e-30)
            sweep_err = max(sweep_err, float((kk - pp).abs().max()))
            print(f"[2] swe_sweep 288x288 axis={axis} {name}: rel err {err:.3e}")
            if not err < SWEEP_REL_TOL:
                fail(f"sweep axis {axis} {name} rel err {err} >= {SWEEP_REL_TOL}")

    # -- lake at rest through both kernels: exactly balanced -----------------
    h_rest = torch.clamp_min(-b, 0.0)
    rest = SWEState(h_rest[None].repeat(2, 1, 1), torch.zeros((2, *b.shape), device=b.device),
                    torch.zeros((2, *b.shape), device=b.device))
    rest1 = SWEState(*(x[0].contiguous() for x in rest))
    for _ in range(20):
        rest = swe_ops.swe_step_batched(rest, b, dt, cfg=sc.cfg)
        rest1 = swe_ops.swe_step(rest1, b, dt, cfg=sc.cfg)
    wet = h_rest > H_EPS
    for name, st in (("fused", rest), ("sweep", rest1)):
        drift = float(torch.where(wet, (st.h - h_rest).abs(), 0.0).max())
        mom = float(st.hu.abs().max() + st.hv.abs().max())
        print(f"[2] lake at rest, 20 {name} steps at 288x288: eta drift {drift}, momentum {mom}")
        if drift != 0.0 or mom != 0.0:
            fail(f"lake at rest not exact through the {name} kernel")

    # -- Matérn --------------------------------------------------------------
    matern_err = 0.0
    for (n, m, d) in ((8, 512, 2), (130, 70, 5)):
        a = torch.randn((n, d), generator=gen).cuda() / 0.7
        bb = torch.randn((m, d), generator=gen).cuda() / 0.7
        k = matern_ops.matern52_scaled(a, bb, 1.3)
        p = matern52_ref(a, bb, 1.3)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        matern_err = max(matern_err, err)
        print(f"[2] matern52 ({n},{d})x({m},{d}): max abs err {err:.3e}")
        if not err < MATERN_ATOL:
            fail(f"matern ({n},{m},{d}) err {err} >= {MATERN_ATOL}")

    # -- timing at the main path's heaviest shapes ---------------------------
    B, ny, nx = state.h.shape
    cur = SWEState(*(x.contiguous() for x in state))
    nxt = SWEState(*(torch.empty_like(x) for x in state))
    bufs = [cur, nxt]

    def fused_once():
        swe_ops.swe_step_batched(bufs[0], b, dt, cfg=sc.cfg, out=bufs[1])
        bufs.reverse()

    fused_ms = device_time_ms(torch, fused_once, 400)
    fused_plain_ms = device_time_ms(
        torch, lambda: swe_fused_step_ref(state, b, dt, cfg=sc.cfg), 20
    )
    plane = ny * nx * 4
    f_bound = bound_ms(2 * 3 * B * plane + plane, FUSED_FLOPS_PER_CELL * B * ny * nx)
    sweep_ms = device_time_ms(
        torch, lambda: swe_ops.swe_sweep(*one, b, axis=0, g=sc.cfg.g, d=sc.cfg.dx), 400
    )
    sweep_plain_ms = device_time_ms(
        torch, lambda: swe_sweep_ref(*one, b, axis=0, g=sc.cfg.g, d=sc.cfg.dx), 20
    )
    s_bound = bound_ms(7 * plane, SWEEP_FLOPS_PER_CELL * ny * nx)
    a = torch.randn((8, 2), generator=gen).cuda()
    bb = torch.randn((512, 2), generator=gen).cuda()
    matern_ms = device_time_ms(torch, lambda: matern_ops.matern52_scaled(a, bb, 1.3), 400)
    matern_plain_ms = device_time_ms(torch, lambda: matern52_ref(a, bb, 1.3), 20)
    m_bound = bound_ms((8 * 2 + 512 * 2 + 8 * 512) * 4, 8 * 512 * (3 * 2 + 15))
    print("[2] device time per call (CUDA events): "
          f"fused 288x288 B=8 {fused_ms:.4f} ms (plain {fused_plain_ms:.4f}); "
          f"sweep 288x288 {sweep_ms:.4f} ms (plain {sweep_plain_ms:.4f}); "
          f"matern (8,2)x(512,2) {matern_ms:.4f} ms (plain {matern_plain_ms:.4f}); "
          "library_ms: no single PyTorch call computes any of the three functions")
    rows.update({
        "swe_fused_step": dict(
            route="cuda", source="src/repro_torch/csrc/swe_flux.cu",
            replaces="src/repro/kernels/swe_flux/swe_flux.py:204",
            max_abs_err=fused_err, ms=fused_ms, plain_ms=fused_plain_ms,
            bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None,
        ),
        "swe_sweep": dict(
            route="cuda", source="src/repro_torch/csrc/swe_flux.cu",
            replaces="src/repro/kernels/swe_flux/swe_flux.py:108",
            max_abs_err=sweep_err, ms=sweep_ms, plain_ms=sweep_plain_ms,
            bound_ms=s_bound[0], bound_by=s_bound[1], library_ms=None,
        ),
        "matern52": dict(
            route="cuda", source="src/repro_torch/csrc/matern.cu",
            replaces="src/repro/kernels/matern/matern.py:58",
            max_abs_err=matern_err, ms=matern_ms, plain_ms=matern_plain_ms,
            bound_ms=m_bound[0], bound_by=m_bound[1], library_ms=None,
        ),
    })


# ---------------------------------------------------------------------------
# phase 3: batch invariance
# ---------------------------------------------------------------------------
def phase_batch_invariance(torch, w):
    import numpy as np

    from repro_torch.core.gp import fit_gp
    from repro_torch.core.lhs import latin_hypercube, scale_to_bounds
    from repro_torch.swe import TohokuScenario

    rng = np.random.default_rng(3)
    thetas = torch.as_tensor(rng.uniform(-200, 200, (8, 2)), dtype=torch.float32).cuda()
    for level, (nx, ny) in ((1, w.coarse_grid), (2, w.fine_grid)):
        sc = TohokuScenario(nx=nx, ny=ny, t_end=w.t_end_s)
        fb = sc.build_batch_forward()
        f1 = sc.build_forward()
        t0 = time.perf_counter()
        full = fb(thetas)
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
        rows1 = torch.cat([fb(thetas[i : i + 1]) for i in range(8)])
        single = torch.stack([f1(t) for t in thetas[:2]])
        if not torch.equal(full, rows1):
            fail(f"level {level}: B=1 rows differ from B=8 rows "
                 f"(max {float((full - rows1).abs().max())})")
        if not bool(torch.isfinite(full).all()):
            fail(f"level {level}: non-finite observables")
        d_single = float((single - full[:2]).abs().max())
        print(f"[3] level {level} {nx}x{ny}: B=1 rows == B=8 rows bit for bit; "
              f"B=8 solve {t_batch * 1e3:.1f} ms wall; sweep-kernel single vs "
              f"fused batched max abs diff {d_single:.3e}")
        if not d_single < OBS_ATOL:
            fail(f"level {level}: single vs batched observables differ by {d_single}")
    gen = torch.Generator().manual_seed(1)
    x = scale_to_bounds(latin_hypercube(gen, 512, 2), [-200, -200], [200, 200]).cuda()
    y = torch.stack([torch.sin(x[:, 0] / 90), torch.cos(x[:, 1] / 70),
                     x[:, 0] * x[:, 1] / 4e4, torch.tanh(x[:, 0] / 150)], dim=1)
    gp = fit_gp(x, y, steps=20)
    full = gp.batch_call(thetas)
    rows1 = torch.cat([gp.batch_call(thetas[i : i + 1]) for i in range(8)])
    if not torch.equal(full, rows1):
        fail("GP batch_call: B=1 rows differ from B=8 rows")
    print("[3] level 0 GaussianProcess.batch_call (n=512): B=1 rows == B=8 rows bit for bit")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def phase_main_path(torch, w, rows):
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.launch.tsunami import run
    from repro_torch.swe.scenario import observe
    from repro_torch.swe.solver import initial_state, step

    PRESET_FINE_SAMPLES = w.n_fine_samples
    w = replace(w, n_fine_samples=N_FINE_SAMPLES)
    print(f"[4] main path: workload '{w.name}', n_fine_samples={N_FINE_SAMPLES} "
          f"per chain (preset: {PRESET_FINE_SAMPLES}"
          f"{'' if N_FINE_SAMPLES == PRESET_FINE_SAMPLES else ', cut'}); "
          "everything else at the preset's size")
    build.reset_counters()
    t0 = time.perf_counter()
    res = run(w, device="cuda", log=lambda s: print(f"[4] {s}", flush=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.value for name, c in build.COUNTERS.items()}
    print(f"[4] main path wall {wall:.1f}s; stage walls {res['walls']}; "
          f"kernel launches {launches}")
    for name in rows:
        rows[name]["launches"] = launches.get(name, 0)
        if rows[name]["launches"] <= 0:
            fail(f"kernel {name} was not launched by the main path")
    if res["failures"]:
        fail(f"chains failed: {res['failures']}")
    chains = np.asarray(res["chains"])
    if chains.shape != (w.n_chains, N_FINE_SAMPLES, 2) or not np.isfinite(chains).all():
        fail(f"chains have shape {chains.shape} or non-finite values")
    y_obs = np.asarray(res["y_obs"])
    if y_obs.shape != (4,) or not np.isfinite(y_obs).all():
        fail(f"y_obs {y_obs} is not 4 finite values")
    s = res["balancer"]
    print(f"[4] balancer: requests {s['n_requests']}, idle mean "
          f"{s['mean_idle_s'] * 1e3:.3f} ms, p99 {s['p99_idle_s'] * 1e3:.3f} ms; "
          f"batch histogram {s['batch_histogram']}")
    for row in res["levels"]:
        print(f"[4] level {row['level']}: evals {row['n_evals']}, acceptance "
              f"{row['acceptance_rate']:.3f}, mean eval {row['mean_eval_s'] * 1e3:.2f} ms")
    # The main path's fine observables at the truth (sweep kernel) against
    # the plain PyTorch step on the same card.
    h = res["hierarchy"]
    fwd = h["forward_fine"]
    theta = torch.zeros(2, device=fwd.device)
    got = fwd(theta)
    prob = h["problem"]
    sc = prob.scenario_fine
    b = sc.bathymetry()
    pi, pj = zip(*sc.probe_indices())
    state = initial_state(torch.clamp_min(-b, 0.0), sc.displacement(theta))
    series = torch.empty((fwd.n_steps, len(pi)), device=fwd.device)
    for t in range(fwd.n_steps):
        state = step(state, b, sc.cfg, fwd.dt)
        series[t] = state.h[list(pi), list(pj)] + b[list(pi), list(pj)]
    want = observe(series, fwd.dt, fwd.n_steps * fwd.dt, sc.arrival_threshold)
    diff = float((got - want).abs().max())
    print(f"[4] fine observables at the truth: kernels {got.cpu().numpy()} vs plain "
          f"{want.cpu().numpy()}, max abs diff {diff:.3e}")
    if not diff < OBS_ATOL:
        fail(f"main-path observables differ from the plain path by {diff}")
    gp = res["gp"]
    x_test = gp.x_train[:8]
    g_err = float((gp.batch_call(x_test) - gp.y_train[:8]).abs().max())
    print(f"[4] GP posterior mean at 8 training points: max abs err {g_err:.3e} "
          "against the coarse solves it was trained on")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.tohoku_mlda import PAPER

    t_start = time.perf_counter()
    phase_build()
    rows: dict = {}
    phase_kernels(torch, rows)
    phase_batch_invariance(torch, PAPER)
    phase_main_path(torch, PAPER, rows)
    print(f"[5] all phases passed in {time.perf_counter() - t_start:.1f}s")
    order = ("swe_fused_step", "swe_sweep", "matern52")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: dict(rows[n], name=n)[k] for k in keys} for n in order]
    for k in kernels:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            if not math.isfinite(k[key]):
                fail(f"kernel {k['name']}: {key} is not finite")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
