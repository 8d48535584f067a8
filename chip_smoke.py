#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):

1. print the card's name and power limit; build the CUDA kernels of
   ``src/repro_torch/csrc`` with nvcc (one process per source, in parallel)
   and print each build's ``-Xptxas -v`` report and each kernel's SASS
   instruction count;
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (fused SWE step at 288x288 and 96x96 with B = 8, the
   directional sweep at 288x288 in x and y, the Matérn matrix at (8, 2) x
   (512, 2) and (130, 5) x (70, 5), the Matérn posterior mean at (8, 2) x
   (512, 2), (1, 2) x (512, 2) and (5, 3) x (300, 3) with p = 4, also bit
   for bit against the matrix kernel and the PyTorch contraction); flash
   attention over the reference's six test
   cases in fp32 (the CUDA-core route) and in bf16 (the tensor-core route),
   its bf16 case, and qwen2-0.5b's heads at 4096 tokens against the
   materialising plain version and the plain blocked loop, and at 32768
   tokens in bf16 and fp32 against the blocked loop, the bf16 cases and the
   qwen2 shapes also per row relative to the row's size), hold each fused
   SWE step bit for bit against the two sweep kernels and the Euler update,
   check lake-at-rest through the kernels, and time kernel and plain
   version with CUDA events, beside the launch floor (a 1-element
   ``zero_()``), and a level-0 ``batch_call`` at B = 8 by the host's clock
   before and after the posterior-mean kernel; then build each of
   ``PLANTED_FAULTS`` (an edit of a kernel source) and fail unless the
   checks of that source reject every one;
3. check batch invariance: B = 1 rows against B = 8 rows, bit for bit, for
   the coarse and fine batched forwards and for ``GaussianProcess.batch_call``,
   and that one ``batch_call`` launches one CUDA kernel (``torch.profiler``);
4. drive the MLDA main path, ``repro_torch.launch.tsunami.run``, at the
   ``paper`` preset's widths (96x96 and 288x288 grids, 512 LHS points, 200
   Adam steps, 5 chains through the balancer), with the launch counters set
   to 0 just before; every kernel of the path must launch (for Matérn, the
   posterior-mean route); check the outputs against the plain path;
5. the LM slice's prefill: qwen2-0.5b at full width in bf16 (seeded random
   weights) on one 32768-token prompt, counters at 0 just before; the
   tensor-core flash kernel must launch once per layer, the fp32 one never; the last position's logits must be
   finite, and may differ from the same prefill through the plain blocked
   attention by at most twice the difference between two sound plain
   prefills (64- and 512-key blocks);
6. the LM slice's serving: ``ServingEngine`` in continuous (8 slots) and
   generation mode on 16 requests (32-token prompts, 1 to 64 new tokens);
   the two modes' tokens, and each first token against the kernel path's
   prefill, must agree wherever the reference's top-2 logit gap is at least
   twice a control difference measured without the kernel (the chunked
   prefill against the serving prefill), which also bounds the kernel
   prefill's own difference and the difference between the modes;
7. print the ``kernels`` JSON line, then the result line.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from functools import partial
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
PEAK_BF16_FLOPS = 989e12  # dense, tensor cores
# Tolerances of each kernel against its plain version on the same inputs.
# The SWE kernels are compared one step at a time from the same input: over
# several steps a 1-ulp difference in h at 7 km depth (0.5 mm of sea
# surface; PyTorch's CUDA division by a Python scalar is not IEEE-rounded,
# the kernel's division is) feeds back into the momenta at ~1e-4 of their size.
SWE_REL_TOL = 1e-5  # max |kernel - plain| / max(max |plain|, 1), per step
SWEEP_REL_TOL = 1e-5  # same measure for one sweep's tendencies
MATERN_ATOL = 5e-6  # as the reference's kernel test
# The posterior-mean kernel: held bit for bit against the matrix kernel
# followed by the PyTorch contraction (the same operations in the same
# order), and against its plain version within the Matérn bound carried
# through the sum: 5e-6 sum_j |alpha_jq| y_scale_q for output q.  Shapes
# (B, n, d) with p outputs: the main path's, its B = 1 rows, a ragged one.
MATERN_MEAN_CASES = ((8, 512, 2), (1, 512, 2), (5, 300, 3))
MATERN_MEAN_P = 4
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
# Flash attention against its plain versions: the reference's own bounds
# (tests/test_kernels.py, fp32 and bf16), and its six fp32 test cases
# (B, H, Hkv, S, D, causal, window).
FLASH_FP32_ATOL = 3e-5
FLASH_BF16_ATOL = 3e-2
# The absolute bounds do not scale with the output: a causal row averages
# the values of all keys it sees, so at 32k tokens its outputs are ~0.01,
# below the bf16 bound.  The qwen2-shaped comparisons are therefore also
# held per row: the row's largest difference over the row's largest plain
# value.  Two sound blocked computations (64- and 512-key blocks) differ by
# one bf16 step of the row's largest value (2^-7) and by ~1e-6 in fp32; the
# limits are two bf16 steps and 1e-4.
FLASH_BF16_ROW_RTOL = 2.0**-6
FLASH_FP32_ROW_RTOL = 1e-4
# Planted faults: each is one textual edit of a kernel source in csrc/,
# built into its own library under build/planted/; the checks of that
# source's kernels (flash_checks, swe_step_checks, matern_checks) must
# reject every one.
# A rewrite of a kernel rewrites its edits with it.
PLANTED_FAULTS = {
    # The diagonal kv tile left out of every query tile past row 8192 in the
    # bf16 tensor-core kernel: a fault of the long rows only.
    "long_rows_diagonal_dropped": (
        "flash_attention.cu",
        "if (causal) kt_hi = min(kt_hi, (q0 + q_rows - 1) / kBlockN);",
        "if (causal) kt_hi = min(kt_hi, (q0 + q_rows - 1) / kBlockN);\n"
        "  if (causal && q0 >= 8192) --kt_hi;",
    ),
    # The tensor-core kernel's accumulator not rescaled when the second kv
    # tile raises the max.
    "second_tile_rescale_skipped": (
        "flash_attention.cu",
        "for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];",
        "for (int i = 0; i < D / 2; ++i) acc[i] *= (it == 1 ? 1.f : alpha[(i >> 1) & 1]);",
    ),
    # The SWE tiles' halo (the fused step's and the y sweep's): the halo row
    # past the tile's last row is loaded from the last row itself, so the
    # tile's last y faces see no neighbour.
    "swe_halo_row_own_row": (
        "swe_flux.cu",
        "const int i = min(max(i0 + r - 1, 0), ny - 1);",
        "const int i = min(max(i0 + r - 1 - (r == TY + 1), 0), ny - 1);",
    ),
    # The x sweep's halo: the column east of the tile is loaded from the
    # tile's own last column.
    "sweep_x_halo_own_column": (
        "swe_flux.cu",
        "load_halo_cell(s, 1 + (c >> 1), (c & 1) * (kTileW + 1), h, hu, hv, b, off, i0, j0, ny,\n"
        "                     nx);",
        "load_halo_cell(s, 1 + (c >> 1), (c & 1) * (kTileW + 1), h, hu, hv, b, off, i0,\n"
        "                     j0 - (c & 1), ny, nx);",
    ),
    # The posterior-mean kernel sums its tree in another order (each term
    # with its mirror image instead of the term half the width away): every
    # value stays within the Matérn bound, only the bits change.
    "mean_tree_mirror_order": (
        "matern.cu",
        "s[q * width + j] += s[q * width + j + half];",
        "s[q * width + j] += s[q * width + 2 * half - 1 - j];",
    ),
}
FLASH_CASES = [
    (2, 4, 2, 128, 64, True, None),
    (1, 8, 8, 256, 32, True, None),
    (2, 4, 1, 200, 64, True, None),
    (1, 4, 2, 256, 64, False, None),
    (1, 4, 2, 384, 64, True, 128),
    (1, 2, 2, 512, 128, True, 256),
]
# The LM slice: qwen2-0.5b at full width; the prefill_32k shape with its
# global batch cut from 32 to 1 (the fp32 logits of every position take
# 19.9 GB per sequence); serving as launch/serve.py draws its requests.
LM_ARCH = "qwen2-0.5b"
FLASH_PLAIN_LEN = 4096  # the longest prompt the materialising plain version fits
SERVE_REQUESTS = 16
SERVE_PROMPT_LEN = 32
SERVE_CACHE_LEN = 128
SERVE_SLOTS = 8
# A kernel-path logit difference may be at most this many times the
# control's: the difference between two sound plain computations of the same
# logits (prefill: 64- vs 512-key blocks; first tokens: the chunked prefill
# vs the serving prefill's decode steps).
PREFILL_DIFF_FACTOR = 2.0
# Each MLDA row of the kernels line and the launch counter that the main
# path must raise: the Matérn row's is the posterior-mean route (its matrix
# route serves the variance, which the main path does not ask for).
MLDA_KERNELS = {"swe_fused_step": "swe_fused_step", "swe_sweep": "swe_sweep",
                "matern52": "matern52_mean"}
KERNEL_ORDER = (*MLDA_KERNELS, "flash_attention")


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
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
    LIBRARY.build(["swe_flux", "matern", "flash_attention"])
    print(f"[1] built kernels in {time.perf_counter() - t0:.1f}s into {LIBRARY.build_dir}")
    for name, log in sorted(LIBRARY.ptxas_log.items()):
        print(f"[1] nvcc -Xptxas -v ({name}.cu):")
        for line in log.strip().splitlines():
            print(f"      {line}")
    for name in ("swe_flux", "matern", "flash_attention"):
        try:
            counts = LIBRARY.sass_counts(name)
        except (OSError, subprocess.CalledProcessError) as e:
            fail(f"cuobjdump -sass of {name}.cu failed: {e}")
        print(f"[1] SASS instructions ({name}.cu, cuobjdump -sass, NOPs left out): "
              + "; ".join(f"{fn} {n}" for fn, n in sorted(counts.items())))


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


def _swe_thetas(torch, gen):
    return (torch.rand((8, 2), generator=gen) * 400.0 - 200.0).cuda()


def swe_step_checks(torch, thetas):
    """The SWE kernels (whichever library ``build.LIBRARY`` loads) against
    their plain versions, as ``(label, measure, error, limit)``; also the
    largest absolute differences ``{"fused": .., "sweep": ..}`` and the
    288x288 case ``(scenario, state, b, dt)``.

    The fused step at 288x288 and 96x96 with B = 8, one step at a time from
    the plain trajectory's state (errors do not compound), over 4 steps.
    Each step is also held bit for bit against the two sweep kernels and
    the Euler update in PyTorch (``swe_ops.swe_step``): the same IEEE
    operations in the same order, so a face computed once in a tile of both
    directions must have the bits of a face computed in a tile of one.  The
    measure is the count of unequal values, limit 1.  Then one sweep in x
    and in y at 288x288, B = 1 (the main path's single fine solve),
    relative to each plane's largest plain value."""
    from repro_torch.kernels.swe_flux import ops as swe_ops
    from repro_torch.kernels.swe_flux.ref import swe_fused_step_ref, swe_sweep_ref
    from repro_torch.swe import TohokuScenario
    from repro_torch.swe.solver import SWEState

    out, fused_err = [], 0.0
    for n in (288, 96):
        sc = TohokuScenario(nx=n, ny=n)
        state, b, dt = _swe_batch(torch, sc, thetas, 3)
        p_state = state
        for t in range(4):
            k_state = swe_ops.swe_step_batched(p_state, b, dt, cfg=sc.cfg)
            p_next = swe_fused_step_ref(p_state, b, dt, cfg=sc.cfg)
            torch.cuda.synchronize()
            s_state = swe_ops.swe_step(p_state, b, dt, cfg=sc.cfg)
            torch.cuda.synchronize()
            for name, k, p, s in zip("h hu hv".split(), k_state, p_next, s_state):
                fused_err = max(fused_err, float((k - p).abs().max()))
                out.append((f"swe_fused_step {n}x{n} B=8 step {t} {name}", "rel err",
                            rel_err(k, p), SWE_REL_TOL))
                out.append((f"swe_fused_step {n}x{n} B=8 step {t} {name} vs sweeps + Euler",
                            "unequal values", int((k != s).sum()), 1))
            p_state = p_next
        if n == 288:
            case = (sc, state, b, dt)
    sc, state, b, _ = case
    one = SWEState(*(x[0].contiguous() for x in state))
    sweep_err = 0.0
    for axis, d in ((0, sc.cfg.dx), (1, sc.cfg.dy)):
        k = swe_ops.swe_sweep(*one, b, axis=axis, g=sc.cfg.g, d=d)
        p = swe_sweep_ref(*one, b, axis=axis, g=sc.cfg.g, d=d)
        torch.cuda.synchronize()
        for name, kk, pp in zip(("dh", "dhu", "dhv"), k, p):
            diff = float((kk - pp).abs().max())
            sweep_err = max(sweep_err, diff)
            out.append((f"swe_sweep 288x288 axis={axis} {name}", "rel err",
                        diff / max(float(pp.abs().max()), 1e-30), SWEEP_REL_TOL))
    return out, {"fused": fused_err, "sweep": sweep_err}, case


def _mean_inputs(torch, gen, B: int, n: int, d: int, p: int):
    """Posterior-mean inputs as a level-0 GP holds them: raw points in the
    prior box, lengthscales ~100, scaled training points, alpha, y_scale,
    y_mean; all on the card."""
    ls = 100.0 * torch.exp(0.3 * torch.randn(d, generator=gen))
    x = torch.rand((B, d), generator=gen) * 400.0 - 200.0
    xs = (torch.rand((n, d), generator=gen) * 400.0 - 200.0) / ls
    alpha = torch.randn((n, p), generator=gen)
    y_scale = torch.exp(torch.randn(p, generator=gen))
    y_mean = torch.randn(p, generator=gen)
    return [v.cuda().contiguous() for v in (x, ls, xs, alpha, y_scale, y_mean)]


def matern_checks(torch):
    """The Matérn kernels (whichever library ``build.LIBRARY`` loads)
    against their plain versions on the card, as ``(label, measure, error,
    limit)``, and the largest absolute differences ``{"matrix": ..,
    "mean": ..}``.

    The matrix kernel at atol 5e-6.  The posterior-mean kernel bit for bit
    against the matrix kernel followed by the PyTorch contraction that
    ``predict`` ran before the mean kernel (unequal values, limit 1), and against its plain version per output
    relative to the Matérn bound carried through the sum (limit 1)."""
    from repro_torch.kernels.matern import ops as matern_ops
    from repro_torch.kernels.matern.ref import (
        matern52_mean_ref, matern52_ref, posterior_mean_from_matrix,
    )

    gen = torch.Generator().manual_seed(2)
    out, err = [], {"matrix": 0.0, "mean": 0.0}
    for (n, m, d) in ((8, 512, 2), (130, 70, 5)):
        a = torch.randn((n, d), generator=gen).cuda() / 0.7
        bb = torch.randn((m, d), generator=gen).cuda() / 0.7
        k = matern_ops.matern52_scaled(a, bb, 1.3)
        torch.cuda.synchronize()
        e = float((k - matern52_ref(a, bb, 1.3)).abs().max())
        err["matrix"] = max(err["matrix"], e)
        out.append((f"matern52 ({n},{d})x({m},{d})", "max abs err", e, MATERN_ATOL))
    for (B, n, d) in MATERN_MEAN_CASES:
        x, ls, xs, alpha, ys, ym = _mean_inputs(torch, gen, B, n, d, MATERN_MEAN_P)
        label = f"matern52_mean ({B},{d})x({n},{d}) p={MATERN_MEAN_P}"
        got = matern_ops.matern52_mean(x, ls, xs, alpha, ys, ym, 1.3)
        ks = matern_ops.matern52_scaled((x / ls).contiguous(), xs, 1.3)
        composed = posterior_mean_from_matrix(ks, alpha, ys, ym)
        plain = matern52_mean_ref(x, ls, xs, alpha, ys, ym, 1.3)
        torch.cuda.synchronize()
        out.append((f"{label} vs matrix kernel + contraction", "unequal values",
                    int((got != composed).sum()), 1))
        bound = MATERN_ATOL * alpha.abs().sum(0) * ys
        diff = (got - plain).abs()
        err["mean"] = max(err["mean"], float(diff.max()))
        out.append((f"{label} vs plain", "max err / bound", float((diff / bound).max()), 1.0))
    return out, err


def _level0_gp(torch):
    """A level-0 GP as the main path fits it (512 LHS points in the prior
    box, four smooth outputs), with 20 Adam steps; on the card."""
    from repro_torch.core.gp import fit_gp
    from repro_torch.core.lhs import latin_hypercube, scale_to_bounds

    gen = torch.Generator().manual_seed(1)
    x = scale_to_bounds(latin_hypercube(gen, 512, 2), [-200, -200], [200, 200]).cuda()
    y = torch.stack([torch.sin(x[:, 0] / 90), torch.cos(x[:, 1] / 70),
                     x[:, 0] * x[:, 1] / 4e4, torch.tanh(x[:, 0] / 150)], dim=1)
    return fit_gp(x, y, steps=20)


def _predict_before(gp, x):
    """The posterior mean as the level-0 call computed it before the mean
    kernel: the lengthscales' exp, the division, the matrix kernel, then
    the product with alpha, nine halving adds and the affine step."""
    from repro_torch.kernels.matern import ops as matern_ops
    from repro_torch.kernels.matern.ref import posterior_mean_from_matrix

    a = (x / gp.params.log_lengthscales.exp()).contiguous()
    ks = matern_ops.matern52_scaled(a, gp._x_scaled, gp._outputscale)
    return posterior_mean_from_matrix(ks, gp.alpha, gp.y_scale, gp.y_mean)


def host_time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean wall time of ``fn`` per call by the host's clock, each call
    ended by ``torch.cuda.synchronize()``: what a caller that waits for the
    result sees."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / iters * 1e3


def cuda_kernels_of(torch, fn):
    """The names of the CUDA kernels that one call of ``fn`` launches, from
    ``torch.profiler`` (copies and memsets left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def phase_kernels(torch, rows):
    from repro_torch.kernels.matern import ops as matern_ops
    from repro_torch.kernels.matern.ref import matern52_mean_ref, matern52_ref
    from repro_torch.kernels.swe_flux import ops as swe_ops
    from repro_torch.kernels.swe_flux.ref import swe_fused_step_ref, swe_sweep_ref
    from repro_torch.swe import TohokuScenario
    from repro_torch.swe.solver import H_EPS, SWEState

    gen = torch.Generator().manual_seed(0)
    thetas = _swe_thetas(torch, gen)

    # -- SWE: fused step per step, sweeps in x and y, against plain ----------
    checks, swe_err, fused_case = swe_step_checks(torch, thetas)
    # -- Matérn: matrix and posterior mean -----------------------------------
    m_checks, matern_err = matern_checks(torch)
    for label, measure, err, limit in checks + m_checks:
        print(f"[2] {label}: {measure} {err:.3e} (limit {limit:.3e})")
        if not err < limit:
            fail(f"{label} {measure} {err} >= {limit}")
    sc, state, b, dt = fused_case
    one = SWEState(*(x[0].contiguous() for x in state))

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

    # -- timing at the main path's heaviest shapes ---------------------------
    # The launch floor: one 1-element zero_(), timed as the kernels are.
    one_float = torch.empty(1, device="cuda")
    floor_ms = device_time_ms(torch, one_float.zero_, 400)
    B, ny, nx = state.h.shape
    cur = SWEState(*(x.contiguous() for x in state))
    nxt = SWEState(*(torch.empty_like(x) for x in state))
    bufs = [cur, nxt]

    def fused_once():
        swe_ops.swe_step_batched(bufs[0], b, dt, cfg=sc.cfg, out=bufs[1])
        bufs.reverse()

    fused_ms = device_time_ms(torch, fused_once, 400)
    # The same kernel over a whole fine solve from the source, as the main
    # path runs it: the cost of a step follows the state (a zero dividend,
    # on dry land or ahead of the wave, skips its division).
    n_fine = sc.build_batch_forward().n_steps
    start = SWEState(*(x.contiguous() for x in _swe_batch(torch, sc, thetas, 0)[0]))

    def whole_solve():
        for dst, src in zip(bufs[0], start):
            dst.copy_(src)
        for _ in range(n_fine):
            fused_once()

    whole_ms = device_time_ms(torch, whole_solve, 1, warmup=0) / n_fine
    sc96 = TohokuScenario(nx=96, ny=96)
    state96, b96, dt96 = _swe_batch(torch, sc96, thetas, 3)
    bufs96 = [SWEState(*(x.contiguous() for x in state96)),
              SWEState(*(torch.empty_like(x) for x in state96))]

    def fused96_once():
        swe_ops.swe_step_batched(bufs96[0], b96, dt96, cfg=sc96.cfg, out=bufs96[1])
        bufs96.reverse()

    fused96_ms = device_time_ms(torch, fused96_once, 400)
    fused_plain_ms = device_time_ms(
        torch, lambda: swe_fused_step_ref(state, b, dt, cfg=sc.cfg), 20
    )
    plane = ny * nx * 4
    f_bound = bound_ms(2 * 3 * B * plane + plane, FUSED_FLOPS_PER_CELL * B * ny * nx)
    sweep_ms, sweep_plain_ms = {}, {}
    for axis, d in ((0, sc.cfg.dx), (1, sc.cfg.dy)):
        sweep_ms[axis] = device_time_ms(
            torch, lambda: swe_ops.swe_sweep(*one, b, axis=axis, g=sc.cfg.g, d=d), 400
        )
        sweep_plain_ms[axis] = device_time_ms(
            torch, lambda: swe_sweep_ref(*one, b, axis=axis, g=sc.cfg.g, d=d), 20
        )
    s_bound = bound_ms(7 * plane, SWEEP_FLOPS_PER_CELL * ny * nx)

    # Matérn: the mean kernel at the main path's shape, the matrix kernel at
    # the same points, and a whole level-0 batch_call at B = 8 by the host's
    # clock, before (the matrix kernel and the PyTorch contraction) and
    # after (the mean kernel), in turns.
    mb, mn, md, mp = 8, 512, 2, MATERN_MEAN_P
    mean_in = _mean_inputs(torch, gen, mb, mn, md, mp)
    mean_ms = device_time_ms(torch, lambda: matern_ops.matern52_mean(*mean_in, 1.3), 400)
    mean_plain_ms = device_time_ms(torch, lambda: matern52_mean_ref(*mean_in, 1.3), 20)
    m_bound = bound_ms((mb * md + md + mn * md + mn * mp + 2 * mp + mb * mp) * 4,
                       mb * mn * (3 * md + 15 + 2 * mp) + 2 * mb * mp)
    a = (mean_in[0] / mean_in[1]).contiguous()
    xs = mean_in[2]
    matern_ms = device_time_ms(torch, lambda: matern_ops.matern52_scaled(a, xs, 1.3), 400)
    matern_plain_ms = device_time_ms(torch, lambda: matern52_ref(a, xs, 1.3), 20)
    mx_bound = bound_ms((mb * md + mn * md + mb * mn) * 4, mb * mn * (3 * md + 15))
    gp = _level0_gp(torch)
    thetas8 = (torch.rand((8, 2), generator=gen) * 400.0 - 200.0).cuda()
    walls = {"before": [], "after": []}
    for which in ("before", "after", "after", "before"):
        fn = (partial(_predict_before, gp, thetas8) if which == "before"
              else partial(gp.batch_call, thetas8))
        walls[which].append(host_time_ms(torch, fn, 200))
    call_ms = {k: sum(v) / len(v) for k, v in walls.items()}
    print(f"[2] launch floor (one 1-element zero_(), CUDA events): {floor_ms:.4f} ms")
    print("[2] device time per call (CUDA events): "
          f"fused 288x288 B=8 {fused_ms:.4f} ms (plain {fused_plain_ms:.4f}), over a whole "
          f"{n_fine}-step solve {whole_ms:.4f} ms a step, 96x96 B=8 {fused96_ms:.4f} ms; "
          f"sweep 288x288 B=1 x {sweep_ms[0]:.4f} ms (plain "
          f"{sweep_plain_ms[0]:.4f}), y {sweep_ms[1]:.4f} ms (plain {sweep_plain_ms[1]:.4f}); "
          f"matern52_mean (8,2)x(512,2) p={mp} {mean_ms:.4f} ms (plain {mean_plain_ms:.4f}); "
          f"matern52 matrix (8,2)x(512,2) {matern_ms:.4f} ms (plain {matern_plain_ms:.4f}); "
          f"launch floor {floor_ms:.4f} ms; "
          "library_ms: no single PyTorch call computes any of these functions")
    print(f"[2] level-0 GaussianProcess.batch_call at B=8 (host clock, ending in synchronize, "
          f"mean of 2 x 200 calls in turns): before (matrix kernel + PyTorch contraction) "
          f"{call_ms['before']:.4f} ms, after (mean kernel) {call_ms['after']:.4f} ms; "
          f"runs {', '.join(f'{k} ' + '/'.join(f'{x:.4f}' for x in v) for k, v in walls.items())}")
    rows.update({
        "swe_fused_step": dict(
            route="cuda", source="src/repro_torch/csrc/swe_flux.cu",
            replaces="src/repro/kernels/swe_flux/swe_flux.py:204",
            max_abs_err=swe_err["fused"], shape=f"({B}, {ny}, {nx}) fp32", ms=fused_ms,
            plain_ms=fused_plain_ms,
            ms_whole_solve=whole_ms, whole_solve=f"{n_fine} steps from the source, ms a step",
            ms_at_coarse_shape=fused96_ms, coarse_shape=f"({B}, 96, 96) fp32",
            bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None,
        ),
        "swe_sweep": dict(
            route="cuda", source="src/repro_torch/csrc/swe_flux.cu",
            replaces="src/repro/kernels/swe_flux/swe_flux.py:108",
            max_abs_err=swe_err["sweep"], shape=f"({ny}, {nx}) fp32, x sweep", ms=sweep_ms[0],
            plain_ms=sweep_plain_ms[0], ms_y=sweep_ms[1], plain_ms_y=sweep_plain_ms[1],
            bound_ms=s_bound[0], bound_by=s_bound[1], library_ms=None,
        ),
        "matern52": dict(
            route="cuda", source="src/repro_torch/csrc/matern.cu",
            replaces="src/repro/kernels/matern/matern.py:58",
            max_abs_err=matern_err["mean"], shape=f"({mb}, {md}) x ({mn}, {md}) fp32, p = {mp}",
            ms=mean_ms, plain_ms=mean_plain_ms, bound_ms=m_bound[0], bound_by=m_bound[1],
            library_ms=None, launch_floor_ms=floor_ms,
            kernel="matern52_mean_kernel: the posterior mean, one block a query row",
            batch_call_ms_before=call_ms["before"], batch_call_ms_after=call_ms["after"],
            matrix_kernel="matern52_kernel: the kernel matrix, for the posterior variance",
            matrix_max_abs_err=matern_err["matrix"], matrix_ms=matern_ms,
            matrix_plain_ms=matern_plain_ms, matrix_bound_ms=mx_bound[0],
        ),
    })


def _top2_gap(torch, logits) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def flash_checks(torch):
    """Every comparison of the flash kernel (whichever library
    ``build.LIBRARY`` loads) with a plain version on the card, as
    ``(label, measure, error, limit)``, and the qwen2-shaped bf16 inputs at
    4096 and at the prefill length."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.chunked_attention import attention_chunked

    gen = torch.Generator().manual_seed(4)
    out = []

    def qkv(b, h, hkv, s, d, dtype):
        return [torch.randn(shape, generator=gen).to("cuda", dtype)
                for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]

    def record(label, got, want, atol, row_rtol=None):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        out.append((label, "max abs err", float(diff.max()), atol))
        if row_rtol is not None:
            row = diff.amax(-1) / want.float().abs().amax(-1).clamp_min(1e-30)
            out.append((label, "max row-relative err", float(row.max()), row_rtol))

    for (b, h, hkv, s, d, causal, window) in FLASH_CASES:
        q, k, v = qkv(b, h, hkv, s, d, torch.float32)
        record(f"fp32 {(b, h, hkv, s, d)} causal={causal} window={window}",
               fa.flash_attention(q, k, v, causal=causal, window=window),
               attention_ref(q, k, v, causal=causal, window=window), FLASH_FP32_ATOL)
    # The same cases in bf16 reach the tensor-core kernel's window, ragged S,
    # MQA and D = 32 / 128 paths; held against the plain blocked loop, which
    # keeps the kernel's fp32 scores (attention_ref rounds them to bf16).
    for (b, h, hkv, s, d, causal, window) in FLASH_CASES:
        q, k, v = qkv(b, h, hkv, s, d, torch.bfloat16)
        record(f"bf16 {(b, h, hkv, s, d)} causal={causal} window={window}",
               fa.flash_attention(q, k, v, causal=causal, window=window),
               attention_chunked(q, k, v, causal=causal, window=window), FLASH_BF16_ATOL,
               FLASH_BF16_ROW_RTOL)
    q, k, v = qkv(1, 2, 2, 128, 64, torch.bfloat16)
    record("bf16 (1, 2, 2, 128, 64) vs fp32 plain on the same values",
           fa.flash_attention(q, k, v), attention_ref(q.float(), k.float(), v.float()),
           FLASH_BF16_ATOL)

    # qwen2-0.5b's attention: 14 query heads on 2 kv heads, head dim 64.
    # attention_ref rounds its scores to bf16 (the kernel keeps them in
    # fp32), so the per-row measure is taken against attention_chunked.
    cfg = _lm_config()
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s4, s_long = FLASH_PLAIN_LEN, _prefill_len()
    short = qkv(1, h, hkv, s4, d, torch.bfloat16)
    got = fa.flash_attention(*short)
    record(f"bf16 (1, {h}, {hkv}, {s4}, {d}) causal vs attention_ref", got,
           attention_ref(*short), FLASH_BF16_ATOL)
    record(f"bf16 (1, {h}, {hkv}, {s4}, {d}) causal vs attention_chunked", got,
           attention_chunked(*short), FLASH_BF16_ATOL, FLASH_BF16_ROW_RTOL)
    for dtype, name, atol, row_rtol in (
        (torch.float32, "fp32", FLASH_FP32_ATOL, FLASH_FP32_ROW_RTOL),
        (torch.bfloat16, "bf16", FLASH_BF16_ATOL, FLASH_BF16_ROW_RTOL),
    ):
        long = qkv(1, h, hkv, s_long, d, dtype)
        record(f"{name} (1, {h}, {hkv}, {s_long}, {d}) causal vs attention_chunked",
               fa.flash_attention(*long), attention_chunked(*long), atol, row_rtol)
    return out, short, long


def phase_flash(torch, rows):
    """Flash attention against its plain versions, and its times."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    checks, (q4, k4, v4), (q, k, v) = flash_checks(torch)
    for label, measure, err, limit in checks:
        print(f"[2] flash_attention {label}: {measure} {err:.3e} (limit {limit:.3e})")
        if not err < limit:
            fail(f"flash_attention {label}: {measure} {err} >= {limit}")
    h, hkv, s_long, d = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    s4 = q4.shape[2]

    ms = device_time_ms(torch, lambda: fa.flash_attention(q, k, v), 5, warmup=1)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    fp32_ms = device_time_ms(torch, lambda: fa.flash_attention(q32, k32, v32), 3, warmup=1)
    del q32, k32, v32
    ms4 = device_time_ms(torch, lambda: fa.flash_attention(q4, k4, v4), 20)
    plain_ms4 = device_time_ms(torch, lambda: attention_ref(q4, k4, v4), 5, warmup=1)
    library_ms = device_time_ms(
        torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        20,
    )
    pairs = s_long * (s_long + 1) // 2  # visible (q, k) pairs under the causal mask
    f_bound = bound_ms((2 * h + 2 * hkv) * s_long * d * 2, 4 * h * d * pairs, PEAK_BF16_FLOPS)
    print(f"[2] flash_attention device time per call (CUDA events): (1, {h}, {hkv}, {s_long}, "
          f"{d}) bf16 causal {ms:.4f} ms (bound {f_bound[0]:.4f} ms by {f_bound[1]}; "
          f"scaled_dot_product_attention {library_ms:.4f} ms); at S={s4} kernel "
          f"{ms4:.4f} ms, plain attention_ref {plain_ms4:.4f} ms; the fp32 route (CUDA cores) "
          f"at S={s_long} {fp32_ms:.4f} ms")
    rows["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:113",
        max_abs_err=max(err for label, measure, err, _ in checks
                        if label.startswith(f"bf16 (1, {h}, ") and measure == "max abs err"),
        shape=f"(1, {h}, {hkv}, {s_long}, {d}) bf16 causal", ms=ms,
        plain_ms=plain_ms4, plain_shape=f"(1, {h}, {hkv}, {s4}, {d}) bf16 causal, attention_ref",
        ms_at_plain_shape=ms4, bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=library_ms,
        kernel="flash_fwd_wgmma_kernel: bf16, tensor cores (wgmma, TMA)",
        fp32_kernel="flash_fwd_fp32_kernel: fp32, CUDA cores, same source",
        fp32_ms=fp32_ms, fp32_shape=f"(1, {h}, {hkv}, {s_long}, {d}) fp32 causal",
    )


def phase_planted_faults(torch) -> None:
    """Build each of ``PLANTED_FAULTS`` from an edited copy of its source
    under build/planted/ and run the checks of that source's kernels on it:
    each fault must fail one, or the checks are too weak to trust."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build

    checks_of = {
        "flash_attention.cu": lambda: flash_checks(torch)[0],
        "swe_flux.cu": lambda: swe_step_checks(
            torch, _swe_thetas(torch, torch.Generator().manual_seed(0)))[0],
        "matern.cu": lambda: matern_checks(torch)[0],
    }
    libs = {}
    for name, (source, old, new) in PLANTED_FAULTS.items():
        src = (build.CSRC / source).read_text()
        if src.count(old) != 1:
            fail(f"planted fault {name}: its edit does not match {source} exactly once")
        d = REPO / "build" / "planted" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(src.replace(old, new))
        libs[name] = (source, build.KernelLibrary(d / "kernels", csrc=d))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda sl: sl[1].build([Path(sl[0]).stem]), libs.values()))
    print(f"[2] built {len(libs)} planted faults in {time.perf_counter() - t0:.1f}s")
    committed = build.LIBRARY
    for name, (source, lib) in libs.items():
        build.LIBRARY = lib
        try:
            checks = checks_of[source]()
        finally:
            build.LIBRARY = committed
        failed = [c for c in checks if not c[2] < c[3]]
        for label, measure, err, limit in checks:
            print(f"[2] planted fault {name}: {label}: {measure} {err:.3e} (limit {limit:.3e})"
                  f"{'' if err < limit else ' REJECTED'}")
        n_abs = sum(1 for c in failed if c[1] == "max abs err")
        print(f"[2] planted fault {name} ({source}): rejected by {len(failed)} of {len(checks)} "
              f"checks ({n_abs} absolute, {len(failed) - n_abs} other)")
        if not failed:
            fail(f"planted fault {name} passes every check of {source}")


# ---------------------------------------------------------------------------
# phase 3: batch invariance
# ---------------------------------------------------------------------------
def phase_batch_invariance(torch, w):
    import numpy as np

    from repro_torch.kernels.matern import ops as matern_ops
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
    gp = _level0_gp(torch)
    before = matern_ops.MEAN_LAUNCHES.value
    full = gp.batch_call(thetas)
    rows1 = torch.cat([gp.batch_call(thetas[i : i + 1]) for i in range(8)])
    if matern_ops.MEAN_LAUNCHES.value != before + 9:
        fail("GP batch_call did not go through the posterior-mean kernel once a call")
    if not torch.equal(full, rows1):
        fail("GP batch_call: B=1 rows differ from B=8 rows")
    print("[3] level 0 GaussianProcess.batch_call (n=512, mean kernel): B=1 rows == B=8 rows "
          "bit for bit")
    # What one level-0 call launches on the card, under the profiler.
    after = cuda_kernels_of(torch, lambda: gp.batch_call(thetas))
    old = cuda_kernels_of(torch, lambda: _predict_before(gp, thetas))
    print(f"[3] CUDA kernels of one batch_call at B=8 (torch.profiler): {len(after)} "
          f"({', '.join(sorted(set(after)))}); before the mean kernel (matrix kernel + PyTorch "
          f"contraction): {len(old)}")
    if len(after) != 1:
        fail(f"one level-0 batch_call launched {len(after)} CUDA kernels, want 1: {after}")


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
    for name, counter in MLDA_KERNELS.items():
        rows[name]["launches"] = launches.get(counter, 0)
        if rows[name]["launches"] <= 0:
            fail(f"kernel {counter} was not launched by the main path")
    rows["matern52"]["matrix_launches"] = launches.get("matern52", 0)
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


# ---------------------------------------------------------------------------
# phases 5 and 6: the LM slice at full width
# ---------------------------------------------------------------------------
def _lm_config():
    from repro_torch.configs import ARCHS

    return ARCHS[LM_ARCH]


def _prefill_len() -> int:
    from repro_torch.configs import SHAPES

    return SHAPES["prefill_32k"].seq_len


def phase_lm_prefill(torch, cfg, params, rows):
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import build_model
    from repro_torch.models import chunked_attention

    s = _prefill_len()
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (1, s), generator=gen).cuda()
    print(f"[5] prefill: {cfg.arch_id} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}), "
          f"{cfg.compute_dtype}, seeded random weights; one {s}-token prompt (prefill_32k with its "
          "global batch cut from 32 to 1)")
    # The kernel path, then the plain blocked attention with 512-key blocks
    # (the default) and, as the control, with 64-key blocks: two sound
    # computations that differ only in where p is rounded, as the kernel's
    # 64-key tiles differ from the 512-key blocks.
    plain = chunked_attention.attention_chunked
    out = {}
    for impl, block_k in (("kernel", None), ("chunked", 512), ("chunked", 64)):
        label = impl if block_k is None else f"{impl}/{block_k}"
        if block_k:
            chunked_attention.attention_chunked = partial(plain, block_k=block_k)
        bundle = build_model(replace(cfg, attn_impl=impl))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_counters()
        t0 = time.perf_counter()
        logits = bundle.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chunked_attention.attention_chunked = plain
        launches = fa.LAUNCHES["tensor_core"].value
        fp32_launches = fa.LAUNCHES["cuda_core"].value
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[5] prefill attn_impl={label}: {wall:.3f} s wall, peak memory {peak:.2f} GiB, "
              f"flash_attention launches: tensor-core route {launches}, fp32 route "
              f"{fp32_launches}")
        if fp32_launches:
            fail(f"the bf16 prefill launched the fp32 flash kernel {fp32_launches} times")
        if impl == "kernel":
            if launches != cfg.n_layers:
                fail(f"prefill launched the tensor-core flash kernel {launches} times, "
                     f"want {cfg.n_layers}")
            rows["flash_attention"]["launches"] = launches
        elif launches != 0:
            fail(f"the chunked prefill launched flash_attention {launches} times")
        if logits.shape != (1, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
            fail(f"prefill ({label}) logits {tuple(logits.shape)} are not finite (1, 1, V)")
        out[label] = logits[0, -1]

    def diff(a, b):
        return float((out[a] - out[b]).abs().max())

    d_kernel, d_ctrl = diff("kernel", "chunked/512"), diff("chunked/64", "chunked/512")
    print(f"[5] last-position logits (range {float(out['kernel'].min()):.3f}.."
          f"{float(out['kernel'].max()):.3f}), max abs diff: kernel vs chunked/512 "
          f"{d_kernel:.4e}, control chunked/64 vs chunked/512 {d_ctrl:.4e}, kernel vs "
          f"chunked/64 {diff('kernel', 'chunked/64'):.4e}; argmax "
          + " / ".join(f"{k} {int(x.argmax())}" for k, x in out.items()))
    if not d_kernel <= PREFILL_DIFF_FACTOR * d_ctrl:
        fail(f"kernel-path logits differ from the plain path's by {d_kernel}, more than "
             f"{PREFILL_DIFF_FACTOR}x the control's {d_ctrl}")


def phase_lm_serving(torch, cfg, params):
    import numpy as np

    from repro_torch.models import build_model
    from repro_torch.models.lm import decode_step, pool_decode_state, slot_insert
    from repro_torch.runtime.serve_loop import ServingEngine, serving_metrics

    name = cfg.arch_id
    rng = np.random.default_rng(0)
    work = []
    for _ in range(SERVE_REQUESTS):  # as launch/serve.py draws them (one variant)
        rng.integers(1)
        n_new = int(rng.choice([1, 4, 16, 64], p=[0.4, 0.3, 0.2, 0.1]))
        work.append((rng.integers(0, cfg.vocab, size=(1, SERVE_PROMPT_LEN)), n_new))
    warm = np.random.default_rng(1).integers(0, cfg.vocab, size=(1, SERVE_PROMPT_LEN))
    tokens = {}
    for mode in ("continuous", "generation"):
        with ServingEngine({name: cfg}, mode=mode, n_slots=SERVE_SLOTS,
                           cache_len=SERVE_CACHE_LEN, device="cuda",
                           params={name: params}) as eng:
            eng.submit(name, warm, 2).result(timeout=600)
            t0 = time.monotonic()
            gens = [eng.submit(name, p, n) for p, n in work]
            for g in gens:
                g.result(timeout=600)
            wall = time.monotonic() - t0
            m = serving_metrics(gens, wall, eng.summary())
        tokens[mode] = [g.result().tokens for g in gens]
        print(f"[6] serving {mode}: {m['n_requests']} requests, {m['n_tokens']} tokens in "
              f"{wall:.3f} s -> {m['tokens_per_s']:.1f} tok/s; ttft mean "
              f"{m['ttft_mean_s'] * 1e3:.2f} ms p99 {m['ttft_p99_s'] * 1e3:.2f} ms; per-token "
              f"p50 {m['per_token_p50_s'] * 1e3:.2f} ms p99 {m['per_token_p99_s'] * 1e3:.2f} ms; "
              f"slot occupancy {m.get('slot_occupancy', {})}")
        for toks, (_, n_new) in zip(tokens[mode], work):
            if len(toks) != n_new:
                fail(f"{mode}: a request asked for {n_new} tokens and got {len(toks)}")

    # First tokens against the kernel path's prefill.  delta_first, the
    # control, is the largest logit difference between two computations that
    # do not run the kernel: the chunked-attention prefill and the serving
    # prefill (decode steps over the same prompt).  The kernel prefill may
    # differ from the serving prefill by at most PREFILL_DIFF_FACTOR times
    # delta_first, and a first token may differ from its argmax only where
    # its top-2 gap is below 2 delta_first.
    bundle = build_model(cfg)
    chunked = build_model(replace(cfg, attn_impl="chunked"))
    pairs, delta_first, delta_kernel = [], 0.0, 0.0
    for p, _ in work:
        t = torch.as_tensor(p).cuda()
        lk = bundle.prefill(params, {"tokens": t})[0, -1]
        lc = chunked.prefill(params, {"tokens": t})[0, -1]
        ls = bundle.prefill_state(params, t, SERVE_CACHE_LEN)[0][0, -1]
        delta_first = max(delta_first, float((lc - ls).abs().max()))
        delta_kernel = max(delta_kernel, float((lk - ls).abs().max()))
        pairs.append((lk, ls))
    print(f"[6] prefill logits vs the serving prefill: kernel path {delta_kernel:.4e}, "
          f"chunked path (control, delta_first) {delta_first:.4e}")
    if not delta_kernel <= PREFILL_DIFF_FACTOR * delta_first:
        fail(f"kernel prefill differs from the serving prefill by {delta_kernel}, more than "
             f"{PREFILL_DIFF_FACTOR}x the chunked path's {delta_first}")
    n_first = 0
    for i, (lk, _) in enumerate(pairs):
        if int(tokens["continuous"][i][0]) != int(tokens["generation"][i][0]):
            fail(f"request {i}: first tokens differ between modes (same B=1 prefill)")
        if int(tokens["generation"][i][0]) != int(lk.argmax()):
            gap = _top2_gap(torch, lk)
            print(f"[6] request {i}: first token {int(tokens['generation'][i][0])} vs kernel "
                  f"prefill argmax {int(lk.argmax())}, top-2 gap {gap:.4e}")
            if not gap < 2 * delta_first:
                fail(f"request {i}: first token diverges at top-2 gap {gap} >= 2 delta")
            n_first += 1

    # Across modes.  delta_mode is the largest logit difference between the
    # B = 1 decode step (generation) and the 8-slot pooled step (continuous)
    # on the same teacher-forced tokens.  Both run the same code on the same
    # weights, so delta_mode must stay below the control delta_first.
    delta_mode, ref_logits, replay_mismatch = 0.0, [], 0
    for (p, _), g in zip(work, tokens["generation"]):
        steps = []
        if len(g) > 1:
            _, st1 = bundle.prefill_state(params, torch.as_tensor(p).cuda(), SERVE_CACHE_LEN)
            pool = pool_decode_state(cfg, SERVE_SLOTS, SERVE_CACHE_LEN, "cuda")
            for slot in range(SERVE_SLOTS):
                pool = slot_insert(pool, st1, slot)
            for j in range(1, len(g)):
                l1, st1 = decode_step(params, cfg, st1, torch.full((1, 1), int(g[j - 1]),
                                                                   device="cuda"))
                l8, pool = decode_step(params, cfg, pool, torch.full((SERVE_SLOTS, 1),
                                                                     int(g[j - 1]), device="cuda"))
                delta_mode = max(delta_mode, float((l1[0, -1] - l8[0, -1]).abs().max()))
                steps.append(l1[0, -1])
                replay_mismatch += int(int(l1[0, -1].argmax()) != int(g[j]))
        ref_logits.append(steps)
    n_mode = 0
    for i, (c, g) in enumerate(zip(tokens["continuous"], tokens["generation"])):
        if np.array_equal(c, g):
            continue
        j = int(np.flatnonzero(c != g)[0])
        gap = _top2_gap(torch, ref_logits[i][j - 1])
        print(f"[6] request {i}: modes diverge at token {j} ({int(c[j])} vs {int(g[j])}), "
              f"top-2 gap {gap:.4e}")
        if not gap < 2 * delta_mode:
            fail(f"request {i}: modes diverge at top-2 gap {gap} >= 2 delta ({delta_mode})")
        n_mode += 1
    if not delta_mode <= delta_first:
        fail(f"B=1 and {SERVE_SLOTS}-slot decode differ by {delta_mode}, more than the "
             f"control {delta_first}")
    print(f"[6] delta (chunked prefill vs serving prefill) {delta_first:.4e}: {n_first} of "
          f"{len(work)} first tokens differ, each at a near tie; delta (B=1 vs {SERVE_SLOTS}-slot "
          f"decode, teacher-forced) {delta_mode:.4e}: {n_mode} of {len(work)} requests diverge "
          f"between modes, each at a near tie; teacher-forced replay mismatches "
          f"{replay_mismatch}")
    if replay_mismatch:
        fail(f"the teacher-forced B=1 replay disagrees with generation mode {replay_mismatch} "
             "times: the card's products are not reproducible")

    # Where a decode step's time goes: host ops issued against kernel time
    # on the card, over a short profiler window of B = 1 steps.
    from torch.profiler import ProfilerActivity, profile

    _, st = bundle.prefill_state(params, torch.as_tensor(work[0][0]).cuda(), SERVE_CACHE_LEN)
    feed = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    n_steps = 5
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            _, st = decode_step(params, cfg, st, feed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events if e.name.startswith("aten::") and e.device_type != torch.autograd.DeviceType.CUDA
           and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_steps
    wall_ms = wall * 1e3 / n_steps
    if kernels:
        print(f"[6] decode step B=1 (profiler, {n_steps} steps): {wall_ms:.3f} ms wall, "
              f"{len(ops) / n_steps:.0f} top-level host ops and {len(kernels) / n_steps:.0f} "
              f"kernels per step, kernel time {busy_ms:.3f} ms: device busy "
              f"{busy_ms / wall_ms:.1%}, idle {1 - busy_ms / wall_ms:.1%}")
    else:
        print(f"[6] decode step B=1: {wall_ms:.3f} ms wall under the profiler, "
              f"{len(ops) / n_steps:.0f} host ops per step; device time not measured "
              "(the profiler saw no kernels)")


def phase_lm(torch, rows):
    """Phases 5 and 6 on one set of seeded full-width weights."""
    from repro_torch.models import build_model

    cfg = _lm_config()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cuda")
    phase_lm_prefill(torch, cfg, params, rows)
    phase_lm_serving(torch, cfg, params)


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
    phase_flash(torch, rows)
    phase_planted_faults(torch)
    phase_batch_invariance(torch, PAPER)
    phase_main_path(torch, PAPER, rows)
    phase_lm(torch, rows)
    print(f"[7] all phases passed in {time.perf_counter() - t_start:.1f}s")
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": n, **{k: rows[n][k] for k in keys},
                **{k: x for k, x in rows[n].items() if k not in keys}} for n in KERNEL_ORDER]
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
