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
   (512, 2) and (130, 5) x (70, 5), the Matérn posterior mean at the seven
   shapes of ``MATERN_MEAN_CASES`` (the main path's p = 4, the series GP's
   p = 519, trees over the shared-memory budget), also bit for bit against
   the matrix kernel and the PyTorch contraction); flash
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
   before and after the posterior-mean kernel; then build or load each of
   ``PLANTED_FAULTS`` (an edit of a kernel source or of ``graphs.py``) and
   fail unless the checks of that source reject every one;
3. check the graph cache (``graph_checks``: a result survives the next
   call, a call answers its own input, the caller's input is untouched);
   check batch invariance: B = 1 rows against B = 8 rows, bit for bit, for
   the coarse and fine batched forwards and for ``GaussianProcess.batch_call``,
   and that one ``batch_call`` launches one CUDA kernel (``torch.profiler``);
   at both levels and B = 1, 3 (padded to 4) and 8, hold the batched
   solver's and forward's graph replays bit for bit against their eager
   loops (series, final state, observables), print the graph keys, the
   launches recorded per graph and the device operations of one B = 8
   replay, and time the B = 8 forward eager against replay; hold the single
   solves' replays (forward at both levels, probe series at the coarse one)
   and the batched series forward's (B = 1, 3, 8) against their eager loops,
   and time the fine single forward eager against replay;
4. drive the MLDA main path, ``repro_torch.launch.tsunami.run``, at the
   ``paper`` preset's widths (96x96 and 288x288 grids, 512 LHS points, 200
   Adam steps, 5 chains through the balancer), with the launch counters set
   to 0 just before; every kernel of the path must launch (for Matérn, the
   posterior-mean route), levels 1 and 2 must evaluate through graph
   replays (``graph_replays`` per level above 0) and most fused-step
   launches must come from replays; check the outputs against the plain
   path, and the Fig. 6 series GP's series (the coarse step count of finite
   values, through the mean kernel at that p, within the Matérn bound of
   the plain mean);
4b. export the card's level pools over loopback (``ServerShell`` on
   127.0.0.1) and drive ``run(..., remote=...)`` through them in binary
   framing (5 chains x 30 fine samples) and UM-Bridge JSON (2 x 5): every
   level has a wire/service split, the kernels launch, the chains are
   finite, and 8 thetas a level through ``RemoteBatchServer`` equal the
   in-process server's rows bit for bit in both protocols;
4c. the device-resident MLDA ensemble on phase 4's hierarchy and GP:
   (a) the fused ensemble (``advance``, one captured graph a top-level
   step) with ``[lp_gp, lp_coarse]`` (``swe.device_densities``), subchain
   ``[10]``, 5 chains padded to 8, 8 steps, and the reference test's three
   toy hierarchies, against step machines on the card (``MLDASampler`` with
   ``CounterStream`` draws and the densities at B = 1): theta bit for bit,
   counts equal; (b) the coupled mode, ``balanced_mlda(device_resident=True)``
   with the fine BatchServers only, 5 chains x 150 fine samples: fine
   samples/s, ``device_seconds``, fine-pool utilization, the balancer's idle
   times, both kernels' launches (mostly from graph replays) and the
   propose graph's wall; (c) chain scaling, a GP-only fused ensemble at C =
   1, 4, 16, 64 (512 steps) against C step machines (64 steps); (d) the
   model protocol: the quickstart's two halves (``launch.quickstart``),
   MALA through separate value and gradient pools of TorchModels, their
   gradient and Jacobian against autograd on the CPU, and a gradient
   through the Matérn kernel refused;
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
   prefill's own difference and the difference between the modes; the
   servers decode through CUDA graphs, so their tokens must equal the eager
   steps' argmaxes exactly and the graphs' logits the eager logits bit for
   bit (teacher-forced on the served tokens; should cuBLAS change bits
   under capture, the graphs are held to the control difference and the
   top-2 rule instead); a decode step at B = 1 and B = 8 is timed eager
   against replay, and the profiler reads the device's busy share and the
   largest device operations of a B = 1 step, eager and replayed;
7. print the ``kernels`` JSON line, then the result line.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from collections import Counter
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
# (B, n, d, p): the main path's, its B = 1 rows, a ragged one; the Fig. 6
# series GP's (p = 519 coarse steps at the paper preset: two output tiles),
# and B = 1 rows of it; a tree over the shared-memory budget (n = 4096, one
# register level); both at once (n = 5000, 37 outputs: ten tiles, two
# register levels).
MATERN_MEAN_CASES = ((8, 512, 2, 4), (1, 512, 2, 4), (5, 300, 3, 4), (8, 32, 2, 519),
                     (1, 32, 2, 519), (8, 4096, 2, 4), (3, 5000, 3, 37))
MATERN_MEAN_MAIN = MATERN_MEAN_CASES[0]
MATERN_MEAN_TIMED = ((8, 32, 2, 519), (8, 4096, 2, 4), (3, 5000, 3, 37))
# The mean kernel's time at the main path's shape in its design before the
# output tiles and register levels (one block a row; PERF.md §6 row 3),
# printed beside this run's.
MATERN_MEAN_SINGLE_TILE_MS = 0.00382
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
# Planted faults: each is one textual edit of a source of the port, a
# kernel in csrc/ (built into its own library under build/planted/) or the
# graph module graphs.py (loaded from an edited copy there); the checks of
# that source (flash_checks, swe_step_checks, matern_checks, graph_checks)
# must reject every one.
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
    # The posterior-mean kernel's register levels drop the last term of each
    # slot (m = 2^levels - 1): a fault of the trees over the shared-memory
    # budget only.
    "mean_register_level_last_term_dropped": (
        "matern.cu",
        "for (int r = 0; r < count; ++r) {",
        "for (int r = 0; r < count - 1; ++r) {",
    ),
    # A graph call replays without copying the caller's tensors into the
    # static inputs: every call after the capture answers the capture's input.
    "graph_input_copy_dropped": (
        "graphs.py",
        "for dst, src in zip(self.inputs, inputs):\n            dst.copy_(src)\n",
        "for dst, src in zip(self.inputs, inputs):\n            pass\n",
    ),
    # A graph call returns the static outputs themselves: the next replay
    # overwrites a result the caller still holds.
    "graph_outputs_not_cloned": (
        "graphs.py",
        "return tree_unflatten([x.clone() for x in self._outputs], self._spec)",
        "return tree_unflatten(list(self._outputs), self._spec)",
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


def fault_source(source: str) -> Path:
    """The file a planted fault edits: a kernel source under csrc/, or a
    module of the port's package."""
    pkg = SRC / "repro_torch"
    return pkg / "csrc" / source if source.endswith(".cu") else pkg / source


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mean_bound_ms(B: int, n: int, d: int, p: int):
    """The posterior mean's bound: each input read once (x, ls, xs, alpha,
    y_scale, y_mean), the output written once; a Matérn element (3d + 15
    operations) per (row, training point), a product and an add per output
    of it, and the affine step."""
    return bound_ms((B * d + d + n * d + n * p + 2 * p + B * p) * 4,
                    B * n * (3 * d + 15 + 2 * p) + 2 * B * p)


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
    for (B, n, d, p) in MATERN_MEAN_CASES:
        x, ls, xs, alpha, ys, ym = _mean_inputs(torch, gen, B, n, d, p)
        qt, levels = matern_ops.mean_plan(n, p)
        label = f"matern52_mean ({B},{d})x({n},{d}) p={p} (tiles of {qt}, {levels} register levels)"
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


def _solve_leaves(result):
    series, final = result
    return [series, *final]


def unequal(xs, ys) -> int:
    """Unequal values between two lists of tensors of equal shapes."""
    return sum(int((x != y).sum()) for x, y in zip(xs, ys))


def graph_checks(torch, sc):
    """The graph cache of the batched solver of scenario ``sc`` (whichever
    ``StaticGraph`` ``repro_torch.swe.solver`` holds) against its eager
    solve, as ``(label, measure, error, limit)``.

    Two calls at B = 3 (padded to 4) with different displacements, then
    the eager solve of each: the first result must be unchanged by the
    second call (no result aliases a static buffer), the second must be
    the second input's (the input was copied in), and the caller's tensors
    must be unchanged.  Series and final state, bit for bit."""
    from repro_torch.swe.solver import make_solver

    solver = make_solver(sc.cfg, sc.bathymetry(), sc.probe_indices(), batch=True)
    gen = torch.Generator().manual_seed(6)
    thetas = (torch.rand((2, 3, 2), generator=gen) * 400.0 - 200.0).to(sc.torch_device)
    etas = [torch.stack([sc.displacement(t) for t in th]) for th in thetas]
    kept = [e.clone() for e in etas]
    first = _solve_leaves(solver(etas[0]))
    second = _solve_leaves(solver(etas[1]))
    want = [_solve_leaves(solver.eager(e)) for e in etas]
    label = f"graph cache {sc.ny}x{sc.nx} B=3"
    return [
        (f"{label}: first result after a second call vs eager", "unequal values",
         unequal(first, want[0]), 1),
        (f"{label}: second result vs eager", "unequal values", unequal(second, want[1]), 1),
        (f"{label}: caller's inputs after both calls", "unequal values", unequal(etas, kept), 1),
    ]


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


# The host's kernel-launch calls as the profiler records them (the CUDA
# runtime's entry points and their `cu*` counterparts).
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def profiled_events(torch, fn):
    """``torch.profiler``'s events of one call of ``fn`` (after one call
    outside the window), host and device."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


def device_ops_of(torch, fn):
    """The names of what one call of ``fn`` runs on the card (kernels,
    copies and memsets), from ``torch.profiler``."""
    return [e.name for e in profiled_events(torch, fn)
            if e.device_type == torch.autograd.DeviceType.CUDA]


def kernel_launches_of(torch, fn):
    """The kernel launches one call of ``fn`` issues, counted from the
    host's launch calls under ``torch.profiler``, and the names of the
    kernels the profiler recorded on the card.  The host records are the
    count; the device records are printed beside them but are no count:
    late in a run the profiler can record no device activity for a window
    whose only kernel is the posterior-mean kernel (the single-tile design
    as well; idle margins around the window did not bring it back), while
    it records the launch call.  The cause is not known."""
    events = profiled_events(torch, fn)
    launches = sum(e.name in LAUNCH_CALLS for e in events)
    names = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    return launches, names


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
    mb, mn, md, mp = MATERN_MEAN_MAIN
    mean_in = _mean_inputs(torch, gen, mb, mn, md, mp)
    mean_ms = device_time_ms(torch, lambda: matern_ops.matern52_mean(*mean_in, 1.3), 400)
    mean_plain_ms = device_time_ms(torch, lambda: matern52_mean_ref(*mean_in, 1.3), 20)
    m_bound = mean_bound_ms(*MATERN_MEAN_MAIN)
    # The other posterior-mean shapes (tiles, register levels): kernel and
    # plain time beside the bound, and the plan.
    mean_shapes = []
    for case in MATERN_MEAN_TIMED:
        args = _mean_inputs(torch, gen, *case)
        qt, levels = matern_ops.mean_plan(case[1], case[3])
        bound = mean_bound_ms(*case)
        mean_shapes.append(dict(
            shape="({0}, {2}) x ({1}, {2}) fp32, p = {3}".format(*case),
            tile=qt, register_levels=levels,
            ms=device_time_ms(torch, lambda: matern_ops.matern52_mean(*args, 1.3), 200),
            plain_ms=device_time_ms(torch, lambda: matern52_mean_ref(*args, 1.3), 5, warmup=1),
            bound_ms=bound[0], bound_by=bound[1]))
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
          f"matern52_mean ({mb},{md})x({mn},{md}) p={mp} {mean_ms:.4f} ms (plain "
          f"{mean_plain_ms:.4f}; the single-tile design {MATERN_MEAN_SINGLE_TILE_MS:.5f}); "
          + "".join(f"matern52_mean {m['shape']} {m['ms']:.4f} ms (plain {m['plain_ms']:.4f}, "
                    f"bound {m['bound_ms']:.5f} by {m['bound_by']}, tiles of {m['tile']}, "
                    f"{m['register_levels']} register levels); " for m in mean_shapes) +
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
            kernel="matern52_mean_kernel: the posterior mean, one block a query row and "
                   "output tile",
            other_mean_shapes=mean_shapes,
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
    """Build (a kernel source) or load (``graphs.py``) each of
    ``PLANTED_FAULTS`` from an edited copy of its source under
    build/planted/ and run the checks of that source on it: each fault must
    fail one, or the checks are too weak to trust."""
    from concurrent.futures import ThreadPoolExecutor

    import importlib.util

    from repro_torch.kernels import build
    from repro_torch.swe import TohokuScenario, solver

    checks_of = {
        "flash_attention.cu": lambda: flash_checks(torch)[0],
        "swe_flux.cu": lambda: swe_step_checks(
            torch, _swe_thetas(torch, torch.Generator().manual_seed(0)))[0],
        "matern.cu": lambda: matern_checks(torch)[0],
        "graphs.py": lambda: graph_checks(torch, TohokuScenario(nx=96, ny=96)),
    }
    libs, modules = {}, {}
    for name, (source, old, new) in PLANTED_FAULTS.items():
        src = fault_source(source).read_text()
        if src.count(old) != 1:
            fail(f"planted fault {name}: its edit does not match {source} exactly once")
        d = REPO / "build" / "planted" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(src.replace(old, new))
        if source.endswith(".cu"):
            libs[name] = (source, build.KernelLibrary(d / "kernels", csrc=d))
        else:
            spec = importlib.util.spec_from_file_location(f"planted_{name}", d / source)
            modules[name] = (source, importlib.util.module_from_spec(spec))
            spec.loader.exec_module(modules[name][1])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda sl: sl[1].build([Path(sl[0]).stem]), libs.values()))
    print(f"[2] built {len(libs)} planted faults in {time.perf_counter() - t0:.1f}s")
    committed_lib, committed_graph = build.LIBRARY, solver.StaticGraph
    for name, (source, planted) in {**libs, **modules}.items():
        if name in libs:
            build.LIBRARY = planted
        else:
            solver.StaticGraph = planted.StaticGraph
        try:
            checks = checks_of[source]()
        finally:
            build.LIBRARY, solver.StaticGraph = committed_lib, committed_graph
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
def host_times_in_turns(torch, fns, iters: int, warmup: int = 3):
    """``host_time_ms`` of each of ``fns`` ({label: fn}), in the turns a, b,
    b, a (two labels); the mean of the two turns of each, and every turn."""
    (a, fa), (b, fb) = fns.items()
    runs = {a: [], b: []}
    for label, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        runs[label].append(host_time_ms(torch, fn, iters, warmup))
    return {k: sum(v) / len(v) for k, v in runs.items()}, runs


def phase_graph_replay(torch, sc, thetas, level: int):
    """At one MLDA level: the batched solver's and the batched forward's
    graph replays against their eager loops, bit for bit, at B = 1, 3
    (padded to 4) and 8; their keys and nodes; the B = 8 forward's host
    wall, eager against replay."""
    from repro_torch.swe.solver import make_solver

    solver = make_solver(sc.cfg, sc.bathymetry(), sc.probe_indices(), batch=True)
    fb = sc.build_batch_forward()
    for B in (1, 3, 8):
        etas = torch.stack([sc.displacement(t) for t in thetas[:B]])
        n_series = unequal(_solve_leaves(solver(etas)), _solve_leaves(solver.eager(etas)))
        n_obs = unequal([fb(thetas[:B])], [fb.eager(thetas[:B])])
        print(f"[3] level {level} {sc.ny}x{sc.nx} B={B}: graph replay vs eager loop, unequal "
              f"values: series + final state {n_series}, observables {n_obs}")
        if n_series or n_obs:
            fail(f"level {level} B={B}: graph replay differs from the eager loop")
    for label, ex in (("solve", solver.executables), ("forward", fb.executables)):
        nodes = {key: sorted(g.launches.items()) for key, per in ex.items() for g in per.values()}
        print(f"[3] level {level} {label} graphs: keys {sorted(ex)}; the port's kernel "
              f"launches recorded per graph {nodes}")
    ops = device_ops_of(torch, lambda: fb(thetas))
    print(f"[3] level {level} B=8 forward, one call: {len(ops)} device operations under the "
          f"profiler ({sum(n.startswith('Memcpy') for n in ops)} copies, "
          f"{sum(n.startswith('Memset') for n in ops)} memsets)"
          if ops else f"[3] level {level} B=8 forward: device operations not measured "
          "(the profiler saw none)")
    walls, runs = host_times_in_turns(
        torch, {"eager": lambda: fb.eager(thetas), "replay": lambda: fb(thetas)}, 5)
    print(f"[3] level {level} B=8 forward wall (host clock, ending in synchronize, mean of "
          f"2 x 5 calls in turns): eager {walls['eager']:.3f} ms, replay "
          f"{walls['replay']:.3f} ms; runs "
          + ", ".join(f"{k} " + "/".join(f"{x:.3f}" for x in v) for k, v in runs.items()))
    return walls


def single_and_series_checks(torch, sc, thetas, level: int):
    """The single solves' graph replays (``build_forward`` at every level,
    ``build_series_forward`` at the coarse one) against their eager loops,
    bit for bit, and the fine single forward's wall eager against replay;
    at the coarse level the batched series forward (the Fig. 6 GP's
    design solves): replay against its eager loop at B = 1, 3 (padded to 4)
    and 8, B = 1 rows against B = 8 rows, and against the single series
    forward within the observables' bound."""
    f1 = sc.build_forward()
    singles = [("single forward", f1)]
    if level == 1:
        singles.append(("single series", sc.build_series_forward()))
    for label, fn in singles:
        n = sum(unequal([fn(t)], [fn.eager(t)]) for t in thetas[:2])
        print(f"[3] level {level} {sc.ny}x{sc.nx} {label}: graph replay vs eager loop at 2 "
              f"thetas, unequal values {n}; graphs per key "
              f"{ {k: len(v) for k, v in fn.executables.items()} }")
        if n:
            fail(f"level {level} {label}: graph replay differs from the eager loop")
    if level == 2:
        walls, runs = host_times_in_turns(
            torch, {"eager": lambda: f1.eager(thetas[0]), "replay": lambda: f1(thetas[0])}, 2,
            warmup=1)
        print(f"[3] level 2 single forward wall (host clock, ending in synchronize, mean of "
              f"2 x 2 calls in turns): eager {walls['eager']:.3f} ms, replay "
              f"{walls['replay']:.3f} ms; runs "
              + ", ".join(f"{k} " + "/".join(f"{x:.3f}" for x in v) for k, v in runs.items()))
        return walls
    fb = sc.build_batch_series_forward()
    for B in (1, 3, 8):
        n = unequal([fb(thetas[:B])], [fb.eager(thetas[:B])])
        print(f"[3] level 1 {sc.ny}x{sc.nx} batched series forward B={B}: graph replay vs "
              f"eager loop, unequal values {n}")
        if n:
            fail(f"batched series forward B={B}: graph replay differs from the eager loop")
    full = fb(thetas)
    rows1 = torch.cat([fb(thetas[i : i + 1]) for i in range(8)])
    if not torch.equal(full, rows1):
        fail("batched series forward: B=1 rows differ from B=8 rows")
    single = torch.stack([singles[1][1](t) for t in thetas[:2]])
    d = float((single - full[:2]).abs().max())
    print(f"[3] level 1 batched series forward ({full.shape[1]} steps): B=1 rows == B=8 rows "
          f"bit for bit; sweep-kernel single vs fused batched max abs diff {d:.3e}; graph keys "
          f"{sorted(fb.executables)}")
    if not d < OBS_ATOL:
        fail(f"series: single vs batched differ by {d}")
    return None


def phase_batch_invariance(torch, w):
    import numpy as np

    from repro_torch.kernels.matern import ops as matern_ops
    from repro_torch.swe import TohokuScenario

    rng = np.random.default_rng(3)
    thetas = torch.as_tensor(rng.uniform(-200, 200, (8, 2)), dtype=torch.float32).cuda()
    for label, measure, err, limit in graph_checks(torch, TohokuScenario(nx=96, ny=96)):
        print(f"[3] {label}: {measure} {err} (limit {limit})")
        if not err < limit:
            fail(f"{label}: {measure} {err} >= {limit}")
    walls = {}
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
              f"first B=8 call (eager warm-up, capture, replay) {t_batch * 1e3:.1f} ms wall; "
              f"sweep-kernel single vs fused batched max abs diff {d_single:.3e}")
        if not d_single < OBS_ATOL:
            fail(f"level {level}: single vs batched observables differ by {d_single}")
        walls[level] = phase_graph_replay(torch, sc, thetas, level)
        single_walls = single_and_series_checks(torch, sc, thetas, level)
        if single_walls:
            walls["single_fine"] = single_walls
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
    # What one level-0 call launches on the card, under the profiler: the
    # host's launch calls are the count (see kernel_launches_of); a device
    # record of a second kernel fails as well.
    after, names = kernel_launches_of(torch, lambda: gp.batch_call(thetas))
    old, old_names = kernel_launches_of(torch, lambda: _predict_before(gp, thetas))
    print(f"[3] CUDA kernel launches of one batch_call at B=8 (torch.profiler, host launch "
          f"calls): {after}; recorded on the card: {len(names)} "
          f"({', '.join(sorted(set(names)))}); before the mean kernel (matrix kernel + PyTorch "
          f"contraction): {old} launches, {len(old_names)} recorded on the card")
    if after != 1 or len(names) > 1:
        fail(f"one level-0 batch_call launched {after} CUDA kernels, want 1: {names}")
    return walls


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def phase_main_path(torch, w, rows):
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels.matern import ops as matern_ops
    from repro_torch.kernels.matern.ref import matern52_mean_ref
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
    # The posterior-mean launches by output count p (the level-0 GP's p = 4,
    # the series GP's p = coarse steps), counted by the wrapper where it
    # launches, beside the kernel's total.
    mean_by_p = matern_ops.mean_launches_by_p()
    print(f"[4] main path wall {wall:.1f}s; stage walls {res['walls']}; "
          f"kernel launches and graph replays {launches}")
    for name, counter in MLDA_KERNELS.items():
        rows[name]["launches"] = launches.get(counter, 0)
        if rows[name]["launches"] <= 0:
            fail(f"kernel {counter} was not launched by the main path")
    # Levels 1 and 2 evaluate through graph replays of their batched forwards.
    h = res["hierarchy"]
    for level, (nx, ny), fb in ((1, w.coarse_grid, h["forward_coarse_batch"]),
                                (2, w.fine_grid, h["forward_fine_batch"])):
        n = build.counter(f"graph_replays forward {ny}x{nx}").value
        graphs = {key: len(per) for key, per in sorted(fb.executables.items())}
        print(f"[4] level {level} {nx}x{ny}: graph_replays {n}; graphs captured per key "
              f"(one per calling thread) {graphs}, {sum(graphs.values())} in all")
        if n <= 0:
            fail(f"level {level}: the main path replayed no graph of its batched forward")
    fused = build.counter("swe_fused_step")
    print(f"[4] swe_fused_step launches {fused.value}: {fused.replayed} from graph replays, "
          f"{fused.value - fused.replayed} eager (the warm-up run before each capture)")
    rows["swe_fused_step"]["launches_from_replays"] = fused.replayed
    if not fused.replayed > fused.value / 2:
        fail("most fused-step launches of the main path did not come from graph replays")
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
    sampling = res["walls"]["sampling_s"]
    print(f"[4] fine samples/s {w.n_chains * N_FINE_SAMPLES / sampling:.2f}; server busy "
          f"seconds over the {sampling:.1f} s of sampling (share): "
          + ", ".join(f"{name} {busy:.2f} ({busy / sampling:.1%})"
                      for name, busy in s["per_server_uptime"].items()))
    for row in res["levels"]:
        print(f"[4] level {row['level']}: evals {row['n_evals']}, acceptance "
              f"{row['acceptance_rate']:.3f}, mean eval {row['mean_eval_s'] * 1e3:.2f} ms")
    # The main path's fine observables at the truth (sweep kernel) against
    # the plain PyTorch step on the same card.
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
    # The Fig. 6 series GP: a finite series of the coarse level's length,
    # predicted through the mean kernel at p = that length, within the
    # Matérn bound of the plain mean.
    n_series = h["forward_coarse"].n_steps
    post_series = res["posterior_series"]
    print(f"[4] series GP: {res['walls']['series_gp_s']:.2f} s (series_gp_s); posterior series "
          f"{tuple(post_series.shape)}, max SSHA {float(post_series.max()):.4f} m; "
          f"matern52_mean launches by p {dict(sorted(mean_by_p.items()))}")
    if post_series.shape != (n_series,) or not bool(torch.isfinite(post_series).all()):
        fail(f"posterior series {tuple(post_series.shape)} is not {n_series} finite values")
    if not mean_by_p.get(n_series):
        fail(f"the series GP did not launch matern52_mean at p = {n_series}")
    if sum(mean_by_p.values()) != launches["matern52_mean"]:
        fail(f"matern52_mean launches by p {mean_by_p} do not add up to its total "
             f"{launches['matern52_mean']}")
    sgp = res["series_gp"]
    theta = torch.as_tensor(np.asarray(res["posterior_mean"]), dtype=torch.float32,
                            device="cuda")[None]
    got = sgp.predict(theta)
    plain = matern52_mean_ref(theta, sgp._ls, sgp._x_scaled, sgp.alpha, sgp.y_scale,
                              sgp.y_mean, sgp._outputscale)
    # Steps before the wave reaches the probe are equal in every design
    # solve: their y_scale is the 1e-12 floor, and their bound near 0.
    bound = MATERN_ATOL * sgp.alpha.abs().sum(0) * sgp.y_scale
    diff = (got - plain).abs()
    within = bool((diff <= bound).all())
    ratio = float((diff / bound)[:, bound > 0].max())
    print(f"[4] series GP mean at the posterior mean, kernel vs plain: max err / Matérn bound "
          f"{ratio:.3e} over the steps with a bound above 0 (limit 1), every step within its "
          f"bound: {within}; equal to the run's series: {torch.equal(got[0], post_series)}")
    if not (within and ratio < 1.0) or not torch.equal(got[0], post_series):
        fail("the series GP's kernel mean is off its plain mean or the run's series")
    rows["matern52"]["series_gp_launches_p"] = {n_series: mean_by_p[n_series]}
    return res


# ---------------------------------------------------------------------------
# phase 4b: the remote leg
# ---------------------------------------------------------------------------
REMOTE_LEGS = ((True, 5, 30), (False, 2, 5))  # (binary framing, chains, fine samples)


def phase_remote(torch, w, res):
    """The card's level pools exported over loopback and sampled through
    ``make_remote_level_servers``: binary framing, then UM-Bridge JSON.

    The pools are rebuilt with ``make_level_servers`` from phase 4's GP and
    hierarchy and wrapped in a ``ServerShell`` on 127.0.0.1; each leg is a
    whole ``run(..., remote=...)`` in this process (its own hierarchy and
    series GP on the card, the evaluations across the socket).  Fails
    unless every level has a wire/service split, the fused-step and
    Matérn-mean counters move, the chains are finite, and 8 fixed thetas
    a level come back through ``RemoteBatchServer`` with the in-process
    server's fp32 bits in both protocols."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.launch.export import export_pools
    from repro_torch.launch.tsunami import run
    from repro_torch.swe import close_transports, local_level_servers, make_remote_level_servers

    h = res["hierarchy"]
    servers = local_level_servers(w, res["gp"], h)
    batched = (h["forward_coarse_batch"], h["forward_fine_batch"])

    def n_graphs() -> int:
        return sum(len(per) for fb in batched for per in fb.executables.values())

    graphs0, reserved0 = n_graphs(), torch.cuda.memory_reserved()
    inproc_rate = w.n_chains * N_FINE_SAMPLES / res["walls"]["sampling_s"]
    shell = export_pools(w, servers, n_obs=len(h["problem"].y_obs), host="127.0.0.1",
                         port=0).start()
    addr = "{}:{}".format(*shell.address)
    print(f"[4b] exported {shell.tags} on {addr} ({len(servers)} servers)")
    try:
        for binary, n_chains, n_samples in REMOTE_LEGS:
            mode = "binary" if binary else "UM-Bridge JSON"
            wr = replace(w, n_chains=n_chains, n_fine_samples=n_samples)
            build.reset_counters()
            t0 = time.perf_counter()
            r = run(wr, device="cuda", remote=(addr,), remote_binary=binary,
                    log=lambda s: print(f"[4b] {s}", flush=True))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: c.value for name, c in build.COUNTERS.items() if c.value}
            summary = r["balancer"]
            split = summary.get("wire_split") or {}
            tags = sorted(key.rsplit(":", 1)[1] for key in split)
            sampling = r["walls"]["sampling_s"]
            print(f"[4b] {mode}: {n_chains} chains x {n_samples} fine samples, wall {wall:.1f}s, "
                  f"walls {r['walls']}; fine samples/s {n_chains * n_samples / sampling:.2f} "
                  f"(in-process, phase 4: {inproc_rate:.2f}; here the wire, and one GIL "
                  f"shared with the shell); idle mean "
                  f"{summary['mean_idle_s'] * 1e3:.3f} ms p99 {summary['p99_idle_s'] * 1e3:.3f} ms; "
                  f"launches {launches}")
            for key, wsp in sorted(split.items()):
                print(f"[4b] {mode} wire_split {key}: wire EWMA {wsp['wire_ewma_s'] * 1e3:.3f} ms, "
                      f"service EWMA {wsp['service_ewma_s'] * 1e3:.3f} ms, {wsp['calls']} calls")
            if tags != ["level0", "level1", "level2"]:
                fail(f"{mode}: wire_split has levels {tags}, want level0, level1, level2")
            for name in ("swe_fused_step", "matern52_mean"):
                if not launches.get(name):
                    fail(f"{mode}: {name} did not launch during the remote leg")
            chains = np.asarray(r["chains"])
            if r["failures"] or chains.shape != (n_chains, n_samples, 2) or not np.isfinite(
                    chains).all():
                fail(f"{mode}: chains {chains.shape}, failures {r['failures']}")
        # A fixed batch of 8 thetas a level: remote rows == in-process rows.
        th8 = list(np.random.default_rng(11).uniform(-200, 200, (8, 2)).astype(np.float32))
        for binary in (True, False):
            remotes = make_remote_level_servers(w, [addr], binary=binary)
            try:
                for rs in remotes:
                    (tag,) = rs.capacity_tags
                    local = next(s for s in servers if tag in s.capacity_tags)
                    want, got = local.batch_call(th8), rs.batch_call(th8)
                    n = sum(np.asarray(g, np.float32).tobytes() != np.asarray(x, np.float32).tobytes()
                            for g, x in zip(got, want))
                    print(f"[4b] {'binary' if binary else 'JSON'} {tag}: 8 thetas through "
                          f"RemoteBatchServer vs the in-process server, unequal rows {n}")
                    if n:
                        fail(f"{tag}: remote rows differ from in-process rows")
            finally:
                close_transports(remotes)
    finally:
        shell.stop()
    print(f"[4b] graph captures the remote leg added (one per shell thread and bucket): "
          f"{n_graphs() - graphs0} ({graphs0} before, {n_graphs()} after); device memory "
          f"reserved {(torch.cuda.memory_reserved() - reserved0) / 2**20:.1f} MiB more")


# ---------------------------------------------------------------------------
# phase 4c: the device-resident ensemble and the model protocol
# ---------------------------------------------------------------------------
ENSEMBLE_CHAINS = 5  # (a) and (b): the preset's chain count, padded to 8
ENSEMBLE_BITS_STEPS = 8  # (a): top-level steps held bit for bit
ENSEMBLE_FINE_SAMPLES = 150  # (b): fine samples per chain, the preset's own
ENSEMBLE_CHUNK = 16  # (b): device_chunk, as the reference's preset
SCALING_CHAINS = (1, 4, 16, 64)  # (c)
SCALING_DEVICE_STEPS = 512
SCALING_MACHINE_STEPS = 64
GRAD_ATOL = 1e-5  # (d): TorchModel derivatives on the card vs autograd on the CPU


def _rowsum(x):
    """Sum over the last axis column by column: the same order at every B."""
    out = x[:, 0]
    for j in range(1, x.shape[1]):
        out = out + x[:, j]
    return out


def _toy_lp0(t):
    r = t - 0.3
    return -0.7 * _rowsum(r * r)


def _toy_lp1(t):
    return -0.5 * _rowsum(t * t)


def _toy_lp2(t):
    r = t - 0.1
    return -0.45 * _rowsum(r * r)


# The reference's three toy hierarchies (tests/test_device_ensemble.py).
TOY_HIERARCHIES = (((_toy_lp1,), ()), ((_toy_lp0, _toy_lp1), (3,)),
                   ((_toy_lp0, _toy_lp2, _toy_lp1), (3, 2)))


def _host_twins(torch, densities, subchains, scale, theta0, n, seed):
    """C step machines on the card: ``MLDASampler`` over the densities at
    B = 1, drawing from ``CounterStream`` on the card, proposing with
    ``DeviceMatchedRandomWalk``.  Returns (chains float32, counts)."""
    import numpy as np

    from repro_torch.core import (CounterStream, DeviceMatchedRandomWalk, MLDASampler,
                                  chain_keys)

    def host(lp):
        return lambda t: float(lp(torch.as_tensor(np.asarray(t, np.float32),
                                                  device="cuda")[None])[0])

    keys = chain_keys(seed, theta0.shape[0], "cuda")
    chains, counts = [], []
    for c in range(theta0.shape[0]):
        machine = MLDASampler([host(lp) for lp in densities],
                              DeviceMatchedRandomWalk(scale), list(subchains))
        chains.append(np.asarray(machine.sample(theta0[c], n, CounterStream(keys[c])),
                                 np.float32))
        counts.append([(r.n_accepted, r.n_proposed, r.n_evals) for r in machine.levels])
    return np.stack(chains), counts


def _fused(densities, subchains, scale, theta0, n, seed):
    from repro_torch.core import make_device_ensemble

    ens = make_device_ensemble(list(densities), list(subchains), scale, device="cuda")
    state, thetas, _ = ens.advance(ens.init(theta0, seed=seed), n)
    counts = state.counts.cpu().numpy()
    return thetas.cpu().numpy(), [[tuple(int(v) for v in counts[c, lvl])
                                   for lvl in range(counts.shape[1])]
                                  for c in range(counts.shape[0])]


def _bits_equal(torch, label, densities, subchains, scale, theta0, n, seed) -> None:
    import numpy as np

    t0 = time.perf_counter()
    dev, dev_counts = _fused(densities, subchains, scale, theta0, n, seed)
    t1 = time.perf_counter()
    ref, ref_counts = _host_twins(torch, densities, subchains, scale, theta0, n, seed)
    t2 = time.perf_counter()
    unequal_bits = int((dev.view(np.uint32) != ref.view(np.uint32)).sum())
    print(f"[4c] (a) {label}: C = {theta0.shape[0]}, {n} steps, subchains {list(subchains)}: "
          f"fused vs step machines, unequal theta bits {unequal_bits}, counts equal "
          f"{dev_counts == ref_counts} (fused {t1 - t0:.2f} s incl. capture, machines "
          f"{t2 - t1:.2f} s); chain 0 counts {dev_counts[0]}")
    if unequal_bits or dev_counts != ref_counts or not np.isfinite(dev).all():
        fail(f"(a) {label}: the fused ensemble differs from the step machines")


def phase_device_ensemble(torch, w, rows, res=None, smi: str = "") -> None:
    """Phase 4c: the device-resident ensemble at the ``paper`` preset's
    widths, and the model protocol, on the card.  Reuses phase 4's
    hierarchy and GP (``res``); builds them when run alone."""
    import numpy as np

    from repro_torch.balancer import LoadBalancer, Server
    from repro_torch.core import (BalancedGradDensity, GaussianRandomWalk, MLDASampler,
                                  TorchModel, balanced_mlda, make_device_ensemble, mala)
    from repro_torch.kernels import build
    from repro_torch.launch import quickstart
    from repro_torch.swe import build_hierarchy, device_densities, local_level_servers
    from repro_torch.swe import train_level0_gp

    t_phase = time.perf_counter()
    if res is None:
        h = build_hierarchy(w, "cuda")
        gp = train_level0_gp(h["forward_coarse_batch"], h["problem"],
                             n_train=w.gp_train_points, steps=w.gp_opt_steps)
    else:
        h, gp = res["hierarchy"], res["gp"]
    prob = h["problem"]
    lp_gp, lp_coarse = device_densities(prob, gp, h["forward_coarse_batch"])
    rng = np.random.default_rng(w.ensemble_seed)
    theta0 = (prob.sample_prior(rng, ENSEMBLE_CHAINS) * 0.5).astype(np.float32)
    print(f"[4c] card: {smi}")

    # (a) bit identity on the card: the paper's densities, then the toys.
    _bits_equal(torch, "[lp_gp, lp_coarse]", (lp_gp, lp_coarse), w.subchain_lengths[:1],
                w.rw_step_km, theta0, ENSEMBLE_BITS_STEPS, w.ensemble_seed)
    toy0 = np.linspace(-1.0, 1.0, 6, dtype=np.float32).reshape(3, 2)
    for densities, subchains in TOY_HIERARCHIES:
        _bits_equal(torch, f"toy {len(densities)}-level", densities, subchains, 0.8, toy0,
                    25, 7)

    # (b) the coupled mode: GP and coarse on the card, fine through the pools.
    servers = [s for s in local_level_servers(w, gp, h) if "level2" in s.capacity_tags]
    runner, lb = balanced_mlda(
        servers, prob.log_likelihood, prob.log_prior, GaussianRandomWalk(w.rw_step_km),
        list(w.subchain_lengths), policy=w.balancer_policy,
        batchable_levels=w.batchable_levels, ensemble_seed=w.ensemble_seed,
        device_resident=True, device_densities=[lp_gp, lp_coarse],
        device_chunk=ENSEMBLE_CHUNK, device="cuda", **w.balancer_kwargs(),
    )
    build.reset_counters()
    try:
        t0 = time.perf_counter()
        result = runner.run(theta0, ENSEMBLE_FINE_SAMPLES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        summary = lb.summary()
    finally:
        lb.shutdown()
    fused = build.counter("swe_fused_step")
    mean = build.counter("matern52_mean")
    replays = {name[len("graph_replays "):]: c.value for name, c in build.COUNTERS.items()
               if name.startswith("graph_replays ") and c.value}
    busy = sum(summary["per_server_uptime"].values())
    n_fine = ENSEMBLE_CHAINS * ENSEMBLE_FINE_SAMPLES
    totals = result.level_totals()
    print(f"[4c] (b) coupled, {ENSEMBLE_CHAINS} chains x {ENSEMBLE_FINE_SAMPLES} fine samples, "
          f"subchains {list(w.subchain_lengths)}, {len(servers)} fine BatchServers ({smi}): "
          f"wall {wall:.2f} s, fine samples/s {n_fine / wall:.2f}, device_seconds "
          f"{runner.device_seconds:.2f} s ({runner.device_seconds / wall:.1%} of the wall), "
          f"fine-pool utilization {busy / (wall * len(servers)):.1%}; balancer idle mean "
          f"{summary['mean_idle_s'] * 1e3:.3f} ms, p99 {summary['p99_idle_s'] * 1e3:.3f} ms; "
          f"batch histogram {summary['batch_histogram']}")
    for row in totals:
        print(f"[4c] (b) level {row['level']}: evals {row['n_evals']}, acceptance "
              f"{row['acceptance_rate']:.3f}")
    print(f"[4c] (b) launches: swe_fused_step {fused.value} ({fused.replayed} from graph "
          f"replays), matern52_mean {mean.value} ({mean.replayed} from graph replays); "
          f"graph replays {replays}")
    rows.setdefault("swe_fused_step", {})["launches_phase_4c"] = {
        "coupled": fused.value, "from_replays": fused.replayed}
    rows.setdefault("matern52", {})["launches_phase_4c"] = {
        "coupled": mean.value, "from_replays": mean.replayed}
    for name, c in (("swe_fused_step", fused), ("matern52_mean", mean)):
        if not c.value or not c.replayed > c.value / 2:
            fail(f"(b) {name}: {c.value} launches, {c.replayed} from replays: not mostly "
                 "from graph replays")
    chains = result.chains
    if chains.shape != (ENSEMBLE_CHAINS, ENSEMBLE_FINE_SAMPLES, 2) or not np.isfinite(
            chains).all():
        fail(f"(b) chains {chains.shape} not finite")
    for s in result.samplers:
        for r in s.levels:
            if not 0 <= r.n_accepted <= r.n_proposed:
                fail(f"(b) counts inconsistent: accepted {r.n_accepted}, proposed {r.n_proposed}")
    # One proposal's graph alone, by the host's clock ended by a sync.
    ens, state = runner.ensemble, runner.state
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ens.propose(state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    keys = sorted(ens.executables)
    print(f"[4c] (b) propose graph wall (5 replays, host clock, {smi}): "
          f"{', '.join(f'{x:.2f}' for x in walls)} ms; graphs {keys}")
    rows["swe_fused_step"]["propose_graph_wall_ms"] = float(np.median(walls))

    # (c) chain scaling: a GP-only fused ensemble against C step machines.
    def lp_host(t):
        return float(lp_gp(torch.as_tensor(np.asarray(t, np.float32), device="cuda")[None])[0])

    for n_chains in SCALING_CHAINS:
        th0 = (prob.sample_prior(rng, n_chains) * 0.5).astype(np.float32)
        ens = make_device_ensemble([lp_gp], [], w.rw_step_km, cache_key=("scaling",),
                                   device="cuda")
        state = ens.init(th0, seed=w.ensemble_seed)
        state, thetas, _ = ens.advance(state, SCALING_DEVICE_STEPS)  # capture + warm
        thetas.cpu()
        t0 = time.perf_counter()
        state, thetas, _ = ens.advance(state, SCALING_DEVICE_STEPS)
        thetas = thetas.cpu().numpy()
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for c in range(n_chains):
            machine = MLDASampler([lp_host], GaussianRandomWalk(w.rw_step_km), [])
            machine.sample(th0[c], SCALING_MACHINE_STEPS, np.random.default_rng(c))
        mach_s = time.perf_counter() - t0
        dev_rate = n_chains * SCALING_DEVICE_STEPS / dev_s
        mach_rate = n_chains * SCALING_MACHINE_STEPS / mach_s
        print(f"[4c] (c) C = {n_chains}: fused {dev_rate:.0f} chain-steps/s "
              f"({SCALING_DEVICE_STEPS} steps, {dev_s:.3f} s), step machines "
              f"{mach_rate:.0f} chain-steps/s ({SCALING_MACHINE_STEPS} steps, {mach_s:.3f} s), "
              f"ratio {dev_rate / mach_rate:.2f} ({smi})")
        if not np.isfinite(thetas).all():
            fail(f"(c) C = {n_chains}: fused chains not finite")

    # (d) the model protocol: the quickstart's two halves, then MALA through
    # separate value and gradient pools of TorchModels on the card.
    out = quickstart.main(["--device", "cuda"])
    chain, vec = out["mlda_chain"], out["vectorised"].chain.cpu().numpy()
    vec_mean = vec[:, 50:, :].reshape(-1, 2).mean(0)
    if chain.shape != (100, 2) or not np.isfinite(chain).all() or not np.isfinite(vec).all():
        fail(f"(d) quickstart chains {chain.shape}, {vec.shape} not finite")
    if not np.all(np.abs(vec_mean - quickstart.Y_OBS) < 0.2):
        fail(f"(d) vectorised quickstart mean {vec_mean} is off the posterior mean (1, -1)")
    post = TorchModel(lambda t: -0.5 * torch.sum(t * t), name="post", input_dim=2,
                      output_dim=1, device="cuda")
    lb = LoadBalancer([Server(post, name="val-0", capacity_tags=("post:value",)),
                       Server(post.gradient, name="grad-0", capacity_tags=("post:grad",))])
    try:
        dens = BalancedGradDensity(lb, "post", post, post.gradient)
        mchain, mstats = mala(dens.value, dens.grad, np.zeros(2), 200,
                              np.random.default_rng(2), eps=0.8)
        tags = {row["tag"]: row["n_done"] for row in lb.stats_table()}
        ups = lb.summary()["per_server_uptime"]
    finally:
        lb.shutdown()
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        post.gradient(np.zeros(2))
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"[4c] (d) MALA through the balancer: acceptance {mstats.acceptance_rate:.3f}, "
          f"requests by tag {tags}, busy seconds {ups}; after it, one TorchModel.gradient "
          f"on the card (host clock, ended by its sync) median {np.median(walls):.3f} ms "
          f"over 20 calls ({smi})")
    if not np.isfinite(mchain).all() or not (tags.get("post:value") and tags.get("post:grad")):
        fail("(d) MALA chain not finite, or the balancer did not see both request tags")

    def f(t):
        return torch.stack([torch.sin(t[0]) * torch.exp(t[1]), t[0] * t[1],
                            torch.exp(-t[0]) + t[1] * t[1]])

    model = TorchModel(f, name="nonlinear", input_dim=2, output_dim=3, device="cuda")
    theta = torch.tensor([0.3, -0.7])
    want_g = torch.func.grad(lambda t: torch.sum(f(t)))(theta)
    want_j = torch.func.jacrev(f)(theta)
    err_g = float((model.gradient(theta).cpu() - want_g).abs().max())
    err_j = float((model.jacobian(theta).cpu() - want_j).abs().max())
    print(f"[4c] (d) TorchModel on the card vs autograd on the CPU: gradient max abs err "
          f"{err_g:.2e}, Jacobian {err_j:.2e} (limit {GRAD_ATOL})")
    if not (err_g <= GRAD_ATOL and err_j <= GRAD_ATOL):
        fail("(d) TorchModel derivatives on the card differ from autograd on the CPU")
    through = TorchModel(lambda t: gp.predict(t[None])[0], name="gp", input_dim=2,
                         output_dim=4, device="cuda")
    try:
        through.gradient(theta)
    except RuntimeError as e:
        print(f"[4c] (d) a gradient through the Matérn kernel is refused: {e}")
    else:
        fail("(d) a gradient through the Matérn mean kernel did not raise")
    print(f"[4c] phase wall {time.perf_counter() - t_phase:.1f} s")


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
    from repro_torch.runtime.serve_loop import DecodeGraph, ServingEngine, serving_metrics

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

    # Through the graphs against the eager steps, teacher-forced on the
    # tokens the servers emitted.  Generation mode's tokens come from the
    # B = 1 graph (prefill and decode), continuous mode's from the 8-slot
    # pool graph after the B = 1 prefill graph: on the same tokens the
    # graphs' logits must equal the eager steps' bit for bit, and the
    # emitted tokens the eager argmaxes exactly.  delta_mode is the largest
    # logit difference between the eager B = 1 step and the eager 8-slot
    # step (every slot holding the request) while the two modes' tokens
    # agree.  Both run the same code on the same weights, so delta_mode
    # must stay below the control delta_first.
    g1 = DecodeGraph(bundle, params, 1, SERVE_CACHE_LEN, name="check B=1")
    g8 = DecodeGraph(bundle, params, SERVE_SLOTS, SERVE_CACHE_LEN, name=f"check B={SERVE_SLOTS}")
    delta_mode, ref_logits = 0.0, []
    graph_unequal, graph_diff, n_logits = 0, 0.0, 0
    mismatch = {"generation": [], "continuous": []}

    def versus(eager, graph):
        nonlocal graph_unequal, graph_diff, n_logits
        graph_unequal += unequal([graph], [eager])
        graph_diff = max(graph_diff, float((graph - eager).abs().max()))
        n_logits += eager.numel()

    for i, ((p, _), g, c) in enumerate(zip(work, tokens["generation"], tokens["continuous"])):
        prompt = torch.as_tensor(p).cuda()
        ls, st1 = bundle.prefill_state(params, prompt, SERVE_CACHE_LEN)
        ids, lg = g1.prefill(prompt)
        versus(ls, lg)
        for mode, toks in (("generation", g), ("continuous", c)):
            if int(toks[0]) != int(ls[0, -1].argmax()):
                mismatch[mode].append((i, 0, ls[0, -1]))
        pool = pool_decode_state(cfg, SERVE_SLOTS, SERVE_CACHE_LEN, "cuda")
        g8.reset()
        for slot in range(SERVE_SLOTS):
            pool = slot_insert(pool, st1, slot)
            slot_insert(g8.state, st1, slot)
        steps = []
        for j in range(1, max(len(g), len(c))):
            if j < len(g):
                feed = torch.full((1, 1), int(g[j - 1]), device="cuda")
                l1, st1 = decode_step(params, cfg, st1, feed)
                versus(l1, g1(feed)[1])
                steps.append(l1[0, -1])
                if int(l1[0, -1].argmax()) != int(g[j]):
                    mismatch["generation"].append((i, j, l1[0, -1]))
            if j < len(c):
                feed = torch.full((SERVE_SLOTS, 1), int(c[j - 1]), device="cuda")
                l8, pool = decode_step(params, cfg, pool, feed)
                versus(l8, g8(feed)[1])
                if int(l8[0, -1].argmax()) != int(c[j]):
                    mismatch["continuous"].append((i, j, l8[0, -1]))
                if j < len(g) and np.array_equal(g[:j], c[:j]):
                    delta_mode = max(delta_mode, float((l1[0, -1] - l8[0, -1]).abs().max()))
        ref_logits.append(steps)
    print(f"[6] graphs vs eager steps, teacher-forced on the served tokens: {graph_unequal} of "
          f"{n_logits} logits unequal (max abs diff {graph_diff:.4e}); served tokens unlike the "
          "eager argmax: " + ", ".join(f"{m} {len(v)}" for m, v in mismatch.items()))
    if graph_unequal:
        # cuBLAS under capture changed bits: hold the graphs to the delta rule.
        print(f"[6] cuBLAS under capture changed bits: the graphs' logits are held to "
              f"delta_first {delta_first:.4e}, their tokens to the top-2 rule")
        if not graph_diff <= delta_first:
            fail(f"graph logits differ from the eager steps' by {graph_diff} > {delta_first}")
        for mode, rows_ in mismatch.items():
            for i, j, logits in rows_:
                gap = _top2_gap(torch, logits)
                if not gap < 2 * delta_first:
                    fail(f"{mode} request {i} token {j} differs from the eager argmax at top-2 "
                         f"gap {gap} >= 2 delta")
    elif any(mismatch.values()):
        fail("tokens through the graphs differ from the eager tokens at (request, token) "
             + "; ".join(f"{m} {[(i, j) for i, j, _ in v]}" for m, v in mismatch.items()))
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
          f"{len(work)} first tokens differ from the kernel prefill's, each at a near tie; "
          f"delta (B=1 vs {SERVE_SLOTS}-slot decode, teacher-forced) {delta_mode:.4e}: {n_mode} "
          f"of {len(work)} requests diverge between modes, each at a near tie")

    # A decode step eager against one replay, at B = 1 and B = 8, by the
    # host's clock in turns; then where the time goes, eager and replayed:
    # host ops issued against kernel time on the card, over a short
    # profiler window.
    prompt = torch.as_tensor(work[0][0]).cuda()
    states = {1: bundle.prefill_state(params, prompt, SERVE_CACHE_LEN)[1]}
    states[SERVE_SLOTS] = pool_decode_state(cfg, SERVE_SLOTS, SERVE_CACHE_LEN, "cuda")
    graphs = {1: g1, SERVE_SLOTS: g8}
    for slot in range(SERVE_SLOTS):
        slot_insert(states[SERVE_SLOTS], states[1], slot)
    g1.prefill(prompt)
    for B, graph in graphs.items():
        feed = torch.zeros((B, 1), dtype=torch.int64, device="cuda")

        def eager(B=B, feed=feed):
            states[B] = decode_step(params, cfg, states[B], feed)[1]

        step_ms, runs = host_times_in_turns(
            torch, {"eager": eager, "replay": partial(graph, feed)}, 10)
        print(f"[6] decode step B={B} (host clock, ending in synchronize, mean of 2 x 10 in "
              f"turns): eager {step_ms['eager']:.3f} ms, replay {step_ms['replay']:.3f} ms; "
              "runs " + ", ".join(f"{k} " + "/".join(f"{x:.3f}" for x in v)
                                   for k, v in runs.items()))
    from torch.profiler import ProfilerActivity, profile

    feed = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    for label, fn in (("eager", lambda: decode_step(params, cfg, states[1], feed)),
                      ("replay", lambda: g1(feed))):
        n_steps = 5
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.events()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        ops = [e for e in events if e.name.startswith("aten::")
               and e.device_type != torch.autograd.DeviceType.CUDA
               and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_steps
        wall_ms = wall * 1e3 / n_steps
        if kernels:
            print(f"[6] decode step B=1 {label} (profiler, {n_steps} steps): {wall_ms:.3f} ms "
                  f"wall, {len(ops) / n_steps:.0f} top-level host ops and "
                  f"{len(kernels) / n_steps:.0f} device operations per step, device time "
                  f"{busy_ms:.3f} ms: device busy {busy_ms / wall_ms:.1%}, idle "
                  f"{1 - busy_ms / wall_ms:.1%}")
            by_name = Counter()
            for e in kernels:
                by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n_steps
            print(f"[6] decode step B=1 {label}, device time by operation (ms a step, share): "
                  + "; ".join(f"{name[:90]} {t:.3f} ({t / busy_ms:.1%})"
                              for name, t in by_name.most_common(5)))
        else:
            print(f"[6] decode step B=1 {label}: {wall_ms:.3f} ms wall under the profiler, "
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
    phase_walls = {}

    def ended(phase: str) -> None:
        phase_walls[phase] = round(time.perf_counter() - t_start - sum(phase_walls.values()), 1)

    phase_build()
    ended("1 build")
    rows: dict = {}
    phase_kernels(torch, rows)
    ended("2 kernels")
    phase_flash(torch, rows)
    ended("2 flash")
    phase_planted_faults(torch)
    ended("2 planted faults")
    walls = phase_batch_invariance(torch, PAPER)
    ended("3 batch invariance")
    rows["swe_fused_step"].update({
        f"forward_b8_wall_ms_{kind}_level{level}": walls[level][kind]
        for level in (1, 2) for kind in ("eager", "replay")})
    rows["swe_sweep"].update({
        f"single_fine_forward_wall_ms_{kind}": walls["single_fine"][kind]
        for kind in ("eager", "replay")})
    res = phase_main_path(torch, PAPER, rows)
    ended("4 main path")
    phase_remote(torch, PAPER, res)
    ended("4b remote leg")
    phase_device_ensemble(torch, PAPER, rows, res, smi)
    ended("4c device ensemble")
    del res
    phase_lm(torch, rows)
    ended("5-6 LM")
    print(f"[7] all phases passed in {time.perf_counter() - t_start:.1f}s; seconds by phase "
          f"{phase_walls}")
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
