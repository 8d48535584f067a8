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
   attention over the reference's six test cases and four more (a ragged
   non-causal length, head dim 192 causal, windowed and ragged
   non-causal) in fp32 (the CUDA-core route) and in bf16 (the tensor-core route),
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
   samples/s, fine-pool utilization, the balancer's idle
   times, both kernels' launches (mostly from graph replays) and the
   propose graph's wall; (c) chain scaling, a GP-only fused ensemble at C =
   1, 4, 16, 64 (512 steps) against C step machines (64 steps); (d) the
   model protocol: the quickstart's two halves (``launch.quickstart``),
   MALA through separate value and gradient pools of TorchModels, their
   gradient and Jacobian against autograd on the CPU, and a gradient
   through the Matérn kernel refused;
4d. sharded level pools and a chain restart through disk, on phase 4's
   hierarchy and GP: (a) ``ShardedBatchServer`` pools at levels 0-2 over a
   one-entry mesh and a two-entry mesh of this card (two shards, two graph
   caches, two streams) against each level's ``BatchServer``, bit for bit
   at B = 1, 3, 8, with the per-shard graph keys, and a B = 8 fine
   evaluation timed three ways; (b) ``balanced_mlda`` through the
   one-entry pools, 3 chains x 40 fine samples, clean and then with
   ``checkpoint_dir``, ``max_restarts=1``, ``checkpoint_every=10`` and one
   NaN fine result (the fine pool checks finiteness) after about 20 fine
   evaluations a chain: one chain restarts once from its ``chain_<c>.npz``,
   its samples up to that snapshot and the other chains equal the clean
   run bit for bit; the snapshot writes, bytes on disk and the restore are
   timed; counters at 0 before (a), and the fused-step and mean kernels
   must launch, mostly from graph replays;
5. the LM slice's prefill: qwen2-0.5b at full width in bf16 (seeded random
   weights) on one 32768-token prompt, the head on the last position only,
   counters at 0 just before; the
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
   largest device operations of a B = 1 step, eager and replayed; the peak
   memory of one B = 8 step over a 32,768-position cache is printed;
6b. the paged and speculative modes on phase 6's work and weights (8
   slots, 16-position blocks, 64 blocks, 16-position prefill chunks;
   ``spec_k`` 4 with a 12-layer draft): (a) speculative tokens must equal
   generation's exactly, and paged tokens may differ from them only where
   the eager B = 1 top-2 gap is below twice phase 6's larger control
   difference; (b) a ``PagedGraphs`` of the pool's shapes must equal the
   eager ``paged_prefill_chunk`` and ``paged_decode_step`` on a copy of
   its state bit for bit (ids, logits, positions, block pool), also after
   a slot moved onto other block rows after the captures, and the eager
   chunked prefill's first-token logits must lie within twice delta_first
   of the serving prefill's; (c) block occupancy must lie in (0, 1] and
   the speculative server must report rounds and drafts; (d) the four
   modes' tokens/s, TTFT and per-token latency, the ratios beside the
   reference's gates, the chunk graphs' captures and graph memory, and a
   paged step eager against replay and under the profiler, printed and not
   gated;
6c. the MoE, SSM and hybrid families at full width in bf16 (seeded random
   weights drawn on the card), granite-moe-3b-a800m, mamba2-1.3b and
   zamba2-1.2b one after another, each freed before the next: (a) the
   parameter count within the reference's bounds; (b) granite's and
   zamba2's prefill_32k prompt at batch 1, the main path's launch of the
   flash kernel (counters at 0 just before: the tensor-core kernel
   launches 32 and 6 times, the fp32 route never), the path's first
   flash call held against plain blocked attention on its own inputs, and
   phase 5's whole-model rule on a depth cut (2 and 6 blocks); (c) mamba2's chunked prefill against the recurrence
   on 8 prompts of 256 tokens (argmaxes by the top-2 rule, delta the
   chunk-128 vs chunk-64 difference), and both in fp32 on a two-block cut
   within 1e-3; (d) mamba2's prefill_32k prompt: no flash launch; (e)
   every serving mode the family has on phase 6's kind of work (zamba2's
   paged mode must be refused): speculative (plain greedy for mamba2 and
   zamba2) equals generation exactly, continuous and paged follow
   generation by the top-2 rule, the median top-2 gap printed beside 2
   delta (granite's paged tokens at its capacity factor are counted, not
   held: its 16-position chunks drop pairs that token-by-token generation
   keeps; its paged mode is served again at a factor where none drops, and
   held); the same rule again in fp32 on a depth cut of each family, where
   it has teeth (2 delta must lie below the median top-2 gap); the B = 1
   and B = 8 graphs equal the eager steps bit for bit (logits, and the
   recurrent state after), a ``PagedGraphs`` equals the eager paged
   functions bit for bit (granite's at both capacity factors), and decode
   steps at B = 1 and 8 are timed eager against replay; (f) first, the
   reduced granite's paged decode step at 32 slots as one captured graph:
   three replays, each equal to the eager step on a copy of the state bit
   for bit, each MoE counter grown by three times the graph's captured
   tally, every MoE call pooled (in the eager steps, 1 group of 32 tokens
   at capacity 32 a layer, no pair dropped);
6d. the last families in bf16 (seeded weights drawn on the card), one
   after another, each freed before the next: (a) the four full configs'
   parameter counts from their shapes, within the reference's bounds;
   (b) llava-next-mistral-7b at full depth: the prefill_32k prompt of
   2,880 seeded patches and 29,888 tokens (32 tensor-core launches at
   D = 128), the path's flash call held against the plain version on its
   inputs, phase 5's rule on a two-block cut, the patches moving the
   logits, and 6c's serving checks (all four modes, graphs bit for bit,
   the fp32 token cut); (c) mixtral-8x22b on four blocks: the prompt
   through the windowed kernel (window 4096), its call held, paged
   refused where the window is below the cache, the rolling cache against
   forward in fp32 on one block (window 16 under a 48-token prompt), and
   the serving checks at cache_len 128 (paged held at capacity factor 8);
   (d) nemotron-4-340b on two blocks: the prompt through the D = 192
   kernel, its call held, the serving checks, and a decode step's peak
   memory (no fp32 head copy); (e) whisper-large-v3 at full width: the
   encoder on 1,500 seeded frames (32 non-causal launches at a ragged
   length) and the decoder on the 32k prompt (32 causal launches,
   cross-attention plain), each call held, teacher-forced decode steps
   against ``decode_train`` (fp32 on a 2 + 2 layer cut within 2e-3; bf16
   by phase 5's rule), and the serving engine's refusal; each held call
   is timed beside SDPA's time at its shape and its bound (a windowed
   call: SDPA with the band as an explicit additive mask);
7. training, no kernel launched (the path takes the plain blocked
   attention, as the reference's training does): (a) smollm-360m at full
   width in bf16 through ``launch.train``'s trainer, one CUDA graph a step
   over donated state (``GraphTrainStep``: 1 capture, 29 replays), 30
   steps of seq 256 x batch 8 on the Markov pipeline (bf16 moments, no
   master copy, the launcher's warmup): every loss and grad norm finite,
   the mean loss of steps 26-30 at least ``LOSS_DROP`` below that of steps
   1-5; the step time (CUDA events, median of the last 20), tokens/s and
   the peak memory above the start, then the same for the functional
   (eager) step on a copy of the state, and the profiled device operations
   and busy share of one replayed and one eager step; (b) on a two-block
   cut, 6 steps straight against 3 + save (bf16 leaves) + restore into a
   fresh trainer + 3 through the launcher's ``run`` (graph trainers),
   parameters and optimizer state bit for bit under
   ``torch.use_deterministic_algorithms(True)``; (c) the cut in fp32: the
   card's loss and gradients against the CPU's on the same params and
   batch, microbatches 2 against 1, remat on against off bit for bit, and
   the head's product through ``matmul_f32`` in bf16 and its gradients
   against the fp32 upcast; (d) int8 error-feedback compression on a
   two-entry mesh of the card, the reference test's three bounds; (e) one
   loss and gradient in bf16 of every other family on 6c/6d's depth cuts:
   loss finite, every gradient leaf finite and not all zero; (f) a loss
   through ``attn_impl="kernel"`` under autograd raises the kernel's
   refusal; (g) under deterministic algorithms, 6 steps through the graph
   trainer against 6 functional eager steps from the same state, at full
   width, on the two-block cut with microbatches 2, and on two-block cuts
   of granite-moe-3b-a800m and mamba2-1.3b: 0 unequal values in params,
   m, v, step, loss, lr and grad norm;
8. the sharded steps on a (1, 1) ``DeviceMesh`` of the card (an NCCL group
   of one rank on a local store, set up and torn down at the phase's
   edges): (a) smollm-360m at phase 7's shape through ``shard_train_step``
   under the pure-DP and the TP policy, 2 steps each: loss, grad norm,
   parameters and AdamW state bit for bit against the functional (eager)
   unsharded step under deterministic algorithms, and the step times
   (DTensor's host cost over that step); (a') the same steps as one CUDA
   graph over the donated DTensor state under each policy (the pure-DP one
   through the launcher's ``make_sharded_trainer``), 1 capture and 3
   replays: metrics, parameters, m, v and step bit for bit against (a) and
   the unsharded step, the leaves never moved; then 6 replays back to back
   for the replayed step time beside (a)'s and phase 7a's replay, and one
   replay profiled (busy share, NCCL operations);
   (b) qwen2-0.5b's ``shard_prefill_step`` at prefill_32k (batch cut to 1):
   logits bit for bit, the flash kernel launched once a layer through
   ``local_map``; (b') the same prefill as one CUDA graph: a replay's
   logits bit for bit, one flash launch a layer a replay; (c)
   ``shard_decode_step`` at decode_32k (batch cut to 8), 8 steps: logits
   and state bit for bit; (c') the same 8 steps as one CUDA graph over the
   donated state (1 capture, 7 replays), held the same way, the step time
   beside (c)'s and the unsharded B = 8 decode graph's; (g) the clip's
   all-reduce captured on the one-rank NCCL group, replay == eager; (d) the
   dry-run of qwen2-0.5b's
   train_4k and decode_32k on 256 fake ranks, each in a subprocess started
   at the phase's start: status ok, the roofline terms, the collective
   census, the peak, ``trace_s``, the whole-head re-layouts; (e) the
   estimates of smollm-360m's step on one fake rank against phase 7a's
   peak memory and against 8 N T flops, within ``MEM_ESTIMATE_BOUNDS`` /
   ``FLOP_ESTIMATE_BOUNDS``; (f) a DTensor and a FakeTensor handed to each
   kernel wrapper raise the refusal of tensor subclasses;
9. print the ``kernels`` JSON line, then the result line.
"""
from __future__ import annotations

import json
import math
import os
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
    # The paths of the last LM families: a ragged non-causal length (the
    # whisper encoder's tails in both tiles), and nemotron's head dim 192,
    # causal, windowed and ragged non-causal.
    (1, 4, 4, 300, 64, False, None),
    (1, 4, 2, 256, 192, True, None),
    (1, 4, 2, 384, 192, True, 128),
    (1, 2, 2, 300, 192, False, None),
]
# The LM slice: qwen2-0.5b at full width; the prefill_32k shape with its
# global batch cut from 32 to 1 (the two plain blocked prefills that phase 5
# holds the kernel path against take 10-16 s each at batch 1 on an H100);
# serving as launch/serve.py draws its requests.
LM_ARCH = "qwen2-0.5b"
FLASH_PLAIN_LEN = 4096  # the longest prompt the materialising plain version fits
SERVE_REQUESTS = 16
SERVE_PROMPT_LEN = 32
SERVE_CACHE_LEN = 128
SERVE_SLOTS = 8
# The decode step's memory is read at a long cache too (the repaired fp32
# copies grew with the cache and the vocabulary).
LONG_CACHE_LEN = 32768
# 6b: the paged pool (n_blocks at its default, SERVE_SLOTS x 8) and the
# speculative mode (its draft is the bottom half of the layers).
PAGED_BLOCK_SIZE = 16
PAGED_CHUNK = 16
SPEC_K = 4
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
    f_bound = bound_ms((2 * h + 2 * hkv) * s_long * d * 2,
                       4 * h * d * visible_pairs(s_long, True, None), PEAK_BF16_FLOPS)
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
          f"wall {wall:.2f} s, fine samples/s {n_fine / wall:.2f}, "
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
# phase 4d: sharded level pools, and a chain restart through disk
# ---------------------------------------------------------------------------
SHARD_BATCHES = (1, 3, 8)  # (a): rows held bit for bit against BatchServer
SHARD_TIMED_CALLS = 20  # (a): B = 8 fine evaluations a way, in turns
RESTART_CHAINS = 3  # (b)
RESTART_FINE_SAMPLES = 40
RESTART_EVERY = 10  # checkpoint_every
RESTART_FAULT_AFTER = 20  # fine evaluations a chain before the one NaN


def sharded_pool_checks(torch, w, h, gp, smi: str):
    """(a): ``ShardedBatchServer`` pools at levels 0-2 over the one-entry and
    the two-entry mesh of this card against the level's ``BatchServer``,
    bit for bit at B = 1, 3, 8, with the per-shard graph keys; then a B = 8
    fine evaluation timed three ways.  Returns the one-entry pools."""
    import numpy as np

    from repro_torch.runtime.sharding import DataMesh, data_mesh, data_policy
    from repro_torch.swe import local_level_servers

    plain = local_level_servers(w, gp, h)
    by_tag = {t: next(s for s in plain if t in s.capacity_tags)
              for t in ("level0", "level1", "level2")}
    thetas = list(np.random.default_rng(13).uniform(-200, 200, (8, 2)).astype(np.float32))
    pools = {}
    meshes = {"1-entry": data_mesh(1), "2-entry": DataMesh(["cuda:0", "cuda:0"])}
    for label, mesh in meshes.items():
        pools[label] = local_level_servers(w, gp, h, policy=data_policy(mesh))
        n_pos = len(mesh.devices)
        for pool in pools[label]:
            (tag,) = pool.capacity_tags
            for B in SHARD_BATCHES:
                got, want = pool.batch_call(thetas[:B]), by_tag[tag].batch_call(thetas[:B])
                n = sum(np.asarray(g).tobytes() != np.asarray(x).tobytes()
                        for g, x in zip(got, want))
                if n:
                    fail(f"(a) {label} {pool.name} B={B}: {n} rows differ from BatchServer")
            keys = sorted(pool.executables)
            # B_pad rows split over the positions where they divide, else one
            # unsharded call at position 0.
            want_keys = sorted({(pos, b // (n_pos if b % n_pos == 0 else 1))
                                for b in (1, 4, 8)
                                for pos in range(n_pos if b % n_pos == 0 else 1)})
            print(f"[4d] (a) {label} mesh {pool.name}: rows == {by_tag[tag].name}'s bit for "
                  f"bit at B = {SHARD_BATCHES}; graph keys (mesh position, shard rows) {keys}")
            if keys != want_keys:
                fail(f"(a) {label} {pool.name}: graph keys {keys}, want {want_keys}")
    fine = {"BatchServer": by_tag["level2"],
            **{f"{label} mesh": next(s for s in ps if "level2" in s.capacity_tags)
               for label, ps in pools.items()}}
    th8 = thetas[:8]
    walls = {k: [] for k in fine}
    for s in fine.values():
        s.batch_call(th8)
    for _ in range(SHARD_TIMED_CALLS):
        for k, s in fine.items():  # in turns: drift falls on every way alike
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.batch_call(th8)
            walls[k].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"[4d] (a) B=8 fine evaluation, host clock, median of {SHARD_TIMED_CALLS} in turns "
          f"({smi}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
          + f"; 1-entry / BatchServer {med['1-entry mesh'] / med['BatchServer']:.3f}, "
          f"2-entry / 1-entry {med['2-entry mesh'] / med['1-entry mesh']:.3f}")
    return pools["1-entry"], med


def _timed(calls: list, fn):
    """``fn`` that appends ``(ms, result)`` of each call to ``calls``."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        calls.append(((time.perf_counter() - t0) * 1e3, out))
        return out

    return wrapper


def restart_checks(torch, w, h, pools, smi: str):
    """(b): ``balanced_mlda`` through the one-entry sharded pools, clean, then
    with ``checkpoint_dir``, ``max_restarts=1`` and one NaN fine result on
    the ``check_finite`` fine pool after about ``RESTART_FAULT_AFTER`` fine
    evaluations a chain: the chain restarts from its ``chain_<c>.npz``."""
    import os
    import tempfile

    import numpy as np

    import repro_torch.checkpoint as ckpt
    from repro_torch.core import GaussianRandomWalk, balanced_mlda

    prob = h["problem"]
    fine_pool = next(s for s in pools if "level2" in s.capacity_tags)
    fine_pool.check_finite = True
    run_fn = fine_pool.batch_fn
    fault = {"members": 0, "hit": None}

    def faulty(stacked):
        out = run_fn(stacked)
        fault["members"] += len(stacked)
        if fault["hit"] is None and fault["members"] > RESTART_FAULT_AFTER * RESTART_CHAINS:
            out = np.array(out, copy=True)
            out[0] = np.nan
            fault["hit"] = fault["members"]
        return out

    def sample(checkpoint_dir):
        runner, lb = balanced_mlda(
            pools, prob.log_likelihood, prob.log_prior, GaussianRandomWalk(w.rw_step_km),
            list(w.subchain_lengths), batchable_levels=w.batchable_levels,
            n_chains=RESTART_CHAINS, ensemble_seed=w.ensemble_seed, as_runner=True,
            max_restarts=1, checkpoint_every=RESTART_EVERY, checkpoint_dir=checkpoint_dir,
            **w.balancer_kwargs(),
        )
        try:
            t0 = time.perf_counter()
            out = runner.run(lambda c, rng: prob.sample_prior(rng)[0] * 0.5,
                             RESTART_FINE_SAMPLES)
            return out, time.perf_counter() - t0
        finally:
            lb.shutdown()

    clean, clean_wall = sample(None)
    saves, loads = [], []
    save, restore = ckpt.save, ckpt.restore
    ckpt.save, ckpt.restore = _timed(saves, save), _timed(loads, restore)
    fine_pool.batch_fn = faulty
    try:
        with tempfile.TemporaryDirectory() as d:
            res, wall = sample(d)
            files = sorted(os.listdir(d))
            n_bytes = sum(os.path.getsize(os.path.join(d, f)) for f in files)
    finally:
        ckpt.save, ckpt.restore, fine_pool.batch_fn = save, restore, run_fn
    writes = [ms for ms, _ in saves]
    restores = [ms for ms, _ in loads]
    read_steps = [out[1] for _, out in loads]
    n = RESTART_CHAINS * RESTART_FINE_SAMPLES
    print(f"[4d] (b) {RESTART_CHAINS} chains x {RESTART_FINE_SAMPLES} fine samples through the "
          f"1-entry sharded pools ({smi}): clean {n / clean_wall:.2f} fine samples/s "
          f"({clean_wall:.2f} s); with checkpoint_dir and one NaN after {fault['hit']} fine "
          f"evaluations {n / wall:.2f} fine samples/s ({wall:.2f} s); restarts {res.restarts}, "
          f"failures {res.failures}")
    print(f"[4d] (b) snapshots: {len(writes)} writes, mean {np.mean(writes):.3f} ms, largest "
          f"{max(writes):.3f} ms; {len(files)} files, {n_bytes} bytes on disk; restores "
          f"{len(restores)} ({', '.join(f'{x:.3f}' for x in restores)} ms) of step "
          f"{read_steps}")
    if fault["hit"] is None or len(res.restarts) != 1 or res.failures:
        fail(f"(b) restarts {res.restarts}, failures {res.failures}: want one chain "
             "restarted once")
    ((c, used),) = res.restarts.items()
    if used != 1 or len(restores) != 1 or f"chain_{c}.npz" not in files:
        fail(f"(b) chain {c}: {used} restarts, {len(restores)} restores from disk")
    snap = read_steps[0]
    chains = res.chains
    if chains.shape != (RESTART_CHAINS, RESTART_FINE_SAMPLES, 2) or not np.isfinite(
            chains).all():
        fail(f"(b) chains {chains.shape} not finite")
    if not np.array_equal(chains[c][:snap], clean.chains[c][:snap]):
        fail(f"(b) chain {c}'s first {snap} samples differ from the clean run's")
    for other in set(range(RESTART_CHAINS)) - {c}:
        if not np.array_equal(chains[other], clean.chains[other]):
            fail(f"(b) chain {other}, which did not fail, differs from the clean run")
    print(f"[4d] (b) chain {c} resumed from its snapshot of {snap} samples: those equal the "
          f"clean run's bit for bit, and the other chains equal it entirely")
    return {"writes": len(writes), "write_ms_mean": float(np.mean(writes)),
            "write_ms_max": max(writes), "bytes": n_bytes, "restore_ms": restores[0],
            "clean_rate": n / clean_wall, "restart_rate": n / wall}


def phase_sharded(torch, w, res, rows, smi: str = ""):
    """Phase 4d on phase 4's hierarchy and GP: (a) the sharded pools against
    ``BatchServer``, (b) a chain restart through disk, with the launch
    counters set to 0 just before (a) and read after (b)."""
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    h, gp = res["hierarchy"], res["gp"]
    build.reset_counters()
    pools, _med = sharded_pool_checks(torch, w, h, gp, smi)
    restart_checks(torch, w, h, pools, smi)
    torch.cuda.synchronize()
    fused = build.counter("swe_fused_step")
    mean = build.counter("matern52_mean")
    replays = {name[len("graph_replays "):]: c.value for name, c in build.COUNTERS.items()
               if name.startswith("graph_replays ") and "shard" in name and c.value}
    print(f"[4d] launches: swe_fused_step {fused.value} ({fused.replayed} from graph replays), "
          f"matern52_mean {mean.value} ({mean.replayed} from graph replays); sharded graph "
          f"replays {replays}")
    for name, c in (("swe_fused_step", fused), ("matern52_mean", mean)):
        if not c.value or not c.replayed > c.value / 2:
            fail(f"4d {name}: {c.value} launches, {c.replayed} from replays: not mostly "
                 "from graph replays")
    rows["swe_fused_step"]["launches_phase_4d"] = {
        "sharded": fused.value, "from_replays": fused.replayed}
    rows["matern52"]["launches_phase_4d"] = {
        "sharded": mean.value, "from_replays": mean.replayed}
    print(f"[4d] phase wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phases 5 and 6: the LM slice at full width
# ---------------------------------------------------------------------------
def _lm_config():
    from repro_torch.configs import ARCHS

    return ARCHS[LM_ARCH]


def _prefill_len() -> int:
    from repro_torch.configs import SHAPES

    return SHAPES["prefill_32k"].seq_len


def attention_calls(cfg) -> int:
    """Flash-attention calls of one prefill: a layer each (dense, MoE), an
    invocation of the shared block each (hybrid), none (SSM)."""
    if cfg.family == "ssm":
        return 0
    if cfg.shared_attn_every:
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers


def three_prefills(torch, cfg, params, batch, phase: str):
    """On ``batch`` (tokens, and a VLM's patches): the kernel path, then
    the plain blocked attention with 512-key blocks (the default) and, as
    the control, with 64-key blocks: two sound
    computations that differ only in where p is rounded, as the kernel's
    64-key tiles differ from the 512-key blocks.  Each with the counters at
    0 just before; the kernel path must launch the tensor-core flash kernel
    once an attention call, the others never, the fp32 route never.  ->
    ({label: last-position logits (B, V)}, tensor-core launches of the
    kernel path)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import build_model
    from repro_torch.models import chunked_attention

    plain = chunked_attention.attention_chunked
    out, kernel_launches = {}, 0
    for impl, block_k in (("kernel", None), ("chunked", 512), ("chunked", 64)):
        label = impl if block_k is None else f"{impl}/{block_k}"
        if block_k:
            chunked_attention.attention_chunked = partial(plain, block_k=block_k)
        bundle = build_model(replace(cfg, attn_impl=impl))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_counters()
        t0 = time.perf_counter()
        logits = bundle.prefill(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chunked_attention.attention_chunked = plain
        launches = fa.LAUNCHES["tensor_core"].value
        fp32_launches = fa.LAUNCHES["cuda_core"].value
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[{phase}] prefill attn_impl={label}: {wall:.3f} s wall, peak memory {peak:.2f} GiB, "
              f"flash_attention launches: tensor-core route {launches}, fp32 route "
              f"{fp32_launches}")
        if fp32_launches:
            fail(f"the bf16 prefill launched the fp32 flash kernel {fp32_launches} times")
        if impl == "kernel":
            if launches != attention_calls(cfg):
                fail(f"prefill launched the tensor-core flash kernel {launches} times, "
                     f"want {attention_calls(cfg)}")
            kernel_launches = launches
        elif launches != 0:
            fail(f"the chunked prefill launched flash_attention {launches} times")
        b = batch["tokens"].shape[0]
        if logits.shape != (b, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
            fail(f"prefill ({label}) logits {tuple(logits.shape)} are not finite ({b}, 1, V)")
        out[label] = logits[:, -1]

    def diff(a, b):
        return float((out[a] - out[b]).abs().max())

    d_kernel, d_ctrl = diff("kernel", "chunked/512"), diff("chunked/64", "chunked/512")
    print(f"[{phase}] last-position logits (range {float(out['kernel'].min()):.3f}.."
          f"{float(out['kernel'].max()):.3f}), max abs diff: kernel vs chunked/512 "
          f"{d_kernel:.4e}, control chunked/64 vs chunked/512 {d_ctrl:.4e}, kernel vs "
          f"chunked/64 {diff('kernel', 'chunked/64'):.4e}; argmax "
          + " / ".join(f"{k} {x.argmax(-1).tolist()}" for k, x in out.items()))
    if not d_kernel <= PREFILL_DIFF_FACTOR * d_ctrl:
        fail(f"kernel-path logits differ from the plain path's by {d_kernel}, more than "
             f"{PREFILL_DIFF_FACTOR}x the control's {d_ctrl}")
    return out, kernel_launches


def phase_lm_prefill(torch, cfg, params, rows):
    s = _prefill_len()
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (1, s), generator=gen).cuda()
    print(f"[5] prefill: {cfg.arch_id} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}), "
          f"{cfg.compute_dtype}, seeded random weights; one {s}-token prompt (prefill_32k with its "
          "global batch cut from 32 to 1)")
    _, rows["flash_attention"]["launches"] = three_prefills(torch, cfg, params,
                                                            {"tokens": tokens}, "5")


def serve_work(torch, cfg, params, mode, work, phase, **engine_kw):
    """``work`` through a ``ServingEngine`` in ``mode`` on the card, after one
    warm-up request -> (tokens of each request, ``serving_metrics`` with the
    engine's summary under ``"summary"``)."""
    import numpy as np

    from repro_torch.runtime.serve_loop import ServingEngine, serving_metrics

    name = cfg.arch_id
    warm = np.random.default_rng(1).integers(0, cfg.vocab, size=(1, SERVE_PROMPT_LEN))
    with ServingEngine({name: cfg}, mode=mode, n_slots=SERVE_SLOTS, cache_len=SERVE_CACHE_LEN,
                       device="cuda", params={name: params}, **engine_kw) as eng:
        eng.submit(name, warm, 2).result(timeout=600)
        t0 = time.monotonic()
        gens = [eng.submit(name, p, n) for p, n in work]
        for g in gens:
            g.result(timeout=600)
        wall = time.monotonic() - t0
        m = serving_metrics(gens, wall, eng.summary())
        m["summary"] = eng.summary()
    tokens = [g.result().tokens for g in gens]
    print(f"[{phase}] serving {mode}: {m['n_requests']} requests, {m['n_tokens']} tokens in "
          f"{wall:.3f} s -> {m['tokens_per_s']:.1f} tok/s; ttft mean "
          f"{m['ttft_mean_s'] * 1e3:.2f} ms p99 {m['ttft_p99_s'] * 1e3:.2f} ms; per-token "
          f"p50 {m['per_token_p50_s'] * 1e3:.2f} ms p99 {m['per_token_p99_s'] * 1e3:.2f} ms; "
          f"slot occupancy {m.get('slot_occupancy', {})}")
    for toks, (_, n_new) in zip(tokens, work):
        if len(toks) != n_new:
            fail(f"{mode}: a request asked for {n_new} tokens and got {len(toks)}")
    return tokens, m


def profile_steps(torch, label: str, fn, n_steps: int = 5) -> None:
    """Where one step's time goes: ``n_steps`` calls of ``fn`` under the
    profiler, host ops issued against device time, the device's busy share
    and its largest operations."""
    from torch.profiler import ProfilerActivity, profile

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
    if not kernels:
        print(f"{label}: {wall_ms:.3f} ms wall under the profiler, {len(ops) / n_steps:.0f} "
              "host ops per step; device time not measured (the profiler saw no kernels)")
        return
    print(f"{label} (profiler, {n_steps} steps): {wall_ms:.3f} ms wall, "
          f"{len(ops) / n_steps:.0f} top-level host ops and {len(kernels) / n_steps:.0f} device "
          f"operations per step, device time {busy_ms:.3f} ms: device busy "
          f"{busy_ms / wall_ms:.1%}, idle {1 - busy_ms / wall_ms:.1%}")
    by_name = Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n_steps
    print(f"{label}, device time by operation (ms a step, share): "
          + "; ".join(f"{name[:90]} {t:.3f} ({t / busy_ms:.1%})"
                      for name, t in by_name.most_common(5)))


def decode_step_peak(torch, cfg, params, batch: int, cache_len: int, phase: str = "6") -> int:
    """The peak device memory of one eager slab decode step of ``batch``
    rows over a ``cache_len`` cache half full, above what the step starts
    from (its state and the weights), printed -> bytes."""
    from repro_torch.models.lm import decode_step, init_decode_state

    state = init_decode_state(cfg, batch, cache_len, "cuda")
    state.pos.fill_(cache_len // 2)
    state.kv.pos_buf[:, : cache_len // 2] = torch.arange(cache_len // 2, device="cuda")
    feed = torch.zeros((batch, 1), dtype=torch.int64, device="cuda")
    decode_step(params, cfg, state, feed)  # library workspaces, the allocator
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    decode_step(params, cfg, state, feed)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    print(f"[{phase}] {cfg.arch_id} decode step B={batch} at cache_len {cache_len} (eager): peak "
          f"{extra / 2**20:.1f} MiB above the {before / 2**30:.3f} GiB it starts from (weights "
          "and state)")
    return extra


def phase_lm_serving(torch, cfg, params):
    """Phase 6; returns what phase 6b holds its modes to: the work, each
    mode's tokens and metrics, the control differences and the eager B = 1
    logits of the generation tokens."""
    import numpy as np

    from repro_torch.models import build_model
    from repro_torch.models.lm import decode_step, pool_decode_state, slot_insert
    from repro_torch.runtime.serve_loop import DecodeGraph

    rng = np.random.default_rng(0)
    work = []
    for _ in range(SERVE_REQUESTS):  # as launch/serve.py draws them (one variant)
        rng.integers(1)
        n_new = int(rng.choice([1, 4, 16, 64], p=[0.4, 0.3, 0.2, 0.1]))
        work.append((rng.integers(0, cfg.vocab, size=(1, SERVE_PROMPT_LEN)), n_new))
    tokens, metrics = {}, {}
    for mode in ("continuous", "generation"):
        tokens[mode], metrics[mode] = serve_work(torch, cfg, params, mode, work, "6")

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
    feed = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    profile_steps(torch, "[6] decode step B=1 eager",
                  lambda: decode_step(params, cfg, states[1], feed))
    profile_steps(torch, "[6] decode step B=1 replay", lambda: g1(feed))
    decode_step_peak(torch, cfg, params, SERVE_SLOTS, LONG_CACHE_LEN)
    return {"work": work, "tokens": tokens, "metrics": metrics, "delta_first": delta_first,
            "delta_mode": delta_mode, "first_logits": [ls for _, ls in pairs],
            "ref_logits": ref_logits}


def _clone_paged(state):
    from repro_torch.models.attention import PagedKVCache

    def clone(t):
        return None if t is None else t.clone()

    kv = None if state.kv is None else PagedKVCache(state.kv.k.clone(), state.kv.v.clone())
    return state._replace(kv=kv, tables=clone(state.tables), pos=state.pos.clone(),
                          ssm_h=clone(state.ssm_h), ssm_conv=clone(state.ssm_conv))


def _paged_written(state):
    """What a paged step or chunk writes in place: the block pool past the
    scratch row 0 (which every inactive slot writes, duplicate indices with
    no fixed winner), or the slots' recurrent state."""
    if state.kv is not None:
        return [state.kv.k[:, 1:], state.kv.v[:, 1:]]
    return [state.ssm_h, state.ssm_conv]


def paged_graph_checks(torch, cfg, params, served, phase: str = "6b"):
    """6b (b): a ``PagedGraphs`` of the pool's shapes against the eager
    functions on a copy of its state, bit for bit: chunk graphs over eight
    slots' prompts, steps with every slot and with some slots active, then
    the same after one slot was moved onto other block rows after the
    captures (for an SSM pool, which has no blocks, the slot is re-leased).
    Also the eager chunked prefill's first-token logits against the serving
    prefill's (phase 6), held as the kernel prefill is, unless
    ``served["first_logits"]`` is None (an MoE whose chunks drop pairs that
    the serving prefill keeps).  Returns the graphs, each slot's next feed
    token and the all-active mask."""
    from repro_torch.models import build_model
    from repro_torch.models.lm import paged_decode_step, paged_prefill_chunk, paged_reset_slot
    from repro_torch.runtime.serve_loop import PagedGraphs

    bundle = build_model(cfg)
    max_blocks = SERVE_CACHE_LEN // PAGED_BLOCK_SIZE
    reserved0 = torch.cuda.memory_reserved()
    g = PagedGraphs(bundle, params, n_slots=SERVE_SLOTS, n_blocks=SERVE_SLOTS * max_blocks,
                    block_size=PAGED_BLOCK_SIZE, cache_len=SERVE_CACHE_LEN, name="check paged")
    mem = {"step": torch.cuda.memory_reserved() - reserved0}
    unequal_, checks, d_chunk = 0, 0, 0.0
    work, first_logits = served["work"], served["first_logits"]

    def same(a, b) -> None:
        nonlocal unequal_, checks
        unequal_ += 0 if torch.equal(a, b) else 1
        checks += 1

    def lease(slot, rows):
        paged_reset_slot(g.state, slot, rows + [0] * (max_blocks - len(rows)))

    def chunked(slot, i):
        nonlocal d_chunk
        prompt = torch.as_tensor(work[i][0][0], device="cuda")
        for start in range(0, prompt.numel(), PAGED_CHUNK):
            piece = prompt[start : start + PAGED_CHUNK]
            ref = _clone_paged(g.state)
            want = paged_prefill_chunk(params, cfg, ref, torch.tensor(slot, device="cuda"),
                                       piece, torch.tensor(start, device="cuda"), SERVE_CACHE_LEN)
            before = torch.cuda.memory_reserved()
            new = len(piece) not in g.chunks
            ids, logits = g.chunk(slot, piece.cpu().numpy(), start)
            if new:
                mem[f"chunk C={len(piece)}"] = torch.cuda.memory_reserved() - before
            for a, b in ((ids, want[1]), (logits, want[2]), (g.state.pos, want[0].pos),
                         *zip(_paged_written(g.state), _paged_written(ref))):
                same(a, b)
        if first_logits is not None:
            d_chunk = max(d_chunk, float((want[2][0, -1] - first_logits[i]).abs().max()))
        return int(ids[0])

    def stepped(feeds, active):
        feeds_t = torch.tensor(feeds, device="cuda")
        active_t = torch.tensor(active, device="cuda")
        ref = _clone_paged(g.state)
        want = paged_decode_step(params, cfg, ref, feeds_t, active_t, SERVE_CACHE_LEN)
        ids, logits = g.step(feeds_t, active_t)
        for a, b in ((ids, want[1]), (logits, want[2]), (g.state.pos, want[0].pos),
                     *zip(_paged_written(g.state), _paged_written(ref))):
            same(a, b)
        return [int(x) if on else f for x, f, on in zip(ids.tolist(), feeds, active)]

    # Slot s leases rows 1 + 4 s .. 4 + 4 s (64 positions); rows 33.. stay free.
    for slot in range(SERVE_SLOTS):
        lease(slot, [1 + 4 * slot + b for b in range(4)])
    feeds = [chunked(slot, slot) for slot in range(SERVE_SLOTS)]
    every = [True] * SERVE_SLOTS
    some = [slot % 3 != 1 for slot in range(SERVE_SLOTS)]
    for active in (every, some, every):
        feeds = stepped(feeds, active)
    n_before = checks
    # After the captures: slot 3 moves onto free rows and takes request 8.
    lease(3, [50, 41, 63, 36])
    feeds[3] = chunked(3, SERVE_SLOTS)
    for active in (every, some):
        feeds = stepped(feeds, active)
    moe = "" if cfg.moe is None else f" at capacity factor {cfg.moe.capacity_factor}"
    print(f"[{phase}] {cfg.arch_id}{moe}: paged graphs vs eager (ids, logits, positions, block "
          "pool or recurrent state; bit for bit): "
          f"{unequal_} of {checks} comparisons unequal ({n_before} before slot 3 moved onto "
          f"rows 50/41/63/36, {checks - n_before} after); chunk graphs {sorted(g.chunks)}; "
          "graph memory reserved " + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in mem.items()))
    if unequal_:
        fail(f"paged graphs differ from the eager functions in {unequal_} of {checks} comparisons")
    if first_logits is None:
        return g, feeds, every
    bound = PREFILL_DIFF_FACTOR * served["delta_first"]
    print(f"[{phase}] chunked prefill (eager, {PAGED_CHUNK}-position chunks) vs the serving prefill, "
          f"first-token logits of {SERVE_SLOTS + 1} requests: max abs diff {d_chunk:.4e} "
          f"(bound {PREFILL_DIFF_FACTOR} delta_first = {bound:.4e})")
    if not d_chunk <= bound:
        fail(f"chunked prefill differs from the serving prefill by {d_chunk} > {bound}")
    return g, feeds, every


def phase_lm_paged(torch, cfg, params, served):
    """6b: the paged and speculative modes on phase 6's work and weights."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.models.lm import paged_decode_step

    work, gen = served["work"], served["tokens"]["generation"]
    tokens, metrics = dict(served["tokens"]), dict(served["metrics"])
    reserved0 = torch.cuda.memory_reserved()
    tokens["paged"], metrics["paged"] = serve_work(
        torch, cfg, params, "paged", work, "6b", block_size=PAGED_BLOCK_SIZE,
        prefill_chunk=PAGED_CHUNK)
    chunk_graphs = sorted(k for k, c in build.COUNTERS.items()
                          if k.startswith("graph_replays paged:") and " chunk C=" in k and c.value)
    print(f"[6b] paged pool: chunk graphs captured {len(chunk_graphs)} ({chunk_graphs}); device "
          f"memory reserved {(torch.cuda.memory_reserved() - reserved0) / 2**20:.1f} MiB more "
          "after the engine (block pool, step and chunk graphs)")
    tokens["speculative"], metrics["speculative"] = serve_work(
        torch, cfg, params, "speculative", work, "6b", spec_k=SPEC_K,
        spec_draft_layers=cfg.n_layers // 2)

    # (a) Speculative tokens are generation's exactly: each verify step is
    # generation's B = 1 step on the same values.  Paged tokens may differ
    # from generation's only at a near tie: where the eager B = 1 top-2 gap
    # of the diverging token is below twice phase 6's control difference.
    for i, (s_, g_) in enumerate(zip(tokens["speculative"], gen)):
        if not np.array_equal(s_, g_):
            j = int(np.flatnonzero(s_ != g_)[0]) if len(s_) == len(g_) else min(len(s_), len(g_))
            fail(f"request {i}: speculative tokens differ from generation's at token {j}")
    delta = max(served["delta_first"], served["delta_mode"])
    n_div = 0
    for i, (p_, g_) in enumerate(zip(tokens["paged"], gen)):
        if np.array_equal(p_, g_):
            continue
        j = int(np.flatnonzero(p_ != g_)[0])
        logits = served["first_logits"][i] if j == 0 else served["ref_logits"][i][j - 1]
        gap = _top2_gap(torch, logits)
        print(f"[6b] request {i}: paged diverges from generation at token {j} "
              f"({int(p_[j])} vs {int(g_[j])}), top-2 gap {gap:.4e}")
        if not gap < 2 * delta:
            fail(f"request {i}: paged diverges at top-2 gap {gap} >= 2 delta ({delta})")
        n_div += 1
    print(f"[6b] tokens: speculative == generation for all {len(work)} requests; paged: "
          f"{n_div} of {len(work)} diverge, each at a near tie (delta {delta:.4e})")

    # (b) graphs against eager; a step eager against replay, and the
    # profiler on one replayed step.
    g, feeds, every = paged_graph_checks(torch, cfg, params, served)
    feeds_t = torch.tensor(feeds, device="cuda")
    active_t = torch.tensor(every, device="cuda")
    ref = [_clone_paged(g.state)]

    def eager():
        ref[0] = paged_decode_step(params, cfg, ref[0], feeds_t, active_t, SERVE_CACHE_LEN)[0]

    step_ms, runs = host_times_in_turns(
        torch, {"eager": eager, "replay": partial(g.step, feeds_t, active_t)}, 5)
    print(f"[6b] paged step, {SERVE_SLOTS} active slots (host clock, ending in synchronize, "
          f"mean of 2 x 5 in turns): eager {step_ms['eager']:.3f} ms, replay "
          f"{step_ms['replay']:.3f} ms; runs " + ", ".join(
              f"{k} " + "/".join(f"{x:.3f}" for x in v) for k, v in runs.items()))
    profile_steps(torch, f"[6b] paged step {SERVE_SLOTS} slots replay",
                  partial(g.step, feeds_t, active_t))
    del g

    # (c) telemetry.
    occ = metrics["paged"].get("block_occupancy", {})
    spec = metrics["speculative"].get("spec_accept", {})
    if not occ or not all(0.0 < x <= 1.0 for x in occ.values()):
        fail(f"block occupancy {occ} not in (0, 1]")
    if not spec or not all(row["rounds"] > 0 and row["drafted"] > 0 for row in spec.values()):
        fail(f"speculative telemetry {spec}: want rounds > 0 and drafted > 0")

    # (d) speed, printed and not gated.
    def row(mode):
        m = metrics[mode]
        return (f"{mode} {m['tokens_per_s']:.1f} tok/s, ttft mean {m['ttft_mean_s'] * 1e3:.1f} "
                f"p99 {m['ttft_p99_s'] * 1e3:.1f} ms, per-token p50 "
                f"{m['per_token_p50_s'] * 1e3:.2f} p99 {m['per_token_p99_s'] * 1e3:.2f} ms")

    tps = {mode: m["tokens_per_s"] for mode, m in metrics.items()}
    modes = ("generation", "continuous", "paged", "speculative")
    print("[6b] serving, four modes: " + "; ".join(row(m) for m in modes))
    print(f"[6b] ratios (not gated): paged / continuous {tps['paged'] / tps['continuous']:.3f} "
          f"(the reference's gate 1.3); continuous / generation "
          f"{tps['continuous'] / tps['generation']:.3f} (gate 2.0); speculative / generation "
          f"{tps['speculative'] / tps['generation']:.3f}; block occupancy {occ}; spec accept "
          + ", ".join(f"{t} rate {r['rate']:.4f} ({r['accepted']}/{r['drafted']} over "
                      f"{r['rounds']} rounds)" for t, r in spec.items()))


# ---------------------------------------------------------------------------
# phase 6c: the MoE, SSM and hybrid families at full width
# ---------------------------------------------------------------------------
FAMILY_ARCHS = ("granite-moe-3b-a800m", "mamba2-1.3b", "zamba2-1.2b")
# The reference's own bounds for their parameter counts
# (tests/test_models_smoke.py).
FAMILY_PARAM_BOUNDS = {"granite-moe-3b-a800m": (2.5e9, 4.0e9), "mamba2-1.3b": (1.0e9, 1.7e9),
                       "zamba2-1.2b": (1.0e9, 1.6e9), "llava-next-mistral-7b": (6.5e9, 8.0e9),
                       "mixtral-8x22b": (130e9, 150e9), "nemotron-4-340b": (300e9, 380e9),
                       "whisper-large-v3": (1.3e9, 2.2e9)}
SSM_CHECK_LEN = 256  # (c): mamba2's chunked prefill against the recurrence
SSM_CHECK_PROMPTS = SERVE_SLOTS
# (c) in fp32 on a depth cut: the SSD and the recurrence are the same sums
# in other orders, so they agree to fp32 rounding carried through two blocks
# and the head (the CPU tests' reduced models agree to ~1e-5).
SSM_FP32_LAYERS = 2
SSM_FP32_ATOL = 1e-3
# (e): cut this first should the run near its limit, then N_FINE_SAMPLES.
FAMILY_REQUESTS = SERVE_REQUESTS
# An MoE capacity factor at which no pair of a 16-position chunk or a
# 32-token prompt drops (a token takes an expert once, so cap >= the
# sequence's length suffices): granite's paged mode is served again at it
# and held to generation, whose prompts go token by token and never drop,
# and the control prefills of (e) run at it, as the reference's own
# decode-vs-forward test raises it.
NO_DROP_CAPACITY = 8.0
# (e) The token rule again in fp32 on a depth cut of each family (zamba2's
# keeps one invocation of the shared block), where delta is rounding, far
# below the top-2 gaps; in bf16 at full width delta is 0.3-1.4 logits.
FAMILY_FP32_LAYERS = {"granite-moe-3b-a800m": 2, "mamba2-1.3b": 2, "zamba2-1.2b": 6}


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def _named(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _named(v, f"{prefix}{k}.")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _named(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], node


def param_counts(torch, names, phase: str) -> None:
    """(a) Each full config's parameter count, from its shapes alone (the
    meta device: mixtral and nemotron do not fit the card), within the
    reference's bounds."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models.lm import param_count

    for name in names:
        cfg = ARCHS[name]
        n = param_count(build_model(cfg).init(torch.Generator(), "meta"))
        lo, hi = FAMILY_PARAM_BOUNDS[name]
        print(f"[{phase}] {name} ({cfg.family}): {cfg.n_layers} layers at full depth, {n:,} "
              f"parameters ({n / 1e9:.3f}e9; the reference's bounds {lo:.1e}..{hi:.1e})")
        if not lo <= n <= hi:
            fail(f"{name}: {n} parameters outside the reference's bounds {lo}..{hi}")


def draw_params(torch, cfg, phase: str):
    """Seeded random weights of ``cfg`` drawn on the card."""
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    blocks = params.get("blocks") or params["dec_blocks"]
    fp32 = sorted({k for k, t in _named(blocks[0]) if t.dtype == torch.float32})
    print(f"[{phase}] {cfg.arch_id}: {cfg.n_layers} layers"
          + (f" (+{cfg.n_encoder_layers} encoder layers)" if cfg.n_encoder_layers else "")
          + f", d_model {cfg.d_model}, vocab {cfg.vocab}: {n_bytes / 1e9:.3f} GB of weights, "
          f"fp32 leaves of a block {fp32}; drawn in {time.perf_counter() - t0:.1f} s")
    return params


def ssm_prefill_checks(torch, cfg, params):
    """(c) mamba2's chunked prefill (chunk 128, the SSD) against the
    recurrence (``prefill_state``'s decode steps, replayed by a B = 8
    ``DecodeGraph``, which (e) holds bit for bit against the eager steps)
    on SSM_CHECK_PROMPTS prompts: argmaxes equal wherever the top-2 gap is
    at least 2 delta, delta the difference between the chunk-128 and
    chunk-64 prefills.  The same two computations in fp32 on the first
    SSM_FP32_LAYERS blocks (the weights cast) agree within SSM_FP32_ATOL."""
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import DecodeGraph

    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (SSM_CHECK_PROMPTS, SSM_CHECK_LEN), generator=gen).cuda()
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    l128 = bundle.prefill(params, {"tokens": tokens})[:, -1]
    l64 = build_model(replace(cfg, ssm=replace(cfg.ssm, chunk=64))).prefill(
        params, {"tokens": tokens})[:, -1]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec = DecodeGraph(bundle, params, SSM_CHECK_PROMPTS, SSM_CHECK_LEN, name="6c recurrence")
    lrec = rec.prefill(tokens)[1][:, -1]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del rec
    delta = float((l128 - l64).abs().max())
    d_rec = float((l128 - lrec).abs().max())
    n_div = 0
    for r in range(SSM_CHECK_PROMPTS):
        if int(l128[r].argmax()) != int(lrec[r].argmax()):
            gap = _top2_gap(torch, lrec[r])
            print(f"[6c] prompt {r}: chunked argmax {int(l128[r].argmax())} vs recurrence "
                  f"{int(lrec[r].argmax())}, top-2 gap {gap:.4e}")
            if not gap < 2 * delta:
                fail(f"mamba2 prompt {r}: chunked prefill and recurrence disagree at top-2 gap "
                     f"{gap} >= 2 delta ({delta})")
            n_div += 1
    if not all(bool(torch.isfinite(x).all()) for x in (l128, l64, lrec)):
        fail("mamba2 prefill logits are not finite")
    cut, p32 = _fp32_cut(torch, cfg, params, SSM_FP32_LAYERS)
    f_chunk = build_model(cut).prefill(p32, {"tokens": tokens})[:, -1]
    f_rec = build_model(cut).prefill_state(p32, tokens, SSM_CHECK_LEN)[0][:, -1]
    d32 = float((f_chunk - f_rec).abs().max())
    print(f"[6c] {cfg.arch_id}: {SSM_CHECK_PROMPTS} prompts of {SSM_CHECK_LEN} tokens, bf16, prefill "
          f"(chunk {cfg.ssm.chunk}) vs the recurrence: max abs diff {d_rec:.4e}; delta (chunk "
          f"{cfg.ssm.chunk} vs 64) {delta:.4e}; {n_div} argmaxes differ, each at a near tie; "
          f"walls: two chunked prefills {t1 - t0:.3f} s, the recurrence (capture and "
          f"{SSM_CHECK_LEN} replays) {t2 - t1:.3f} s.  fp32, first {SSM_FP32_LAYERS} blocks: "
          f"max abs diff {d32:.4e} (bound {SSM_FP32_ATOL}; logits range "
          f"{float(f_rec.min()):.3f}..{float(f_rec.max()):.3f})")
    if not d32 <= SSM_FP32_ATOL:
        fail(f"mamba2 fp32: chunked prefill and recurrence differ by {d32} > {SSM_FP32_ATOL}")


def _cast(node, dtype):
    if isinstance(node, dict):
        return {k: _cast(v, dtype) for k, v in node.items()}
    if isinstance(node, list):
        return [_cast(v, dtype) for v in node]
    return node.to(dtype)


def _fp32_cut(torch, cfg, params, n_layers):
    """The first ``n_layers`` blocks of ``cfg`` and ``params`` in fp32."""
    cut, p_cut = _depth_cut(cfg, params, n_layers)
    return replace(cut, param_dtype="float32", compute_dtype="float32"), _cast(p_cut, torch.float32)


def _no_drops(cfg):
    """``cfg`` with its MoE at NO_DROP_CAPACITY (unchanged without one)."""
    if cfg.moe is None:
        return cfg
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=NO_DROP_CAPACITY))


def family_reference(torch, cfg, params, work, gen_tokens, phase: str = "6c"):
    """(e) The references of the top-2 rule and the graph checks.

    delta_first: the largest first-token logit difference between the
    serving prefill (B = 1 decode steps) and a control that does not run
    the flash kernel (the chunked-attention prefill; mamba2's SSD prefill);
    the kernel prefill may differ from the serving prefill by at most
    PREFILL_DIFF_FACTOR times it (in bf16: the fp32 depth cut holds tokens,
    not the kernel's route).  An MoE prefill routes the prompt as one
    sequence, so these run at NO_DROP_CAPACITY.  Reference logits: the B = 1
    graph teacher-forced on generation's tokens; delta_mode: their largest
    difference from the B = 8 graph's (every slot holding the request).
    The eager B = 1 and B = 8 steps must equal the graphs' bit for bit on
    two requests (logits, and the recurrent state after the steps)."""
    from repro_torch.models import build_model
    from repro_torch.models.lm import decode_step, slot_insert
    from repro_torch.runtime.serve_loop import DecodeGraph

    bundle = build_model(cfg)
    ctrl_cfg = _no_drops(cfg)
    hold_kernel = cfg.family != "ssm" and cfg.compute_dtype == "bfloat16"
    ctrl = build_model(replace(ctrl_cfg, attn_impl="chunked"))
    kern = build_model(ctrl_cfg)
    g1 = DecodeGraph(bundle, params, 1, SERVE_CACHE_LEN, name=f"{phase} check B=1")
    g8 = DecodeGraph(bundle, params, SERVE_SLOTS, SERVE_CACHE_LEN, name=f"{phase} check B={SERVE_SLOTS}")
    long = next((i for i, (_, n) in enumerate(work) if n >= 16), len(work) - 1)
    eager_checked = {0, long}
    ref, delta_first, delta_kernel, delta_mode = [], 0.0, 0.0, 0.0
    unequal_, n_cmp = 0, 0

    def same(a, b):
        nonlocal unequal_, n_cmp
        unequal_ += unequal([a], [b])
        n_cmp += a.numel()

    for i, ((p, _), g) in enumerate(zip(work, gen_tokens)):
        prompt = torch.as_tensor(p).cuda()
        _, ls = g1.prefill(prompt)
        lc = ctrl.prefill(params, {"tokens": prompt})
        delta_first = max(delta_first, float((lc - ls).abs().max()))
        if hold_kernel:
            lk = kern.prefill(params, {"tokens": prompt})
            delta_kernel = max(delta_kernel, float((lk - ls).abs().max()))
        logits = [ls[0, -1]]
        eager = i in eager_checked
        if eager:
            le, st1 = bundle.prefill_state(params, prompt, SERVE_CACHE_LEN)
            same(le, ls)
            pool = bundle.decode_init(params, {"tokens": prompt.expand(SERVE_SLOTS, -1)},
                                      SERVE_CACHE_LEN)
            for slot in range(SERVE_SLOTS):
                slot_insert(pool, st1, slot)
        g8.reset()
        snap = g1.snapshot()
        for slot in range(SERVE_SLOTS):
            slot_insert(g8.state, snap, slot)
        for j in range(1, len(g)):
            feed = torch.full((1, 1), int(g[j - 1]), device="cuda")
            _, l1 = g1(feed)
            _, l8 = g8(feed.expand(SERVE_SLOTS, 1))
            logits.append(l1[0, -1])
            delta_mode = max(delta_mode, float((l8[:, -1] - l1[0, -1]).abs().max()))
            if eager:
                le, st1 = decode_step(params, cfg, st1, feed)
                same(le, l1)
                le8, pool = decode_step(params, cfg, pool, feed.expand(SERVE_SLOTS, 1))
                same(le8, l8)
        if eager and cfg.ssm is not None:
            for a, b in ((st1.ssm_h, g1.state.ssm_h), (st1.ssm_conv, g1.state.ssm_conv),
                         (pool.ssm_h, g8.state.ssm_h), (pool.ssm_conv, g8.state.ssm_conv)):
                same(a, b)
        ref.append(logits)
    print(f"[{phase}] {cfg.arch_id}: graphs vs eager steps at B=1 and B={SERVE_SLOTS}, teacher-forced "
          f"on requests {sorted(eager_checked)}: {unequal_} of {n_cmp} values unequal (logits"
          f"{', recurrent state' if cfg.ssm is not None else ''}); delta_first (control prefill "
          f"vs serving prefill) {delta_first:.4e}, kernel prefill vs serving prefill "
          + (f"{delta_kernel:.4e}" if hold_kernel else "(not held)")
          + f"; delta_mode (B=1 vs B={SERVE_SLOTS} graphs) {delta_mode:.4e}")
    if unequal_:
        fail(f"{cfg.arch_id}: graph replays differ from the eager steps in {unequal_} values")
    if not delta_kernel <= PREFILL_DIFF_FACTOR * delta_first:
        fail(f"{cfg.arch_id}: kernel prefill differs from the serving prefill by {delta_kernel}, "
             f"more than {PREFILL_DIFF_FACTOR}x the control's {delta_first}")
    return {"ref_logits": ref, "first_logits": [r[0] for r in ref], "delta_first": delta_first,
            "delta_mode": delta_mode, "graphs": {1: g1, SERVE_SLOTS: g8}}


def top2_rule(torch, label, tokens, gen, ref, delta, phase: str = "6c") -> int:
    """Tokens that differ from generation's only where the reference's top-2
    gap at the first divergence is below 2 delta -> how many diverged."""
    import numpy as np

    n_div = 0
    for i, (t, g) in enumerate(zip(tokens, gen)):
        if np.array_equal(t, g):
            continue
        j = int(np.flatnonzero(t != g)[0])
        gap = _top2_gap(torch, ref[i][j])
        print(f"[{phase}] {label} request {i} diverges from generation at token {j} ({int(t[j])} vs "
              f"{int(g[j])}), top-2 gap {gap:.4e}")
        if not gap < 2 * delta:
            fail(f"{label} request {i}: diverges at top-2 gap {gap} >= 2 delta ({delta})")
        n_div += 1
    return n_div


def _median_top2_gap(torch, ref) -> float:
    """The median top-2 gap over every reference logit row of ``ref``."""
    top = torch.topk(torch.stack([r.float() for rows in ref for r in rows]), 2, dim=-1).values
    return float((top[:, 0] - top[:, 1]).median())


def _held_paged(cfg) -> str:
    """The paged tokens held to generation: an MoE's at NO_DROP_CAPACITY."""
    return "paged" if cfg.moe is None else "paged, no drops"


def family_tokens_held(torch, cfg, params, work, tokens, label, phase: str = "6c"):
    """(e) ``tokens`` (by mode) held to generation's: speculative exactly,
    continuous and paged by the top-2 rule with delta = max(delta_first,
    delta_mode) of ``family_reference`` -> its result, with "delta" and
    "median_gap", the median top-2 gap of the reference logits (below 2
    delta the rule can hardly fail)."""
    import numpy as np

    from repro_torch.runtime.serve_loop import speculative_supported

    gen = tokens["generation"]
    for i, (s_, g_) in enumerate(zip(tokens.get("speculative", gen), gen)):
        if not np.array_equal(s_, g_):
            fail(f"{cfg.arch_id}{label} request {i}: speculative tokens differ from generation's")
    served = family_reference(torch, cfg, params, work, gen, phase)
    delta = max(served["delta_first"], served["delta_mode"])
    median = _median_top2_gap(torch, served["ref_logits"])
    held = {m: top2_rule(torch, f"{cfg.arch_id}{label} {m}", tokens[m], gen, served["ref_logits"],
                         delta, phase)
            for m in ("continuous", _held_paged(cfg)) if m in tokens}
    spec = ("speculative" + ("" if speculative_supported(cfg, SERVE_CACHE_LEN) else
                             " (plain greedy)")
            + f" == generation for all {len(work)} requests; " if "speculative" in tokens else "")
    print(f"[{phase}] {cfg.arch_id}{label} tokens: {spec}"
          + ", ".join(f"{m} {n} of {len(work)} diverge" for m, n in held.items())
          + f", each at a near tie: delta {delta:.4e}, 2 delta {2 * delta:.4e} against the median "
          f"top-2 gap of the {sum(len(r) for r in served['ref_logits'])} reference logit rows "
          f"{median:.4e}")
    served.update(delta=delta, median_gap=median, work=work)
    return served


def family_fp32_cut(torch, cfg, params, work, n_layers, phase: str = "6c"):
    """(e) The token rule where it has teeth: generation, continuous and
    paged (an MoE's at NO_DROP_CAPACITY) on the family's first
    FAMILY_FP32_LAYERS blocks in fp32, held as at full width, and 2 delta
    must lie below the median top-2 gap."""
    cut, p32 = _fp32_cut(torch, cfg, params, n_layers)
    tokens = {}
    for mode in ("generation", "continuous") + (() if cfg.family == "hybrid" else ("paged",)):
        key = _held_paged(cut) if mode == "paged" else mode
        kw = {"block_size": PAGED_BLOCK_SIZE, "prefill_chunk": PAGED_CHUNK} if mode == "paged" else {}
        tokens[key], _ = serve_work(torch, _no_drops(cut) if mode == "paged" else cut, p32, mode,
                                    work, f"{phase} fp32 cut", **kw)
    label = f" (fp32, first {cut.n_layers} blocks)"
    served = family_tokens_held(torch, cut, p32, work, tokens, label, phase)
    served.pop("graphs")
    if not 2 * served["delta"] < served["median_gap"]:
        fail(f"{cfg.arch_id}{label}: 2 delta {2 * served['delta']} is not below the median top-2 "
             f"gap {served['median_gap']}: the token rule could hardly fail")


def family_serving(torch, cfg, params, fp32_layers, phase: str = "6c"):
    """(e) Every serving mode the family has, on phase 6's kind of work."""
    import numpy as np

    from repro_torch.models import build_model
    from repro_torch.models.lm import decode_step
    from repro_torch.runtime.serve_loop import ServingEngine

    rng = np.random.default_rng(0)
    work = []
    for _ in range(FAMILY_REQUESTS):  # as launch/serve.py draws them (one variant)
        rng.integers(1)
        n_new = int(rng.choice([1, 4, 16, 64], p=[0.4, 0.3, 0.2, 0.1]))
        work.append((rng.integers(0, cfg.vocab, size=(1, SERVE_PROMPT_LEN)), n_new))
    modes = ["generation", "continuous", "paged", "speculative"]
    if cfg.family == "hybrid":
        modes.remove("paged")
        try:
            ServingEngine({cfg.arch_id: cfg}, mode="paged", cache_len=SERVE_CACHE_LEN,
                          device="cuda", params={cfg.arch_id: params})
        except ValueError as e:
            print(f"[{phase}] {cfg.arch_id}: paged mode refused: {e}")
        else:
            fail(f"{cfg.arch_id}: the paged mode was not refused")
    kw = {"paged": {"block_size": PAGED_BLOCK_SIZE, "prefill_chunk": PAGED_CHUNK},
          "speculative": {"spec_k": SPEC_K, "spec_draft_layers": cfg.n_layers // 2}}
    tokens, metrics = {}, {}
    for mode in modes:
        tokens[mode], metrics[mode] = serve_work(torch, cfg, params, mode, work, phase,
                                                 **kw.get(mode, {}))
    if cfg.moe is not None:
        # At the configured capacity a 16-position chunk drops pairs that
        # generation's token-by-token prompt keeps: a different result,
        # counted here; the same work at NO_DROP_CAPACITY is held instead.
        n_diff = sum(not np.array_equal(t, g) for t, g in zip(tokens["paged"], tokens["generation"]))
        print(f"[{phase}] {cfg.arch_id}: paged at capacity factor {cfg.moe.capacity_factor}: {n_diff} "
              f"of {len(work)} requests' tokens differ from generation's (not held); served "
              f"again at {NO_DROP_CAPACITY}, where no pair drops")
        tokens[_held_paged(cfg)], _ = serve_work(torch, _no_drops(cfg), params, "paged", work,
                                                 phase, **kw["paged"])
    served = family_tokens_held(torch, cfg, params, work, tokens, "", phase)
    if "paged" in tokens:
        if cfg.moe is not None:  # the graphs at the configured capacity, bit for bit
            g, _, _ = paged_graph_checks(torch, cfg, params, {**served, "first_logits": None},
                                         phase)
            del g
        g, _, _ = paged_graph_checks(torch, _no_drops(cfg), params, served, phase)
        del g
    if fp32_layers:
        family_fp32_cut(torch, cfg, params, work, fp32_layers, phase)

    # Decode steps eager against replay, B = 1 and B = 8, by the host's clock.
    graphs = served.pop("graphs")
    prompt = torch.as_tensor(work[0][0]).cuda()
    bundle = build_model(cfg)
    states = {1: bundle.prefill_state(params, prompt, SERVE_CACHE_LEN)[1]}
    states[SERVE_SLOTS] = bundle.decode_init(params, {"tokens": prompt.expand(SERVE_SLOTS, -1)},
                                             SERVE_CACHE_LEN)
    for B, graph in graphs.items():
        graph.prefill(prompt.expand(B, -1).contiguous())
        if B > 1:
            states[B] = graph.snapshot()
        feed = torch.zeros((B, 1), dtype=torch.int64, device="cuda")

        def eager(B=B, feed=feed):
            states[B] = decode_step(params, cfg, states[B], feed)[1]

        step_ms, _ = host_times_in_turns(torch, {"eager": eager, "replay": partial(graph, feed)}, 5)
        print(f"[{phase}] {cfg.arch_id} decode step B={B} (host clock, ending in synchronize, mean of "
              f"2 x 5 in turns): eager {step_ms['eager']:.3f} ms, replay {step_ms['replay']:.3f} ms")

    def row(mode):
        m = metrics[mode]
        return (f"{mode} {m['tokens_per_s']:.1f} tok/s, ttft mean {m['ttft_mean_s'] * 1e3:.1f} "
                f"p99 {m['ttft_p99_s'] * 1e3:.1f} ms, per-token p50 "
                f"{m['per_token_p50_s'] * 1e3:.2f} p99 {m['per_token_p99_s'] * 1e3:.2f} ms")

    print(f"[{phase}] {cfg.arch_id} serving: " + "; ".join(row(m) for m in modes))


MOE_ROUTE_SLOTS = 32
MOE_COUNTERS = ("moe_dispatch pooled", "moe_dispatch per_sequence", "moe_rows computed",
                "moe_pairs routed")


class MoEDrops:
    """Inside ``with drops:`` (a ``MoEDrops``, entered once or more) every
    call of the MoE dispatch goes through to it; ``drops.groups`` lists
    the routing groups (shape, capacity) it was given and ``drops.pairs``
    sums the pairs it sent past capacity (to the scratch row), over every
    layer of every step run inside."""

    def __init__(self):
        self.groups, self._dropped = [], []

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self.dispatch = moe, moe._dispatch
        moe._dispatch = self
        return self

    def __call__(self, params, x, m, cap):
        out = self.dispatch(params, x, m, cap)
        self.groups.append((tuple(x.shape), cap))
        self._dropped.append(out[2].sum())
        return out

    @property
    def pairs(self) -> int:
        return int(sum(self._dropped)) if self._dropped else 0

    def __exit__(self, *exc):
        self._moe._dispatch = self.dispatch


def moe_route_checks(torch, phase: str = "6c") -> None:
    """(f) The reduced granite's paged decode step at 32 slots captured as
    one graph (``PagedGraphs.step``, a ``StaticGraph``) and replayed three
    times: each replay equals the eager step on a copy of the state bit
    for bit (ids, logits, positions, block pool), each MoE counter grows by
    three times the graph's captured tally, every MoE call of the tally is
    pooled (rows E x 32, pairs 32 k a layer), and the eager steps, on the
    replays' inputs, route one group of 32 tokens at capacity 32 a layer
    and drop no pair."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.models.lm import paged_decode_step, paged_reset_slot
    from repro_torch.runtime.serve_loop import PagedGraphs

    cfg = ARCHS["granite-moe-3b-a800m"].reduced()
    m, n = cfg.moe, MOE_ROUTE_SLOTS
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    max_blocks = SERVE_CACHE_LEN // PAGED_BLOCK_SIZE
    g = PagedGraphs(bundle, params, n_slots=n, n_blocks=n * max_blocks,
                    block_size=PAGED_BLOCK_SIZE, cache_len=SERVE_CACHE_LEN, name="check moe route")
    for slot in range(n):
        paged_reset_slot(g.state, slot, [1 + max_blocks * slot + b for b in range(max_blocks)])
    g.state.pos.copy_(torch.arange(n, device="cuda"))
    tally = {k: g.step.launches.get(k, 0) for k in MOE_COUNTERS}
    want_tally = {"moe_dispatch pooled": cfg.n_layers, "moe_dispatch per_sequence": 0,
                  "moe_rows computed": cfg.n_layers * m.n_experts * n,
                  "moe_pairs routed": cfg.n_layers * n * m.top_k}
    feeds = torch.randint(0, cfg.vocab, (n,), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))
    active = torch.ones((n,), dtype=torch.bool, device="cuda")
    grew = dict.fromkeys(MOE_COUNTERS, 0)
    unequal_, checks, drops = 0, 0, MoEDrops()
    for _ in range(3):
        ref = _clone_paged(g.state)
        with drops:
            want = paged_decode_step(params, cfg, ref, feeds, active, SERVE_CACHE_LEN)
        before = {k: build.counter(k).value for k in MOE_COUNTERS}
        ids, logits = g.step(feeds, active)
        for k in MOE_COUNTERS:
            grew[k] += build.counter(k).value - before[k]
        for a, b in ((ids, want[1]), (logits, want[2]), (g.state.pos, want[0].pos),
                     *zip(_paged_written(g.state), _paged_written(ref))):
            unequal_ += 0 if torch.equal(a, b) else 1
            checks += 1
        feeds = ids
    groups, want_groups = sorted(set(drops.groups)), [((1, n, cfg.d_model), n)]
    print(f"[{phase}] reduced {cfg.arch_id} ({m.n_experts} experts, top-{m.top_k}, "
          f"{cfg.n_layers} layers) paged decode step at {n} slots, one graph: captured tally "
          f"{tally}; grown over 3 replays {grew}; replay vs eager (ids, logits, positions, block "
          f"pool; bit for bit): {unequal_} of {checks} unequal; the 3 eager steps' dispatches: "
          f"{len(drops.groups)} calls, groups (shape, capacity) {groups}, {drops.pairs} pairs "
          f"dropped")
    if tally != want_tally:
        fail(f"the MoE counters' captured tally {tally} is not {want_tally}")
    if grew != {k: 3 * v for k, v in tally.items()}:
        fail(f"the MoE counters grew by {grew} over 3 replays of the tally {tally}")
    if len(drops.groups) != 3 * cfg.n_layers or groups != want_groups:
        fail(f"the eager steps dispatched {drops.groups}, not {want_groups} in each of "
             f"{cfg.n_layers} layers")
    if unequal_ or drops.pairs:
        fail(f"{unequal_} of {checks} replay-vs-eager comparisons unequal; {drops.pairs} pairs "
             f"dropped")


class FlashCalls:
    """Inside ``with FlashCalls() as calls:`` every call of the flash
    kernel's wrapper goes through to it, and ``calls.first`` keeps the
    inputs of the first: the shape and values that the main path gives the
    kernel, for a per-call check against the plain version afterwards
    (whose launch the main path's counts never see)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as fa

        self._fa, self.kernel, self.first = fa, fa.flash_attention, None
        fa.flash_attention = self
        return self

    def __call__(self, q, k, v, **kw):
        if self.first is None:
            self.first = (q, k, v, kw)
        return self.kernel(q, k, v, **kw)

    def __exit__(self, *exc):
        self._fa.flash_attention = self.kernel


def visible_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs that attention over ``s`` positions computes."""
    if not causal:
        return s * s
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def plain_by_kv_head(torch, q, k, v, causal, window):
    """``attention_chunked`` one kv head (and its query group) at a time:
    the same function as over every head at once, with the scores of one
    group in memory."""
    from repro_torch.models.chunked_attention import attention_chunked

    g = q.shape[1] // k.shape[1]
    return torch.cat([attention_chunked(q[:, j * g:(j + 1) * g], k[:, j:j + 1], v[:, j:j + 1],
                                        causal=causal, window=window)
                      for j in range(k.shape[1])], dim=1)


def flash_call_check(torch, label, call, phase: str, iters: int = 3) -> dict:
    """The main path's first flash call held against the plain blocked loop
    on the same inputs (the bf16 absolute and per-row bounds), then the
    kernel and ``scaled_dot_product_attention`` on them timed with CUDA
    events (a window is an explicit band mask: ``band_sdpa_ms``), beside
    the bound."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops as fa

    q, k, v, kw = call
    b, h, s, d = q.shape
    hkv = k.shape[1]
    causal, window = kw.get("causal", True), kw.get("window")
    fa_kernel = fa.flash_attention
    got = fa_kernel(q, k, v, causal=causal, window=window)
    want = plain_by_kv_head(torch, q, k, v, causal, window)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    row = float((diff.amax(-1) / want.float().abs().amax(-1).clamp_min(1e-30)).max())
    del got, want, diff
    ms = device_time_ms(torch, lambda: fa_kernel(q, k, v, causal=causal, window=window), iters,
                        warmup=1)
    if window is None:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            lib_ms = device_time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), iters, warmup=1)
        lib_note = ""
    else:
        lib_ms, lib_note = band_sdpa_ms(torch, q, k, v, window, iters)
    bound = bound_ms((2 * h + 2 * hkv) * b * s * d * q.element_size(),
                     4 * b * h * d * visible_pairs(s, causal, window), PEAK_BF16_FLOPS)
    shape = f"({b}, {h}, {hkv}, {s}, {d}) {str(q.dtype)[6:]} " + (
        "non-causal" if not causal else "causal" + (f" window {window}" if window else ""))
    print(f"[{phase}] {label}: the path's flash call {shape} vs attention_chunked: max abs err "
          f"{err:.3e} (limit {FLASH_BF16_ATOL:.3e}), max row-relative err {row:.3e} (limit "
          f"{FLASH_BF16_ROW_RTOL:.3e}); device time {ms:.4f} ms (CUDA events, {iters} calls), "
          "scaled_dot_product_attention " + ("refused" if lib_ms is None else f"{lib_ms:.4f} ms")
          + f"{lib_note}, bound {bound[0]:.4f} ms by {bound[1]}")
    if not (err < FLASH_BF16_ATOL and row < FLASH_BF16_ROW_RTOL):
        fail(f"{label}: the flash kernel at {shape} differs from attention_chunked by {err} "
             f"(row-relative {row})")
    return {"shape": shape, "family": label, "ms": ms, "library_ms": lib_ms,
            **({"library_call": lib_note.strip(" ()")} if lib_note else {}),
            "bound_ms": bound[0], "bound_by": bound[1], "max_abs_err": err,
            "max_row_rel_err": row}


def band_sdpa_ms(torch, q, k, v, window: int, iters: int):
    """SDPA's time for a causal sliding-window call: SDPA has no window, so
    the band (key j seen by query i where i - window < j <= i) goes in as
    an explicit additive mask (0 inside, -inf outside, in q's dtype, made
    beforehand), which only the memory-efficient backend takes (flash
    refuses masks).  Tried with ``enable_gqa=True`` first; if the card
    refuses that, with K and V repeated to the query heads beforehand
    (outside the timed call) -> (ms or None if both are refused, a note
    saying which call, what was refused and the output's largest
    difference from the kernel's)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops as fa

    s, g = q.shape[2], q.shape[1] // k.shape[1]
    i = torch.arange(s, device=q.device)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    mask = torch.zeros((s, s), dtype=q.dtype, device=q.device).masked_fill_(~band, -math.inf)
    del band
    note = f" (additive band mask {s} x {s}, memory-efficient backend"
    calls = [("enable_gqa", lambda: partial(F.scaled_dot_product_attention, q, k, v,
                                            attn_mask=mask, enable_gqa=True)),
             (f"K and V repeated {g}x to the query heads", lambda: partial(
                 F.scaled_dot_product_attention, q, k.repeat_interleave(g, dim=1),
                 v.repeat_interleave(g, dim=1), attn_mask=mask))]
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        for label, make in calls:
            try:
                call = make()
                out = call()
            except RuntimeError as e:  # no backend for it, or out of memory
                note += f"; {label} refused: {str(e).splitlines()[0][:200]}"
                continue
            diff = float((out.float() - fa.flash_attention(q, k, v, causal=True, window=window)
                          .float()).abs().max())
            del out
            ms = device_time_ms(torch, call, iters, warmup=1)
            return ms, note + f"; {label}; max abs difference from the kernel {diff:.3e})"
    return None, note + ")"


def main_path_run(torch, label, fn, want_launches: int, phase: str):
    """``fn()`` with the counters at 0 just before, inside ``FlashCalls``:
    the tensor-core route must launch ``want_launches`` times, the fp32
    route never -> (result, launches, the first flash call)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counters()
    t0 = time.perf_counter()
    with FlashCalls() as calls:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fp32 = fa.LAUNCHES["tensor_core"].value, fa.LAUNCHES["cuda_core"].value
    print(f"[{phase}] {label}: {wall:.3f} s wall, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; flash_attention launches: "
          f"tensor-core route {launches} (want {want_launches}), fp32 route {fp32}")
    if launches != want_launches or fp32:
        fail(f"{label}: flash launched {launches} (tensor-core) and {fp32} (fp32) times, want "
             f"{want_launches} and 0")
    return out, launches, calls.first


def _finite_logits(label, logits, shape) -> None:
    if tuple(logits.shape) != shape or not bool(logits.isfinite().all()):
        fail(f"{label}: logits {tuple(logits.shape)} are not finite {shape}")


def _depth_cut(cfg, params, n_layers):
    """The first ``n_layers`` blocks of ``cfg`` and ``params`` (the same
    tensors)."""
    return replace(cfg, n_layers=n_layers), {**params, "blocks": params["blocks"][:n_layers]}


def family_prefill_checks(torch, cfg, params, batch, cut_layers, phase: str):
    """The prefill_32k prompt at full depth through the kernel (the main
    path's launches counted), the path's first flash call held against the
    plain version at its own shape, and the whole-model kernel-vs-plain
    logits rule of phase 5 on a depth cut of ``cut_layers`` blocks (none
    if 0) -> (launches, the call's row of times)."""
    from repro_torch.models import build_model

    bundle = build_model(cfg)
    logits, launches, call = main_path_run(
        torch, f"{cfg.arch_id} prefill of {batch['tokens'].shape[1]} tokens"
        + (f" after {batch['patches'].shape[1]} patches" if "patches" in batch else "")
        + ", batch 1", lambda: bundle.prefill(params, batch), attention_calls(cfg), phase)
    _finite_logits(cfg.arch_id, logits, (1, 1, cfg.vocab))
    timed = None if call is None else flash_call_check(torch, cfg.arch_id, call, phase)
    del call
    if cut_layers:
        cut, p_cut = _depth_cut(cfg, params, cut_layers)
        print(f"[{phase}] {cfg.arch_id}: the kernel path against plain blocked attention on the "
              f"first {cut_layers} blocks")
        three_prefills(torch, cut, p_cut, batch, phase)
    return launches, timed


def phase_families(torch, rows, ended=lambda phase: None):
    """6c: granite-moe-3b-a800m, mamba2-1.3b and zamba2-1.2b at full width,
    one after another, each freed before the next."""
    import gc

    from repro_torch.configs import ARCHS

    param_counts(torch, FAMILY_ARCHS, "6c")
    moe_route_checks(torch)
    flash = rows["flash_attention"]
    flash["launches_phase_6c"] = {}
    for name in FAMILY_ARCHS:
        cfg = ARCHS[name]
        params = draw_params(torch, cfg, "6c")
        if cfg.family == "ssm":
            ssm_prefill_checks(torch, cfg, params)
        cut = 0 if cfg.family == "ssm" else FAMILY_FP32_LAYERS[name]
        flash["launches_phase_6c"][name], _ = family_prefill_checks(
            torch, cfg, params, {"tokens": _prompt(torch, cfg, _prefill_len())}, cut, "6c")
        family_serving(torch, cfg, params, FAMILY_FP32_LAYERS[name])
        del params
        gc.collect()
        torch.cuda.empty_cache()
        ended(f"6c {name}")


# ---------------------------------------------------------------------------
# phase 6d: the last LM families (VLM, windowed MoE, squared-ReLU dense,
# encoder-decoder) at full width
# ---------------------------------------------------------------------------
LAST_ARCHS = ("llava-next-mistral-7b", "mixtral-8x22b", "nemotron-4-340b", "whisper-large-v3")
# Depth served on one 80 GB card: mixtral's 56 blocks (282 GB) cut to 4
# (~21 GB with its embeddings), nemotron's 96 (682 GB) to 2 (~33 GB).
LAST_DEPTH = {"mixtral-8x22b": 4, "nemotron-4-340b": 2}
# (b) llava's whole-model kernel-vs-plain rule and its fp32 token cut.
LAST_CUT_LAYERS = 2
# (c) mixtral's rolling cache: a window shorter than the prompt, in fp32 on
# one block, teacher-forced decode against forward at the reference's
# 2e-3; no pair drops at capacity factor 8.
ROLLING_WINDOW = 16
ROLLING_LEN = 48
ROLLING_ATOL = 2e-3
# (e) whisper: the decoder's teacher-forced steps against decode_train.
WHISPER_FORCED_LEN = 16
WHISPER_FP32_LAYERS = 2
WHISPER_FP32_ATOL = 2e-3


def _prompt(torch, cfg, n: int, seed: int = 5):
    return torch.randint(0, cfg.vocab, (1, n), generator=torch.Generator().manual_seed(seed)).cuda()


def llava_checks(torch, cfg, params, timed) -> int:
    """(b) llava at full depth: the 32k prefill of 2,880 seeded patches and
    29,888 tokens (the kernel at D = 128 once a layer), its flash call held
    per call, the phase-5 rule on a two-block cut, and the patches moving
    the logits; every serving mode on phase 6's work."""
    from repro_torch.configs import SHAPES
    from repro_torch.models import build_model
    from repro_torch.models.zoo import input_specs

    specs = input_specs(cfg, SHAPES["prefill_32k"], batch_override=1)
    gen = torch.Generator().manual_seed(7)
    patches = torch.randn(specs["patches"][0], generator=gen).to("cuda", torch.bfloat16)
    batch = {"patches": patches, "tokens": _prompt(torch, cfg, specs["tokens"][0][1])}
    launches, row = family_prefill_checks(torch, cfg, params, batch, LAST_CUT_LAYERS, "6d")
    timed.append(row)
    bundle = build_model(cfg)
    base = bundle.prefill(params, batch)[0, -1]
    moved = bundle.prefill(params, {**batch, "patches": patches * 2.0 + 1.0})[0, -1]
    text = bundle.prefill(params, {"tokens": batch["tokens"]})[0, -1]
    d_moved, d_text = float((moved - base).abs().max()), float((text - base).abs().max())
    print(f"[6d] {cfg.arch_id}: last-position logits move by {d_moved:.4e} when the patches "
          f"change and by {d_text:.4e} without them")
    if not (d_moved > 1e-3 and d_text > 1e-3):
        fail(f"{cfg.arch_id}: the patches do not move the logits ({d_moved}, {d_text})")
    family_serving(torch, cfg, params, LAST_CUT_LAYERS, "6d")
    return launches


def rolling_cache_check(torch, cfg, params) -> None:
    """(c) The rolling cache against forward: one block in fp32 with a
    window of ROLLING_WINDOW over a ROLLING_LEN-token prompt (the cache a
    ring of ROLLING_WINDOW slots), capacity factor 8, teacher-forced."""
    from repro_torch.models import lm

    cut, p32 = _fp32_cut(torch, cfg, params, 1)
    cut = replace(_no_drops(cut), sliding_window=ROLLING_WINDOW)
    toks = _prompt(torch, cut, ROLLING_LEN, seed=8)
    full = lm.forward(p32, cut, {"tokens": toks})
    st = lm.init_decode_state(cut, 1, SERVE_CACHE_LEN, "cuda")
    outs = []
    for t in range(ROLLING_LEN):
        logits, st = lm.decode_step(p32, cut, st, toks[:, t : t + 1])
        outs.append(logits)
    d = float((torch.cat(outs, 1) - full).abs().max())
    print(f"[6d] {cfg.arch_id}: rolling-cache decode ({st.kv.k.shape[3]} slots, window "
          f"{ROLLING_WINDOW}, {ROLLING_LEN} tokens; fp32, one block) vs forward: max abs diff "
          f"{d:.4e} (bound {ROLLING_ATOL})")
    if st.kv.k.shape[3] != ROLLING_WINDOW or not d <= ROLLING_ATOL:
        fail(f"{cfg.arch_id}: rolling-cache decode differs from forward by {d}")
    del p32, full


def mixtral_checks(torch, cfg, params, timed) -> int:
    """(c) mixtral on a depth cut: the 32k prefill through the windowed
    kernel, its call held; paged refused where the window is below the
    cache; the rolling cache; every serving mode at cache_len 128."""
    from repro_torch.runtime.serve_loop import ServingEngine

    launches, row = family_prefill_checks(torch, cfg, params,
                                          {"tokens": _prompt(torch, cfg, _prefill_len())}, 0, "6d")
    timed.append(row)
    long_cache = 2 * cfg.sliding_window
    try:
        ServingEngine({cfg.arch_id: cfg}, mode="paged", cache_len=long_cache, device="cuda",
                      params={cfg.arch_id: params})
    except ValueError as e:
        print(f"[6d] {cfg.arch_id}: paged at cache_len {long_cache} refused: {e}")
    else:
        fail(f"{cfg.arch_id}: paged mode at cache_len {long_cache} was not refused")
    rolling_cache_check(torch, cfg, params)
    family_serving(torch, cfg, params, 0, "6d")
    return launches


def head_copy_check(torch, cfg, params) -> None:
    """(d) One B = 1 decode step's peak memory above its start: no fp32
    copy of the (vocab, d_model) head."""
    extra = decode_step_peak(torch, cfg, params, 1, SERVE_CACHE_LEN, "6d")
    copy = cfg.vocab * cfg.d_model * 4
    print(f"[6d] {cfg.arch_id}: an fp32 copy of the head would be {copy / 1e9:.1f} GB")
    if not extra < copy / 8:
        fail(f"{cfg.arch_id}: a decode step takes {extra} bytes, an fp32 head copy is {copy}")


def nemotron_checks(torch, cfg, params, timed) -> int:
    """(d) nemotron on a depth cut: the 32k prefill through the D = 192
    kernel, its call held; every serving mode; the decode step's memory."""
    launches, row = family_prefill_checks(torch, cfg, params,
                                          {"tokens": _prompt(torch, cfg, _prefill_len())}, 0, "6d")
    timed.append(row)
    head_copy_check(torch, cfg, params)
    family_serving(torch, cfg, params, 0, "6d")
    return launches


def _forced_rule(torch, label, got, ref, ctrl) -> None:
    """Teacher-forced logits ``got`` (S, V) against ``ref``: within
    PREFILL_DIFF_FACTOR times the control difference ``ctrl`` (the plain
    path's from ``ref``), argmaxes equal wherever ``ref``'s top-2 gap is at
    least twice it."""
    d, delta = float((got - ref).abs().max()), float((ctrl - ref).abs().max())
    top = torch.topk(ref.float(), 2, dim=-1).values
    gaps = top[:, 0] - top[:, 1]
    differ = got.argmax(-1) != ref.argmax(-1)
    print(f"[6d] {label}: max abs diff {d:.4e}, control (plain attention) {delta:.4e}; "
          f"{int(differ.sum())} of {ref.shape[0]} argmaxes differ, the smallest top-2 gap among "
          f"them {float(gaps[differ].min()) if differ.any() else float('nan'):.4e}")
    if not d <= PREFILL_DIFF_FACTOR * delta:
        fail(f"{label}: differs by {d}, more than {PREFILL_DIFF_FACTOR}x the control {delta}")
    if bool((differ & (gaps >= 2 * delta)).any()):
        fail(f"{label}: an argmax differs at a top-2 gap of at least 2 delta ({delta})")


def whisper_checks(torch, cfg, params, timed) -> int:
    """(e) whisper at full width: the encoder on 1,500 seeded frames (the
    kernel non-causal at a ragged length, once a layer), the decoder on the
    32k prompt (causal, once a layer; cross-attention plain), each path's
    flash call held; teacher-forced decode steps against decode_train in
    fp32 on a cut and by the top-2 rule in bf16; the engine's refusal."""
    from repro_torch.configs import SHAPES
    from repro_torch.models import build_model, encdec
    from repro_torch.models.zoo import input_specs
    from repro_torch.runtime.serve_loop import ServingEngine

    specs = input_specs(cfg, SHAPES["prefill_32k"], batch_override=1)
    frames = torch.randn(specs["frames"][0], generator=torch.Generator().manual_seed(7)).to(
        "cuda", torch.bfloat16)
    enc, n_enc, call = main_path_run(torch, f"{cfg.arch_id} encode of {frames.shape[1]} frames",
                                     lambda: encdec.encode(params, cfg, frames),
                                     cfg.n_encoder_layers, "6d")
    if enc.shape != frames.shape or not bool(enc.isfinite().all()):
        fail(f"{cfg.arch_id}: encoder output {tuple(enc.shape)} is not finite")
    timed.append(flash_call_check(torch, f"{cfg.arch_id} encoder", call, "6d"))
    tokens = _prompt(torch, cfg, specs["tokens"][0][1])
    logits, n_dec, call = main_path_run(
        torch, f"{cfg.arch_id} decode_train of {tokens.shape[1]} tokens",
        lambda: encdec.decode_train(params, cfg, tokens, enc), cfg.n_layers, "6d")
    _finite_logits(cfg.arch_id, logits, (1, tokens.shape[1], cfg.vocab))
    del logits
    timed.append(flash_call_check(torch, f"{cfg.arch_id} decoder", call, "6d"))
    del call, enc

    # Teacher-forced steps: fp32 on a cut, bf16 at full width.
    short = tokens[:, :WHISPER_FORCED_LEN]
    n = WHISPER_FP32_LAYERS
    cut = replace(cfg, n_layers=n, n_encoder_layers=n, param_dtype="float32",
                  compute_dtype="float32")
    p32 = _cast({**params, "enc_blocks": params["enc_blocks"][:n],
                 "dec_blocks": params["dec_blocks"][:n]}, torch.float32)
    for c, p, label in ((cut, p32, f"fp32, {n} + {n} layers"), (cfg, params, "bf16")):
        bundle = build_model(c)
        frames_c = frames.to(getattr(torch, c.compute_dtype))
        full = encdec.decode_train(p, c, short, encdec.encode(p, c, frames_c))[0]
        st = bundle.decode_init(p, {"frames": frames_c}, SERVE_CACHE_LEN)
        steps = []
        for t in range(short.shape[1]):
            step, st = bundle.decode_step(p, st, short[:, t : t + 1])
            steps.append(step[0])
        steps = torch.cat(steps)
        lbl = f"{cfg.arch_id} teacher-forced decode_step vs decode_train ({label})"
        if c is cut:
            d = float((steps - full).abs().max())
            print(f"[6d] {lbl}: max abs diff {d:.4e} (bound {WHISPER_FP32_ATOL})")
            if not d <= WHISPER_FP32_ATOL:
                fail(f"{lbl}: {d} > {WHISPER_FP32_ATOL}")
        else:
            plain = replace(c, attn_impl="chunked")
            ctrl = encdec.decode_train(p, plain, short, encdec.encode(p, plain, frames_c))[0]
            _forced_rule(torch, lbl, full, steps, ctrl)
    del p32
    try:
        ServingEngine({cfg.arch_id: cfg}, device="cuda", params={cfg.arch_id: params})
    except ValueError as e:
        print(f"[6d] {cfg.arch_id}: the serving engine refuses the family: {e}")
    else:
        fail(f"{cfg.arch_id}: the serving engine took the encoder-decoder")
    return n_enc + n_dec


def phase_last_families(torch, rows, ended=lambda phase: None):
    """6d: llava-next-mistral-7b, mixtral-8x22b, nemotron-4-340b and
    whisper-large-v3 at full width in bf16 (mixtral and nemotron on depth
    cuts), one after another, each freed before the next."""
    import gc

    from repro_torch.configs import ARCHS

    param_counts(torch, LAST_ARCHS, "6d")
    flash = rows["flash_attention"]
    flash["launches_phase_6d"], timed = {}, []
    checks = {"llava-next-mistral-7b": llava_checks, "mixtral-8x22b": mixtral_checks,
              "nemotron-4-340b": nemotron_checks, "whisper-large-v3": whisper_checks}
    for name in LAST_ARCHS:
        cfg = ARCHS[name]
        if name in LAST_DEPTH:
            cfg = replace(cfg, n_layers=LAST_DEPTH[name])
        params = draw_params(torch, cfg, "6d")
        flash["launches_phase_6d"][name] = checks[name](torch, cfg, params, timed)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        ended(f"6d {name}")
    flash["calls_phase_6d"] = timed


def phase_lm(torch, rows, ended=lambda phase: None):
    """Phases 5, 6 and 6b on one set of seeded full-width weights."""
    from repro_torch.models import build_model

    cfg = _lm_config()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cuda")
    phase_lm_prefill(torch, cfg, params, rows)
    ended("5 prefill")
    served = phase_lm_serving(torch, cfg, params)
    ended("6 serving")
    phase_lm_paged(torch, cfg, params, served)
    ended("6b paged and speculative")


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------
# (a) The reference's example run (examples/train_lm.py): smollm-360m at
# full width in bf16, seq 256 x batch 8, the default TrainRuntime (bf16
# moments, no master copy), the launcher's warmup (max(steps // 20, 5)).
TRAIN_ARCH = "smollm-360m"
TRAIN_STEPS = 30
TRAIN_SEQ_LEN = 256
TRAIN_BATCH = 8
TRAIN_TIMED = 20  # the step time is the median of the last 20 steps
# The Markov data is learnable: the mean loss of steps 26-30 must lie at
# least this far (nats) below that of steps 1-5.  From the initial ~10.8
# (ln 49,152) the unigram Zipf alone is worth ~5 nats.
LOSS_DROP = 0.5
# (b), (c), (f): smollm-360m at full widths, cut to two blocks.
TRAIN_CUT = 2
RESUME_STEPS = 6
RESUME_SPLIT = 3
# (c) in fp32: the card against the CPU on one batch of 2 x 256 tokens (the
# CPU's share of the run).  Two fp32 libraries sum in other orders: the
# loss within 1e-5 relative, each gradient leaf within 1e-4 of its largest
# CPU value (the CPU tests' bound against the reference).  Microbatches
# k = 2 against k = 1 on the card: the same sums split in two, 1e-5.
CUT_BATCH = 2
CPU_LOSS_RTOL = 1e-5
CPU_GRAD_RTOL = 1e-4
MICROBATCH_RTOL = 1e-5
# The head's product through matmul_f32 in bf16, (M, K) x (K, N) at
# smollm's width and a slice of its vocabulary, against the fp32 upcast:
# the forward within 1e-5 of the output's size (the same exact products
# summed in another order), each operand's gradient (an fp32 product cast
# to bf16, as autograd of the upcast computes) within one bf16 rounding.
HEAD_SHAPE = (64, 960, 4096)
HEAD_FWD_RTOL = 1e-5
HEAD_GRAD_RTOL = 2.0**-8
# (d) The reference test's least-squares problem on a two-entry mesh of
# the card, and its three bounds (tests/test_grad_compression.py).
EF_STEPS_AVG = 20
EF_STEPS_TRAIN = 100
EF_LR = 0.1
# (e) One loss-and-gradient step of every other family in bf16 on the depth
# cuts of phases 6c and 6d (whisper: 2 encoder + 2 decoder layers), batch 2
# of 64 tokens (llava's after its 2,880 patches, whisper's over its 1,500
# frames).
FAMILY_GRAD_CUTS = {"granite-moe-3b-a800m": 2, "mamba2-1.3b": 2, "zamba2-1.2b": 6,
                    "llava-next-mistral-7b": 2, "mixtral-8x22b": 4, "whisper-large-v3": 2}
FAMILY_GRAD_TOKENS = 64
FAMILY_GRAD_BATCH = 2
FAMILY_GRAD_LEFT_OUT = {
    "nemotron-4-340b": "two blocks hold 32.7 GB of bf16 weights and as much again of gradients, "
                       "and the head's backward upcasts the 18,432 x 256,000 unembedding to "
                       "fp32 (18.9 GB): 84 GB, more than the card's 80",
    "qwen2-0.5b": "dense, the family (a) trains; served at full width in phases 5-6",
    "phi4-mini-3.8b": "dense, the family (a) trains; no phase puts it on the card",
}


# What may stay allocated after 7a's trainers are dropped: far below the
# 2 GiB of state (and the graph's pool) that one kept alive would hold.
TRAINER_LEFT_BYTES = 2**29
# (g) The graph trainer against the eager step from the same state, steps
# each, under deterministic algorithms; besides smollm, the MoE dispatch
# (sort, searchsorted, scatter) and the chunked SSD under capture.
GRAPH_EAGER_STEPS = 6
GRAPH_EAGER_FAMILIES = ("granite-moe-3b-a800m", "mamba2-1.3b")


def _smollm_cut(dtype: str = "bfloat16"):
    from repro_torch.configs import ARCHS

    return replace(ARCHS[TRAIN_ARCH], n_layers=TRAIN_CUT, param_dtype=dtype, compute_dtype=dtype)


def _all_finite(tree) -> bool:
    from repro_torch.optim.tree import tree_leaves

    return all(bool(t.isfinite().all()) for t in tree_leaves(tree))


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def _clone_tree(tree):
    from repro_torch.optim.tree import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [t.clone() for t in tree_leaves(tree)])


def _timed_steps(torch, step_fn, steps):
    """``step_fn(step)`` for each step, each between two CUDA events ->
    (the metrics of each step, the ms of each step)."""
    metrics, events = [], []
    for step in steps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(step_fn(step))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return metrics, [s.elapsed_time(e) for s, e in events]


def train_full_width(torch, smi: str) -> dict:
    """(a) 30 steps of smollm-360m at full width through the launcher's
    trainer (one CUDA graph a step: the first step is the capture's eager
    warm-up, the other 29 replays): every loss and grad norm finite, the
    loss falling by LOSS_DROP; the step time from CUDA events, tokens/s and
    the peak memory above the start; then the functional (eager) step on a
    copy of the state, timed the same way; one replayed and one eager step
    under the profiler."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.launch.train import make_trainer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = make_trainer(ARCHS[TRAIN_ARCH], steps=TRAIN_STEPS, seq_len=TRAIN_SEQ_LEN,
                           batch=TRAIN_BATCH, device="cuda")
    torch.cuda.synchronize()
    state = torch.cuda.memory_allocated() - base
    init_s = time.perf_counter() - t0
    replays = build.counter(f"graph_replays {trainer.train_step.name}")
    replays.reset()
    t0 = time.perf_counter()
    metrics, ms_all = _timed_steps(torch, trainer.step, range(TRAIN_STEPS))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.memory_reserved()
    n_replays, captures = replays.value, int(trainer.train_step.captured)
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"7a: a loss or grad norm is not finite: {losses} {gnorms}")
    if not _all_finite(trainer.params):
        fail("7a: the trained parameters are not finite")
    ms = sorted(ms_all[-TRAIN_TIMED:])
    median = _median(ms)
    tokens = TRAIN_SEQ_LEN * TRAIN_BATCH
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    n_params = sum(t.numel() for t in _leaves(trainer.params))
    print(f"[7a] {TRAIN_ARCH} at full width ({n_params:,} parameters, bf16, moments bf16, no "
          f"master copy), seq {TRAIN_SEQ_LEN} x batch {TRAIN_BATCH}: {TRAIN_STEPS} steps in "
          f"{wall:.2f} s (init {init_s:.2f} s) through the launcher's graph trainer: captures "
          f"{captures}, replays {n_replays} (the first step is the capture's eager warm-up: "
          f"{ms_all[0]:.1f} ms with the capture); {smi}")
    if captures != 1 or n_replays != TRAIN_STEPS - 1:
        fail(f"7a: {captures} captures and {n_replays} replays for {TRAIN_STEPS} steps, want 1 "
             f"and {TRAIN_STEPS - 1}")
    print(f"[7a] losses {[round(x, 4) for x in losses]}")
    print(f"[7a] grad norms {[round(x, 3) for x in gnorms]}")
    print(f"[7a] mean loss of steps 1-5 {first:.4f}, of steps 26-30 {last:.4f}: fell "
          f"{first - last:.4f} nats (at least {LOSS_DROP})")
    if not first - last >= LOSS_DROP:
        fail(f"7a: the loss fell {first - last:.4f} nats, less than {LOSS_DROP}")
    print(f"[7a] replayed step time (CUDA events, median of the last {TRAIN_TIMED}) {median:.3f} "
          f"ms (min {ms[0]:.3f}, max {ms[-1]:.3f}); {tokens / median * 1e3:,.0f} tokens/s; "
          f"state (params, m, v) {state / 2**30:.3f} GiB, peak above the start "
          f"{peak / 2**30:.3f} GiB, reserved by the allocator {reserved / 2**30:.3f} GiB "
          f"(the graph's pool included); {smi}")
    out = {"step_ms": median, "tokens_per_s": tokens / median * 1e3, "peak_gib": peak / 2**30,
           "loss_first5": first, "loss_last5": last}
    train_step_parts(torch, trainer, smi)
    out["device_busy"] = profile_train_step(torch, "replayed",
                                            lambda: trainer.step(TRAIN_STEPS), smi)[0]
    eager = eager_train_steps(torch, trainer, smi)
    print(f"[7a] replayed against eager in this call: {median:.3f} against {eager['step_ms']:.3f} "
          f"ms a step ({eager['step_ms'] / median:.2f}x), {tokens / median * 1e3:,.0f} against "
          f"{tokens / eager['step_ms'] * 1e3:,.0f} tokens/s, peak {peak / 2**30:.3f} against "
          f"{eager['peak_gib']:.3f} GiB, busy {out['device_busy']:.1%} against "
          f"{eager['device_busy']:.1%}; {smi}")
    out.update({f"eager_{k}": v for k, v in eager.items()})
    del trainer, metrics
    return out


def eager_train_steps(torch, trainer, smi: str) -> dict:
    """The functional ``train_step`` of ``make_train_fns`` (eager, one
    PyTorch operation at a time) on a copy of ``trainer``'s state, on the
    batches after 7a's: TRAIN_TIMED + 1 steps, the median of the last
    TRAIN_TIMED, the peak above the start (the copy included) and one step
    under the profiler."""
    from repro_torch.runtime.train_loop import make_train_fns

    _, train_step = make_train_fns(trainer.cfg, trainer.rt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = [_clone_tree(trainer.params), _clone_tree(trainer.opt_state)]

    def step(i):
        state[0], state[1], m = train_step(state[0], state[1], trainer.batch(i))
        return m

    first = TRAIN_STEPS + 1
    _, ms = _timed_steps(torch, step, range(first, first + TRAIN_TIMED + 1))
    peak = torch.cuda.max_memory_allocated() - base
    ms = sorted(ms[-TRAIN_TIMED:])
    median = _median(ms)
    print(f"[7a] eager step (the functional train_step on a copy of the state, CUDA events, "
          f"median of the last {TRAIN_TIMED} of {TRAIN_TIMED + 1}) {median:.3f} ms (min "
          f"{ms[0]:.3f}, max {ms[-1]:.3f}); {TRAIN_SEQ_LEN * TRAIN_BATCH / median * 1e3:,.0f} "
          f"tokens/s; peak above the start {peak / 2**30:.3f} GiB; {smi}")
    busy = profile_train_step(torch, "eager", lambda: step(first + TRAIN_TIMED + 1), smi)[0]
    del state
    return {"step_ms": median, "peak_gib": peak / 2**30, "device_busy": busy}


def profile_train_step(torch, label: str, step, smi: str, phase: str = "7a"):
    """The device's busy share of one train step ``step()`` and its largest
    device operations, from ``torch.profiler`` with device activity only
    (an eager step issues ~16k device operations; host events too would
    cost tens of seconds to read back) -> (the busy share, the device ms,
    the NCCL operations among the device operations)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[{phase}] {label} train step under the profiler: {wall_ms:.1f} ms wall; device "
              f"time not measured (the profiler saw no device operations); {smi}")
        return float("nan"), float("nan"), 0
    by_name = Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    nccl = sum("nccl" in e.name.lower() for e in kernels)
    print(f"[{phase}] {label} train step under the profiler (device activity): {wall_ms:.1f} ms "
          f"wall, {len(kernels)} device operations ({nccl} NCCL), device time {busy_ms:.1f} ms: "
          f"busy {busy_ms / wall_ms:.1%}; {smi}; largest: "
          + "; ".join(f"{name[:80]} {t:.2f} ms" for name, t in by_name.most_common(5)))
    return busy_ms / wall_ms, busy_ms, nccl


def train_step_parts(torch, trainer, smi: str, repeats: int = 3) -> None:
    """Where a step's time goes, by the host's clock with the card
    synchronised between the parts: the batch (the Markov pipeline on the
    host), the loss and gradients (forward, remat's second forward,
    backward) and the AdamW update, each the same function the step runs
    (medians of ``repeats``)."""
    from repro_torch.optim.adamw import make_adamw
    from repro_torch.runtime.train_loop import make_grad_fn

    grad_fn = make_grad_fn(trainer.cfg, trainer.rt)
    _, update = make_adamw(trainer.rt.adamw)
    parts = {"batch": [], "loss and gradients": [], "AdamW update": []}
    for r in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = trainer.batch(TRAIN_STEPS + r)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, grads = grad_fn(trainer.params, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        update(grads, trainer.opt_state, trainer.params)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[name].append(dt * 1e3)
        del grads
    print("[7a] a step's parts (host clock, card synchronised, median of "
          f"{repeats}): " + "; ".join(f"{k} {sorted(v)[len(v) // 2]:.2f} ms"
                                      for k, v in parts.items()) + f"; {smi}")


def _trees_equal(torch, a, b) -> int:
    """Leaves of ``a`` and ``b`` that differ in any bit."""
    from repro_torch.optim.tree import tree_leaves

    return sum(not torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def train_resume(torch) -> None:
    """(b) 6 steps straight against 3 + save + restore into a fresh
    trainer + 3, through the launcher's ``run``, bf16 leaves on disk:
    parameters and optimizer state equal bit for bit under
    ``torch.use_deterministic_algorithms(True)``."""
    import tempfile

    from repro_torch.launch.train import make_trainer, run

    cut = _smollm_cut()
    kw = dict(steps=RESUME_STEPS, seq_len=TRAIN_SEQ_LEN, batch=TRAIN_BATCH, device="cuda")
    torch.use_deterministic_algorithms(True)
    try:
        straight = make_trainer(cut, **kw)
        run(straight, 0, RESUME_STEPS, log_every=RESUME_STEPS)
        first = make_trainer(cut, **kw)
        (REPO / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=REPO / "build") as d:
            path = str(Path(d) / "train.npz")
            t0 = time.perf_counter()
            run(first, 0, RESUME_SPLIT, checkpoint=path, checkpoint_every=RESUME_SPLIT,
                log_every=RESUME_SPLIT)
            save_s = time.perf_counter() - t0
            size = Path(path).stat().st_size
            resumed = make_trainer(cut, **kw)
            t0 = time.perf_counter()
            start = resumed.restore(path)
            restore_s = time.perf_counter() - t0
        if start != RESUME_SPLIT:
            fail(f"7b: restored step {start}, saved {RESUME_SPLIT}")
        run(resumed, start, RESUME_STEPS, log_every=RESUME_STEPS)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    bf16 = sum(t.dtype == torch.bfloat16 for t in _leaves(straight.params))
    unequal = (_trees_equal(torch, straight.params, resumed.params)
               + _trees_equal(torch, straight.opt_state, resumed.opt_state))
    print(f"[7b] {TRAIN_ARCH} cut to {TRAIN_CUT} blocks, {RESUME_STEPS} steps straight vs "
          f"{RESUME_SPLIT} + save + restore + {RESUME_STEPS - RESUME_SPLIT} (deterministic "
          f"algorithms): {bf16} bf16 parameter leaves; {size / 1e6:.1f} MB on disk, the 3 steps "
          f"and saves {save_s:.2f} s, restore {restore_s:.2f} s; {unequal} leaves of params and "
          "optimizer state differ (0 required)")
    if unequal:
        fail(f"7b: {unequal} leaves differ after the restart")


def _leaf_errors(torch, got, want):
    """Largest |got - want| of each leaf over the leaf's largest |want|."""
    from repro_torch.optim.tree import tree_leaves

    return [float((g.float().cpu() - w.float().cpu()).abs().max())
            / max(float(w.float().abs().max()), 1e-30)
            for g, w in zip(tree_leaves(got), tree_leaves(want))]


def train_cut_checks(torch) -> None:
    """(c) smollm-360m at full widths cut to two blocks in fp32: the card's
    loss and gradients against the CPU's on the same params and batch;
    microbatches 2 against 1 and remat on against off on the card; the
    head's product through matmul_f32 in bf16 against the fp32 upcast."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import microbatch, synthetic_lm_batch
    from repro_torch.models import build_model
    from repro_torch.models.layers import matmul_f32
    from repro_torch.optim.tree import tree_leaves, tree_map
    from repro_torch.runtime.train_loop import TrainRuntime, make_grad_fn

    cut = _smollm_cut("float32")
    params = build_model(cut).init(torch.Generator(device="cuda").manual_seed(1), "cuda")
    batch = synthetic_lm_batch(cut, ShapeConfig("7c", TRAIN_SEQ_LEN, CUT_BATCH, "train"), 0,
                               device="cuda")
    grad_fn = make_grad_fn(cut, TrainRuntime())
    loss, grads = grad_fn(params, batch)
    t0 = time.perf_counter()
    cpu = lambda t: t.cpu()  # noqa: E731
    loss_cpu, grads_cpu = grad_fn(tree_map(cpu, params), tree_map(cpu, batch))
    cpu_s = time.perf_counter() - t0
    loss_err = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    worst = max(_leaf_errors(torch, grads, grads_cpu))
    print(f"[7c] {TRAIN_ARCH} cut to {TRAIN_CUT} blocks in fp32, batch {CUT_BATCH} x "
          f"{TRAIN_SEQ_LEN}: loss card {float(loss):.7f} CPU {float(loss_cpu):.7f} (relative "
          f"{loss_err:.2e}, limit {CPU_LOSS_RTOL}); gradients: largest leaf error {worst:.2e} "
          f"of the leaf's size (limit {CPU_GRAD_RTOL}); the CPU took {cpu_s:.1f} s")
    if not (loss_err <= CPU_LOSS_RTOL and worst <= CPU_GRAD_RTOL):
        fail("7c: the card's loss or gradients leave the CPU's")
    loss2, grads2 = make_grad_fn(cut, TrainRuntime(microbatches=2))(params, microbatch(batch, 2))
    mb_loss = abs(float(loss2) - float(loss)) / abs(float(loss))
    mb_worst = max(_leaf_errors(torch, grads2, grads))
    print(f"[7c] microbatches 2 vs 1: loss relative {mb_loss:.2e}, largest gradient leaf error "
          f"{mb_worst:.2e} (limit {MICROBATCH_RTOL})")
    if not (mb_loss <= MICROBATCH_RTOL and mb_worst <= MICROBATCH_RTOL):
        fail("7c: microbatched gradients leave the whole batch's")
    # The embedding's backward accumulates rows in no fixed order unless
    # deterministic algorithms are on.
    torch.use_deterministic_algorithms(True)
    try:
        loss_on, grads_on = grad_fn(params, batch)
        loss_r, grads_r = make_grad_fn(replace(cut, remat=False), TrainRuntime())(params, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    unequal = _trees_equal(torch, grads_on, grads_r) + (not torch.equal(loss_on, loss_r))
    print(f"[7c] remat on vs off (deterministic algorithms): {unequal} of "
          f"{len(tree_leaves(grads)) + 1} loss and gradient leaves differ (0 required)")
    if unequal:
        fail("7c: remat changed the loss or the gradients")
    del params, grads, grads_cpu, grads2, grads_on, grads_r
    m, k, n = HEAD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(2)
    a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
    b = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    b.requires_grad_()
    cot = torch.randn((m, n), generator=gen, device="cuda")
    out = matmul_f32(a, b)
    ga, gb = torch.autograd.grad(out, (a, b), cot)
    a_up, b_up = a.detach().requires_grad_(), b.detach().requires_grad_()
    ref = a_up.float() @ b_up.float()
    ra, rb = torch.autograd.grad(ref, (a_up, b_up), cot)
    out, ref = out.detach(), ref.detach()
    fwd = float((out - ref).abs().max()) / float(ref.abs().max())
    errs = [float((x.float() - y.float()).abs().max()) / float(y.float().abs().max())
            for x, y in ((ga, ra), (gb, rb))]
    n_unequal = int((ga != ra).sum()) + int((gb != rb).sum())
    print(f"[7c] head product through matmul_f32 {HEAD_SHAPE} bf16 (cuBLAS out_dtype fp32) vs "
          f"the fp32 upcast: forward {fwd:.2e} of its size (limit {HEAD_FWD_RTOL}); gradients "
          f"{errs[0]:.2e}, {errs[1]:.2e} (limit {HEAD_GRAD_RTOL}), {n_unequal} of "
          f"{ga.numel() + gb.numel()} values unequal")
    if not (fwd <= HEAD_FWD_RTOL and max(errs) <= HEAD_GRAD_RTOL):
        fail("7c: matmul_f32's product or gradient leaves the fp32 upcast's")


def train_compression(torch) -> None:
    """(d) int8 error-feedback compression on a two-entry mesh of the card:
    the reference test's least-squares problem and its three bounds."""
    import numpy as np

    from repro_torch.optim.grad_compression import init_error_buffers, make_compressed_dp_grad_fn
    from repro_torch.optim.tree import value_and_grad
    from repro_torch.runtime.sharding import DataMesh

    rng = np.random.default_rng(0)
    dev = "cuda"
    w = torch.tensor(rng.normal(size=(16, 4)) * 0.1, dtype=torch.float32, device=dev)
    x = torch.tensor(rng.normal(size=(64, 16)), dtype=torch.float32, device=dev)
    w_true = torch.tensor(rng.normal(size=(16, 4)) * 0.5, dtype=torch.float32, device=dev)
    y = x @ w_true + 0.01 * torch.tensor(rng.normal(size=(64, 4)), dtype=torch.float32,
                                         device=dev)

    def loss_fn(w, batch):
        xx, yy = batch
        return torch.mean((xx @ w - yy) ** 2)

    grad_fn = make_compressed_dp_grad_fn(loss_fn, DataMesh(["cuda:0", "cuda:0"]))
    exact = value_and_grad(loss_fn, w, (x, y))[1]
    _, g_hat, _ = grad_fn(w, init_error_buffers(w), (x, y))
    rel1 = float(torch.linalg.norm(g_hat - exact) / torch.linalg.norm(exact))
    acc, err = torch.zeros_like(w), init_error_buffers(w)
    for _ in range(EF_STEPS_AVG):
        _, g_hat, err = grad_fn(w, err, (x, y))
        acc = acc + g_hat
    rel20 = float(torch.linalg.norm(acc / EF_STEPS_AVG - exact) / torch.linalg.norm(exact))
    w2, err = w, init_error_buffers(w)
    l0 = float(loss_fn(w2, (x, y)))
    for _ in range(EF_STEPS_TRAIN):
        _, g_hat, err = grad_fn(w2, err, (x, y))
        w2 = w2 - EF_LR * g_hat
    l1 = float(loss_fn(w2, (x, y)))
    print(f"[7d] int8 error feedback on a two-entry mesh of the card: one step {rel1:.4f} of the "
          f"exact gradient (limit 0.05); the mean of {EF_STEPS_AVG} {rel20:.4f} (limit rel1 + "
          f"0.01); least squares {l0:.4f} -> {l1:.4f} in {EF_STEPS_TRAIN} steps (limit half)")
    if not (rel1 < 0.05 and rel20 < rel1 + 0.01 and l1 < 0.5 * l0):
        fail("7d: compressed gradients miss the reference test's bounds")


def train_families(torch) -> None:
    """(e) One loss and gradient in bf16 for every family but dense, on
    phases 6c/6d's depth cuts: the loss finite, each parameter's gradient
    finite and not all zero (the MoE router's too, through the aux loss)."""
    import gc

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models import build_model
    from repro_torch.optim.tree import value_and_grad
    from repro_torch.runtime.train_loop import training_config

    for name, why in FAMILY_GRAD_LEFT_OUT.items():
        print(f"[7e] {name} left out: {why}")
    for name, n_layers in FAMILY_GRAD_CUTS.items():
        cfg = replace(ARCHS[name], n_layers=n_layers)
        if cfg.n_encoder_layers:
            cfg = replace(cfg, n_encoder_layers=n_layers)
        params = draw_params(torch, cfg, "7e")
        shape = ShapeConfig("7e", FAMILY_GRAD_TOKENS + cfg.n_patches, FAMILY_GRAD_BATCH, "train")
        batch = synthetic_lm_batch(cfg, shape, 0, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(build_model(training_config(cfg)).loss, params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        named = list(_named(grads))
        bad = [k for k, g in named if not bool(g.isfinite().all()) or not bool((g != 0).any())]
        router = [k for k, _ in named if k.endswith("router")]
        print(f"[7e] {name} ({cfg.family}, {n_layers} blocks"
              + (f" + {n_layers} encoder blocks" if cfg.n_encoder_layers else "")
              + f"), batch {tuple(batch['tokens'].shape)}: loss {float(loss):.4f}, "
              f"{len(named)} gradient leaves, {len(bad)} not finite or all zero, routers "
              f"{len(router)}; {wall:.2f} s, peak {peak:.2f} GiB above the weights")
        if not math.isfinite(float(loss)) or bad:
            fail(f"7e: {name}: loss {float(loss)}, gradients not finite or all zero: {bad[:8]}")
        del params, grads, batch
        gc.collect()
        torch.cuda.empty_cache()


def train_refusal(torch) -> None:
    """(f) A loss taken through the flash kernel under autograd raises the
    kernel's refusal."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models import build_model
    from repro_torch.optim.tree import value_and_grad

    cut = replace(_smollm_cut(), attn_impl="kernel")
    params = build_model(cut).init(torch.Generator(device="cuda").manual_seed(3), "cuda")
    batch = synthetic_lm_batch(cut, ShapeConfig("7f", TRAIN_SEQ_LEN, 1, "train"), 0,
                               device="cuda")
    try:
        value_and_grad(build_model(cut).loss, params, batch)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        print(f"[7f] a loss through attn_impl='kernel' under autograd refused: {e}")
        return
    fail("7f: the flash kernel ran under autograd")


def graph_vs_eager(torch, label: str, cfg, microbatches: int, smi: str) -> None:
    """(g) GRAPH_EAGER_STEPS steps through the launcher's graph trainer
    against the functional eager ``train_step`` from a copy of the same
    initial state, on the same batches, under deterministic algorithms
    (on at the capture too): unequal values of the metrics each step and of
    the state after, 0 required."""
    import gc

    from repro_torch.launch.train import make_trainer
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime.train_loop import make_train_fns

    torch.use_deterministic_algorithms(True)
    try:
        trainer = make_trainer(cfg, steps=TRAIN_STEPS, seq_len=TRAIN_SEQ_LEN, batch=TRAIN_BATCH,
                               microbatches=microbatches, device="cuda")
        _, train_step = make_train_fns(trainer.cfg, trainer.rt)
        params, opt = _clone_tree(trainer.params), _clone_tree(trainer.opt_state)
        unequal, n_values = Counter(), Counter()
        for step in range(GRAPH_EAGER_STEPS):
            batch = trainer.batch(step)
            got = trainer.train_step(batch)
            params, opt, want = train_step(params, opt, batch)
            for key in ("loss", "lr", "grad_norm"):
                unequal[key] += int(not torch.equal(got[key], want[key]))
                n_values[key] += 1
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    st = trainer.opt_state
    for key, a, b in (("params", trainer.params, params), ("m", st.m, opt.m), ("v", st.v, opt.v),
                      ("master", st.master, opt.master), ("step", st.step, opt.step)):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            unequal[key] += int((x != y).sum())
            n_values[key] += x.numel()
    print(f"[7g] {label}, seq {TRAIN_SEQ_LEN} x batch {TRAIN_BATCH}, microbatches "
          f"{microbatches}: {GRAPH_EAGER_STEPS} steps through the graph trainer (captured "
          f"{trainer.train_step.captured}) against the eager functional step, deterministic "
          f"algorithms: unequal values "
          + ", ".join(f"{k} {unequal[k]} of {n_values[k]:,}" for k in n_values)
          + f" (0 required); {smi}")
    if not trainer.train_step.captured or any(unequal.values()):
        fail(f"7g: {label}: the graph trainer differs from the eager step: {dict(unequal)}")
    del trainer, params, opt
    gc.collect()
    torch.cuda.empty_cache()


def train_graph_checks(torch, smi: str) -> None:
    """(g) the graph trainer against the eager step, bit for bit, at full
    width, on the cut with microbatches 2, and on an MoE and an SSM cut."""
    from repro_torch.configs import ARCHS

    graph_vs_eager(torch, f"{TRAIN_ARCH} at full width", ARCHS[TRAIN_ARCH], 1, smi)
    graph_vs_eager(torch, f"{TRAIN_ARCH} cut to {TRAIN_CUT} blocks", _smollm_cut(), 2, smi)
    for name in GRAPH_EAGER_FAMILIES:
        graph_vs_eager(torch, f"{name} cut to {TRAIN_CUT} blocks",
                       replace(ARCHS[name], n_layers=TRAIN_CUT), 1, smi)


def phase_training(torch, smi: str, ended=lambda phase: None) -> dict:
    """7: training, (a)-(g); no kernel of the port may launch (the graph
    trainers' replays and the MoE tallies are counted apart)."""
    from repro_torch.kernels import build

    import gc

    build.reset_counters()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = train_full_width(torch, smi)
    # Dropping a trainer frees its state and its graph's private pool.
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - before
    print(f"[7a] the trainers dropped: {left / 2**20:.1f} MiB left allocated above the phase's "
          f"start, {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved after empty_cache")
    if left > TRAINER_LEFT_BYTES:
        fail(f"7a: {left / 2**30:.3f} GiB stay allocated after the trainers were dropped")
    ended("7a full width")
    train_resume(torch)
    train_cut_checks(torch)
    train_compression(torch)
    ended("7b-d resume, cut, compression")
    train_families(torch)
    ended("7e families")
    train_refusal(torch)
    train_graph_checks(torch, smi)
    ended("7f-g refusal, graph against eager")
    counts = {n: c.value for n, c in build.COUNTERS.items() if c.value}
    replays = {n: v for n, v in counts.items() if n.startswith("graph_replays ")}
    tallies = {n: v for n, v in counts.items() if n in build.TALLIES}
    launched = build.launches()
    print(f"[7] kernel launches during training: {launched or 'none'} (the path takes the plain "
          f"blocked attention); graph replays {replays}; tallies {tallies}")
    if launched:
        fail(f"7: training launched kernels {launched}")
    return out


# ---------------------------------------------------------------------------
# phase 8: the sharded steps on a DeviceMesh of the card, and the dry-run
# ---------------------------------------------------------------------------
# (a) smollm-360m's sharded train step at phase 7's shape, 2 eager steps a
# policy; (a') its graph, 4 steps a policy held bit for bit (1 capture, 3
# replays), then 6 replays back to back, timed as phase 7a's loop is (the
# replayed step time is the median of the last 5: the first follows the
# checks' synchronisation, so the host's batch cannot overlap a replay).
SHARD_TRAIN_STEPS = 2
SHARD_GRAPH_STEPS = 4
SHARD_GRAPH_TIMED = 6
# (c) qwen2-0.5b's decode_32k with the global batch cut from 128 to 8, eager
# and (c') as a graph (1 capture, 7 replays); the unsharded B = 8 decode
# graph at that cache replayed SHARD_DECODE_STEPS times beside them.
SHARD_DECODE_BATCH = 8
SHARD_DECODE_STEPS = 8
# (d) the dry-run cells, each in a subprocess of its own on 256 fake ranks.
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k"))
# (e) the estimates against the card: the dry-run's peak of live bytes of
# smollm-360m's step on one fake rank over the card's peak above the start
# (phase 7a), and the counted flops over 8 N T (6 N T, and remat's second
# forward of the blocks, 2 N T).  The peak counts exact tensor bytes; the
# card's caching allocator rounds each block up, keeps freed blocks in its
# pools and holds cuBLAS's workspace (9.44 GiB estimated against 10.23 GiB
# measured on an NVIDIA H100 80GB HBM3 at 700 W).  The flops miss 2 V d T
# of N's share (the tied head is not recomputed: -3.3%) and add the
# attention's products (+2.2%): 0.962 x 8 N T.
MEM_ESTIMATE_BOUNDS = (0.8, 1.2)
FLOP_ESTIMATE_BOUNDS = (0.9, 1.1)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dryrun_commands(out_dir: Path):
    """(label, argv, json) of the dry-run cells of (d) and the estimate of
    (e)."""
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", str(out_dir)]
    cmds = [(f"{a} {s}", base + ["--arch", a, "--shape", s, "--mesh", "single"],
             out_dir / f"{a}__{s}__single.json") for a, s in DRYRUN_CELLS]
    cmds.append(("estimate", base + ["--arch", TRAIN_ARCH, "--shape", "train_4k", "--mesh",
                                     "one", "--seq-len", str(TRAIN_SEQ_LEN), "--batch",
                                     str(TRAIN_BATCH)],
                 out_dir / f"{TRAIN_ARCH}__train_4k_{TRAIN_SEQ_LEN}x{TRAIN_BATCH}__one.json"))
    return cmds


def _start_dryruns():
    """Start every dry-run subprocess at once (they trace on the host while
    the card runs (a)-(c)) -> [(label, process, json path)]."""
    out_dir = REPO / "results" / "dryrun_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return [(label, subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True, env=env, cwd=REPO), path)
            for label, argv, path in _dryrun_commands(out_dir)]


def _wait_dryruns(procs, timeout: float = 600) -> dict:
    out = {}
    for label, proc, path in procs:
        try:
            log, _ = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode != 0 or not path.exists():
            fail(f"8d: the dry-run of {label} exited {proc.returncode}: {log[-2000:]}")
        out[label] = json.loads(path.read_text())
    return out


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _timed_call(torch, fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _sharded_steps(torch, step_fn, steps, want_metrics):
    """``step_fn(step)`` for each step, timed by ``_timed_steps`` -> (the
    ms of each step, the metrics unequal to ``want_metrics``' in any bit)."""
    metrics, ms = _timed_steps(torch, step_fn, steps)
    unequal = sum(int(not torch.equal(m[key], want_metrics[i][key]))
                  for i, m in enumerate(metrics) for key in ("loss", "grad_norm", "lr"))
    return ms, unequal


def _unequal_leaves(torch, got, want) -> int:
    return sum(int(not torch.equal(_local(a), b)) for a, b in zip(got, want))


def shard_train_checks(torch, mesh, smi: str, phase7: dict) -> dict:
    """(a) smollm-360m at phase 7's shape through ``shard_train_step`` on
    the (1, 1) mesh under the pure-DP and the TP policy, SHARD_TRAIN_STEPS
    eager steps each, then (a') the same steps as one CUDA graph over the
    donated placed state (``graph_train_step``; the pure-DP one through the
    launcher's ``make_sharded_trainer``), SHARD_GRAPH_STEPS steps each (one
    capture, then replays), all from the unsharded step's parameters and
    batches: loss, grad norm, lr, parameters and AdamW state bit for bit
    against the functional (eager) unsharded step (deterministic
    algorithms), and so against each other; the step times beside the
    unsharded step's (DTensor's host cost) and phase 7a's replay."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.train import make_trainer
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime.sharding import make_policy
    from repro_torch.runtime.train_loop import make_train_fns, shard_train_step

    # Deterministic algorithms pick the kernels; the NaN fill of every new
    # tensor that comes with them (~8k device operations and ~13 ms a
    # replayed step) changes no value that a step computes, and is off, so
    # that the replays compare with phase 7a's.
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        trainer = make_trainer(ARCHS[TRAIN_ARCH], steps=TRAIN_STEPS, seq_len=TRAIN_SEQ_LEN,
                               batch=TRAIN_BATCH, device="cuda")
        _, train_step = make_train_fns(trainer.cfg, trainer.rt)
        p0, o0 = _clone_tree(trainer.params), _clone_tree(trainer.opt_state)
        p1, o1 = _clone_tree(p0), _clone_tree(o0)
        ref, ref_ms, want_eager = [], [], None
        for step in range(SHARD_GRAPH_STEPS):
            (p1, o1, m), ms = _timed_call(torch, lambda: train_step(p1, o1, trainer.batch(step)))
            ref.append(m)
            ref_ms.append(ms)
            if step + 1 == SHARD_TRAIN_STEPS:
                want_eager = _clone_tree(tree_leaves((p1, o1)))
        want = tree_leaves((p1, o1))
        n_el = sum(t.numel() for t in want)
        out = {"unsharded_ms": _median(ref_ms[1:])}
        for layout in ("dp", "tp"):
            policy = make_policy(mesh, pure_dp=layout == "dp")
            label = "pure-DP" if layout == "dp" else "TP"
            fn, _ = shard_train_step(trainer.cfg, trainer.shape, policy, trainer.rt)
            params, opt = fn.place(_clone_tree(p0), _clone_tree(o0))

            def eager(step):
                return fn(params, opt, trainer.batch(step))[2]

            ms_all, unequal_metrics = _sharded_steps(torch, eager, range(SHARD_TRAIN_STEPS), ref)
            bad = _unequal_leaves(torch, tree_leaves((params, opt)), want_eager)
            # The first step fills DTensor's caches of sharding propagation.
            ms_all = ms_all[1:]
            print(f"[8a] {TRAIN_ARCH} seq {TRAIN_SEQ_LEN} x batch {TRAIN_BATCH}, {label} policy "
                  f"on the (1, 1) mesh, eager: {SHARD_TRAIN_STEPS} steps; metrics unequal "
                  f"{unequal_metrics}, leaves of params + AdamW state unequal {bad} of "
                  f"{len(want)} ({n_el:,} elements); step {_median(ms_all):.1f} ms (CUDA events, "
                  f"median of the last {len(ms_all)}) against the unsharded eager step's "
                  f"{out['unsharded_ms']:.1f} ms here and phase 7a's {phase7['eager_step_ms']:.1f} "
                  f"ms; {smi}")
            if bad or unequal_metrics:
                fail(f"8a: the sharded train step ({layout}) differs from the unsharded one: "
                     f"{bad} leaves, {unequal_metrics} metrics")
            out[f"{layout}_ms"] = _median(ms_all)
            # The eager step's state is freed before the capture.
            del params, opt, fn, eager
            out[f"graph_{layout}_ms"] = graph_train_checks(
                torch, trainer, layout, mesh, p0, o0, ref, want_eager, want, out, phase7, smi)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    host_ms = max(out["dp_ms"], out["tp_ms"]) - out["unsharded_ms"]
    print(f"[8a] DTensor's host cost: {out['dp_ms'] - out['unsharded_ms']:.1f} ms (pure DP) and "
          f"{out['tp_ms'] - out['unsharded_ms']:.1f} ms (TP) a step over the unsharded "
          f"{out['unsharded_ms']:.1f} ms; under the graph {out['graph_dp_ms']:.3f} / "
          f"{out['graph_tp_ms']:.3f} ms a replayed step against phase 7a's unsharded replay "
          f"{phase7['step_ms']:.3f} ms; {smi}")
    out["host_cost_ms"] = host_ms
    del trainer, p0, o0, p1, o1, ref, want, want_eager
    return out


def graph_train_checks(torch, trainer, layout, mesh, p0, o0, ref, want_eager, want, out,
                       phase7, smi) -> float:
    """(a') one policy's graph step: SHARD_GRAPH_STEPS steps from (p0, o0)
    on ``trainer``'s batches, 1 capture and the rest replays, held bit for
    bit as (a) is; the pure-DP one is the launcher's sharded trainer
    (``make_sharded_trainer`` on a host mesh of the group, its state set by
    ``load``), whose one replayed step is also profiled -> the median ms
    of the replays."""
    import gc

    from repro_torch.kernels import build
    from repro_torch.launch.train import make_sharded_trainer
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime.sharding import make_policy
    from repro_torch.runtime.train_loop import GraphShardedStep, graph_train_step, shard_train_step

    label = "pure-DP" if layout == "dp" else "TP"
    if layout == "dp":
        launcher = make_sharded_trainer(trainer.cfg, steps=TRAIN_STEPS, seq_len=TRAIN_SEQ_LEN,
                                        batch=TRAIN_BATCH, device="cuda")
        step = launcher.train_step
        if not isinstance(step, GraphShardedStep):
            fail(f"8a': the launcher's sharded trainer steps through {type(step).__name__}")
        step.load(p0, o0)
        run = launcher.step
        via = "the launcher's make_sharded_trainer"
    else:
        fn, _ = shard_train_step(trainer.cfg, trainer.shape, make_policy(mesh), trainer.rt)
        step = graph_train_step(fn, _clone_tree(p0), _clone_tree(o0),
                                name=f"train step sharded tp {TRAIN_ARCH}")
        launcher = None
        via = "graph_train_step"

        def run(i):
            return step(trainer.batch(i))

    replays = build.counter(f"graph_replays {step.name}")
    replays.reset()
    leaves = tree_leaves(step.args)
    ptrs = [_local(t).data_ptr() for t in leaves]
    ms_all, unequal_metrics = _sharded_steps(torch, run, range(SHARD_TRAIN_STEPS), ref)
    bad_eager = _unequal_leaves(torch, leaves, want_eager)
    ms_rest, unequal_rest = _sharded_steps(torch, run, range(SHARD_TRAIN_STEPS, SHARD_GRAPH_STEPS),
                                           ref[SHARD_TRAIN_STEPS:])
    ms_all += ms_rest
    unequal_metrics += unequal_rest
    bad = _unequal_leaves(torch, leaves, want)
    moved = sum(int(_local(t).data_ptr() != p) for t, p in zip(leaves, ptrs))
    held = replays.value
    end = SHARD_GRAPH_STEPS + SHARD_GRAPH_TIMED
    _, ms_timed = _timed_steps(torch, run, range(SHARD_GRAPH_STEPS, end))
    ms_timed = sorted(ms_timed[1:])
    median = _median(ms_timed)
    print(f"[8a'] {TRAIN_ARCH}, {label} policy on the (1, 1) mesh as one CUDA graph over donated "
          f"DTensor state ({via}): "
          f"captures {int(step.captured)}, replays {held} in {SHARD_GRAPH_STEPS} steps; "
          f"metrics unequal {unequal_metrics}; leaves unequal after step {SHARD_TRAIN_STEPS} "
          f"(= the eager sharded step's state) {bad_eager}, after step {SHARD_GRAPH_STEPS} "
          f"{bad} of {len(want)}; leaves moved {moved}; the first step with its capture "
          f"{ms_all[0]:.1f} ms, the checked replays {[round(x, 3) for x in ms_all[1:]]} ms; "
          f"replayed step {median:.3f} ms (CUDA events, median of the last "
          f"{len(ms_timed)} of {SHARD_GRAPH_TIMED} replays back to back; min {ms_timed[0]:.3f}, "
          f"max {ms_timed[-1]:.3f}) against the eager sharded {out[layout + '_ms']:.1f} ms and "
          f"phase 7a's unsharded replay {phase7['step_ms']:.3f} ms; {smi}")
    if not step.captured or held != SHARD_GRAPH_STEPS - 1:
        fail(f"8a': {label}: captured {step.captured}, {held} replays for "
             f"{SHARD_GRAPH_STEPS} steps")
    if bad or bad_eager or unequal_metrics or moved:
        fail(f"8a': the {label} graph step differs: {bad_eager} / {bad} leaves, "
             f"{unequal_metrics} metrics, {moved} leaves moved")
    if launcher is not None:
        busy, device_ms, nccl = profile_train_step(
            torch, "sharded replayed", lambda: run(end), smi, phase="8a'")
        print(f"[8a'] device time over the replayed step: {device_ms / median:.1%} across the "
              f"loop ({device_ms:.1f} / {median:.3f} ms), {busy:.1%} for the lone profiled step; "
              f"NCCL operations in a replay: {nccl} (a one-rank mesh leaves every placement "
              f"trivial); {smi}")
        out.update(graph_dp_busy=busy, graph_dp_loop_busy=device_ms / median)
    del step, launcher, run, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return median


def shard_serve_checks(torch, mesh, smi: str) -> dict:
    """(b) qwen2-0.5b's ``shard_prefill_step`` at prefill_32k (batch cut
    to 1) on the (1, 1) mesh: the logits bit for bit against the unsharded
    prefill, the flash kernel launched once a layer through ``local_map``;
    (b') the same step as one CUDA graph over the placed parameters
    (``graph_prefill_step``): a replay's logits bit for bit, one flash
    launch a layer a replay.  (c) ``shard_decode_step`` at decode_32k
    (batch cut to 8), 8 steps from an empty cache: logits and state bit
    for bit against ``lm.decode_step``; the tied head takes
    ``matmul_f32``'s card route on DTensors; (c') the same 8 steps as one
    graph over the donated placed state (``graph_decode_step``), held the
    same way, the state written in place, its step time beside the eager
    one's and the unsharded B = 8 decode graph's at that cache."""
    import gc

    from repro_torch.configs import SHAPES
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import build_model, lm
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime.serve_loop import (
        DecodeGraph,
        graph_decode_step,
        graph_prefill_step,
        shard_decode_step,
        shard_prefill_step,
    )
    from repro_torch.runtime.sharding import choose_policy, place_tree

    cfg = _lm_config()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), "cuda")
    s = _prefill_len()
    tokens = torch.randint(0, cfg.vocab, (1, s), generator=torch.Generator().manual_seed(5)).cuda()
    shape = SHAPES["prefill_32k"]
    policy = choose_policy(cfg, shape, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = bundle.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    fn, _ = shard_prefill_step(cfg, shape, policy)
    placed = fn.place(params, {"tokens": tokens})
    fn(*placed)  # once, so the wall below is not DTensor's first-call caching
    torch.cuda.synchronize()
    build.reset_counters()
    t0 = time.perf_counter()
    got = fn(*placed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fp32 = fa.LAUNCHES["tensor_core"].value, fa.LAUNCHES["cuda_core"].value
    same = torch.equal(_local(got), want)
    print(f"[8b] {cfg.arch_id} shard_prefill_step, prefill_32k with the global batch cut from "
          f"{shape.global_batch} to 1, {policy.model_axis and 'TP' or 'pure-DP'} policy on the "
          f"(1, 1) mesh: {wall:.3f} s wall (the unsharded prefill: {plain_wall:.3f} s); "
          f"logits equal the unsharded prefill's bit for bit: {same}; flash "
          f"launches: tensor-core route {launches} (want {cfg.n_layers}), fp32 route {fp32}; "
          f"{smi}")
    if not same or launches != cfg.n_layers or fp32:
        fail(f"8b: sharded prefill equal={same}, launches {launches}/{fp32}")
    del placed, got
    out = {"prefill_s": wall, "prefill_unsharded_s": plain_wall}

    gp = graph_prefill_step(fn, params, name=f"prefill sharded {cfg.arch_id}")
    first = gp({"tokens": tokens})
    same_first = torch.equal(_local(first), want)
    del first
    torch.cuda.synchronize()
    build.reset_counters()
    t0 = time.perf_counter()
    got = gp({"tokens": tokens})
    torch.cuda.synchronize()
    gwall = time.perf_counter() - t0
    launches, fp32 = fa.LAUNCHES["tensor_core"].value, fa.LAUNCHES["cuda_core"].value
    replays = build.counter(f"graph_replays {gp.name}").value
    same = torch.equal(_local(got), want)
    print(f"[8b'] {cfg.arch_id} graph_prefill_step, the same prompt as one CUDA graph over the "
          f"placed parameters: captured {gp.captured}, one replay {gwall:.3f} s wall against the "
          f"eager sharded {wall:.3f} s and the unsharded {plain_wall:.3f} s; logits equal the "
          f"unsharded prefill's bit for bit: capture's warm-up {same_first}, replay {same}; flash "
          f"launches in the replay: tensor-core route {launches} (want {cfg.n_layers}), fp32 "
          f"route {fp32}; {smi}")
    if not (gp.captured and same_first and same) or replays != 1:
        fail(f"8b': graphed prefill captured={gp.captured} equal={same_first}/{same}, "
             f"{replays} replays")
    if launches != cfg.n_layers or fp32:
        fail(f"8b': {launches}/{fp32} flash launches in a replay, want {cfg.n_layers}/0")
    out["prefill_graph_s"] = gwall
    del gp, got, want
    gc.collect()
    torch.cuda.empty_cache()

    dshape = replace(SHAPES["decode_32k"], global_batch=SHARD_DECODE_BATCH)
    dpolicy = choose_policy(cfg, dshape, mesh)
    dfn, _ = shard_decode_step(cfg, dshape, dpolicy)
    dparams = place_tree(params, dfn.in_shardings[0])
    ref = lm.init_decode_state(cfg, SHARD_DECODE_BATCH, dshape.seq_len, "cuda")
    state = lm.init_decode_state(cfg, SHARD_DECODE_BATCH, dshape.seq_len, "cuda")
    gen = torch.Generator().manual_seed(9)
    steps = [torch.randint(0, cfg.vocab, (SHARD_DECODE_BATCH, 1), generator=gen).cuda()
             for _ in range(SHARD_DECODE_STEPS)]
    unequal, ms_all, ref_ms, wants = 0, [], [], []
    for nt in steps:
        (want, ref), ms_ref = _timed_call(torch, lambda: lm.decode_step(params, cfg, ref, nt))
        (got, state), ms = _timed_call(torch, lambda: dfn(dparams, state, {"tokens": nt}))
        unequal += int(not torch.equal(_local(got), want))
        ms_all.append(ms)
        ref_ms.append(ms_ref)
        wants.append(want)
    bad = sum(int(not torch.equal(_local(a), b))
              for a, b in zip(tree_leaves(state), tree_leaves(ref)))
    print(f"[8c] {cfg.arch_id} shard_decode_step, decode_32k with the global batch cut from "
          f"128 to {SHARD_DECODE_BATCH}, {SHARD_DECODE_STEPS} steps from an empty cache: "
          f"logits unequal in {unequal} steps, state leaves unequal {bad} of "
          f"{len(tree_leaves(ref))}; step {_median(ms_all):.2f} ms against the unsharded "
          f"eager step's {_median(ref_ms):.2f} ms (CUDA events, medians); {smi}")
    if unequal or bad:
        fail(f"8c: the sharded decode differs: {unequal} logits, {bad} state leaves")
    out.update(decode_ms=_median(ms_all), decode_unsharded_ms=_median(ref_ms))
    del dparams, state, got

    gd = graph_decode_step(dfn, params, lm.init_decode_state(
        cfg, SHARD_DECODE_BATCH, dshape.seq_len, "cuda"), name=f"decode sharded {cfg.arch_id}")
    held = tree_leaves(gd.args[1])
    ptrs = [_local(t).data_ptr() for t in held]
    got_all, gms = _timed_steps(torch, lambda i: gd({"tokens": steps[i]}), range(len(steps)))
    unequal = sum(int(not torch.equal(_local(g), w)) for g, w in zip(got_all, wants))
    bad = _unequal_leaves(torch, held, tree_leaves(ref))
    moved = sum(int(_local(t).data_ptr() != p) for t, p in zip(held, ptrs))
    replays = build.counter(f"graph_replays {gd.name}").value
    del gd, held, got_all
    gc.collect()
    torch.cuda.empty_cache()
    dg = DecodeGraph(bundle, params, SHARD_DECODE_BATCH, dshape.seq_len,
                     name=f"decode B={SHARD_DECODE_BATCH} {dshape.seq_len}")
    _, ums = _timed_steps(torch, lambda i: dg(steps[i]), range(len(steps)))
    del dg
    print(f"[8c'] {cfg.arch_id} graph_decode_step, the same {SHARD_DECODE_STEPS} steps as one "
          f"CUDA graph over the donated placed state: replays {replays}; logits unequal in "
          f"{unequal} steps, state leaves unequal {bad} of {len(tree_leaves(ref))}, leaves moved "
          f"{moved}; replayed step {_median(gms[1:]):.3f} ms (CUDA events, median of "
          f"{len(gms) - 1}; the first with its capture {gms[0]:.1f} ms) against the eager "
          f"sharded {out['decode_ms']:.2f} ms and the unsharded B = {SHARD_DECODE_BATCH} decode "
          f"graph's replay at the same cache {_median(ums[1:]):.3f} ms; {smi}")
    if unequal or bad or moved or replays != SHARD_DECODE_STEPS - 1:
        fail(f"8c': the graphed sharded decode differs: {unequal} logits, {bad} state leaves, "
             f"{moved} moved, {replays} replays")
    out.update(decode_graph_ms=_median(gms[1:]), decode_unsharded_graph_ms=_median(ums[1:]))
    del params, ref, wants
    return out


def collective_capture_check(torch, mesh, smi: str) -> None:
    """(g) The clip's all-reduce (``funcol.all_reduce`` over the mesh
    flattened to one dim, as ``optim.adamw`` issues it on a mesh of more
    ranks) captured in a ``StaticGraph`` on the group of one rank: the
    capture goes through ProcessGroupNCCL (its work, events and watchdog)
    and the replay equals the eager result.  The only collective the card
    can run under capture: the (1, 1) mesh's steps hold none, and on one
    rank NCCL's all-reduce itself is a device copy (the replay's device
    operations are printed)."""
    import torch.distributed._functional_collectives as funcol
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.graphs import StaticGraph
    from repro_torch.optim.adamw import _whole_mesh

    whole = mesh._flatten()
    if _whole_mesh(mesh) is not whole:
        fail("8g: the clip's flattened mesh is not the cached one")
    x = torch.randn(4096, generator=torch.Generator().manual_seed(3)).cuda()

    def total(t):
        return funcol.wait_tensor(funcol.all_reduce(t * 2.0, "sum", whole))

    want = total(x)
    g = StaticGraph(total, [x], name="all-reduce")
    y = x + 1.0
    g(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = g(y)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    same = torch.equal(got, total(y)) and torch.equal(g(x), want)
    print(f"[8g] funcol.all_reduce on the one-rank NCCL group under capture: captured "
          f"{g.graph is not None}, replay equals eager bit for bit: {same}; the replay's device "
          f"operations: {[name[:60] for name in ops]}; {smi}")
    if g.graph is None or not same:
        fail(f"8g: the captured all-reduce: captured {g.graph is not None}, equal {same}")


def dryrun_report(torch, results: dict, phase7: dict, smi: str) -> None:
    """(d) the two qwen2-0.5b cells on the 16 x 16 mesh of fake ranks; (e)
    the estimates of smollm-360m's step against the card's phase 7a."""
    for label in (f"{a} {s}" for a, s in DRYRUN_CELLS):
        r = results[label]
        if r.get("status") != "ok":
            fail(f"8d: dry-run {label}: {r.get('status')} {r.get('error', '')}")
        rf, c, m = r["roofline"], r["collectives"], r["memory"]
        print(f"[8d] dry-run {label} on {r['n_chips']} fake ranks, policy {r['policy']}: "
              f"trace {r['trace_s']} s; per device {r['cost']['flops_per_device']:.4e} flops, "
              f"{r['cost']['bytes_per_device']:.4e} bytes, peak {m['peak_bytes'] / 2**30:.3f} GiB "
              f"(fits {m['fits']}); roofline compute {rf['compute_s']:.4e} s, memory "
              f"{rf['memory_s']:.4e} s (kernel {rf['memory_s_kernel']:.4e} s), collective "
              f"{rf['collective_s']:.4e} s, dominant {rf['dominant']}; collectives "
              f"{ {k: v for k, v in c.items() if v} }; layout events {r['layout_events']}")
    dec = results[f"{DRYRUN_CELLS[1][0]} {DRYRUN_CELLS[1][1]}"]
    # Trap of the head views: 14 heads of 64 on a 16-way model axis.  The
    # projections' 896 features split 16 ways are not whole heads, so each
    # view is replicated explicitly first (layers x q, k, v).
    if dec["policy"]["model_axis"] != "model" or dec["layout_events"].get("whole_heads", 0) < 3:
        fail(f"8d: decode_32k did not take the TP layout with whole-head views: {dec['policy']} "
             f"{dec['layout_events']}")
    est = results["estimate"]
    if est.get("status") != "ok":
        fail(f"8e: the estimate failed: {est}")
    from repro_torch.configs import ARCHS
    from repro_torch.models import abstract_params

    n = sum(t.numel() for t in _leaves(abstract_params(ARCHS[TRAIN_ARCH])))
    tokens = TRAIN_SEQ_LEN * TRAIN_BATCH
    flop_ratio = est["cost"]["flops_per_device"] / (8 * n * tokens)
    peak = est["memory"]["peak_bytes"] / 2**30
    mem_ratio = peak / phase7["eager_peak_gib"]
    print(f"[8e] {TRAIN_ARCH} seq {TRAIN_SEQ_LEN} x batch {TRAIN_BATCH} on one fake rank: "
          f"estimated peak {peak:.3f} GiB against phase 7a's eager step's "
          f"{phase7['eager_peak_gib']:.3f} GiB above the "
          f"start ({mem_ratio:.3f}x, bound {MEM_ESTIMATE_BOUNDS}); counted flops "
          f"{est['cost']['flops_per_device']:.4e} = {flop_ratio:.3f} x 8 N T (N {n:,}, T {tokens}; "
          f"bound {FLOP_ESTIMATE_BOUNDS}; attention {est['cost']['attention_flops']:.4e}); "
          f"trace {est['trace_s']} s; {smi}")
    if not MEM_ESTIMATE_BOUNDS[0] <= mem_ratio <= MEM_ESTIMATE_BOUNDS[1]:
        fail(f"8e: the memory estimate is {mem_ratio:.3f}x the card's, outside {MEM_ESTIMATE_BOUNDS}")
    if not FLOP_ESTIMATE_BOUNDS[0] <= flop_ratio <= FLOP_ESTIMATE_BOUNDS[1]:
        fail(f"8e: the flop count is {flop_ratio:.3f}x 8 N T, outside {FLOP_ESTIMATE_BOUNDS}")


def shard_refusals(torch, mesh) -> None:
    """(f) A DTensor and a FakeTensor handed straight to each kernel
    wrapper raise the kernels' refusal of tensor subclasses."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.matern import ops as mo
    from repro_torch.kernels.swe_flux import ops as so
    from repro_torch.swe.solver import SWEConfig, SWEState

    cfg = SWEConfig(nx=32, ny=32, dx=1000.0, dy=1000.0, t_end=1.0)

    def calls(t):
        q = t((1, 2, 64, 64), torch.bfloat16)
        h = t((2, 32, 32), torch.float32)
        b = t((32, 32), torch.float32)
        a = t((8, 4), torch.float32)
        return {
            "flash_attention": lambda: fa.flash_attention(q, q, q),
            "swe_fused_step": lambda: so.swe_step_batched(SWEState(h, h, h), b, 0.1, cfg=cfg),
            "swe_sweep": lambda: so.swe_sweep(h, h, h, b, axis=0, g=9.81, d=1000.0),
            "matern52": lambda: mo.matern52_scaled(a, a, 1.0),
            "matern52_mean": lambda: mo.matern52_mean(
                a, t((4,), torch.float32), a, t((8, 3), torch.float32), t((3,), torch.float32),
                t((3,), torch.float32), 1.0),
        }

    def dtensor(shape, dtype):
        return distribute_tensor(torch.zeros(shape, dtype=dtype, device="cuda"), mesh,
                                 [Replicate(), Replicate()])

    def run(kind, table):
        for name, call in table.items():
            try:
                call()
            except RuntimeError as e:
                if "takes plain tensors" not in str(e):
                    raise
                print(f"[8f] {name} given a {kind}: refused ({str(e)[:90]}...)")
                continue
            fail(f"8f: {name} ran on a {kind}")

    run("DTensor", calls(dtensor))
    with FakeTensorMode():
        run("FakeTensor", calls(lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                                                 device="cuda")))


def phase_sharded_steps(torch, smi: str, phase7: dict, ended=lambda phase: None) -> None:
    """8: the dry-runs start on the host; the NCCL group of one rank (a
    local store) is set up and torn down at the phase's edges around
    (a)-(c) with their graphs, (g) and (f); then the dry-runs' results, (d)
    and (e)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    procs = _start_dryruns()
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                                world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            shard_train_checks(torch, mesh, smi, phase7)
            ended("8a sharded train, eager and graph")
            shard_serve_checks(torch, mesh, smi)
            ended("8b-c sharded prefill and decode, eager and graph")
            collective_capture_check(torch, mesh, smi)
            shard_refusals(torch, mesh)
        finally:
            dist.destroy_process_group()
        results = _wait_dryruns(procs)
    finally:
        for _, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
    dryrun_report(torch, results, phase7, smi)
    ended("8d-g dry-run, estimates, refusals, captured all-reduce")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run from a checkout")
    sys.path.insert(0, str(SRC))
    # cuBLAS reads its workspace setting once; deterministic algorithms
    # (phase 7b) require one of the two fixed settings.  ":4096:8" is
    # PyTorch's own default on Hopper.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    phase_sharded(torch, PAPER, res, rows, smi)
    ended("4d sharded pools and restart")
    del res
    phase_lm(torch, rows, ended)
    phase_families(torch, rows, ended)
    phase_last_families(torch, rows, ended)
    phase7 = phase_training(torch, smi, ended)
    phase_sharded_steps(torch, smi, phase7, ended)
    print(f"[9] all phases passed in {time.perf_counter() - t_start:.1f}s; seconds by phase "
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
