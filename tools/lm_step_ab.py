#!/usr/bin/env python3
"""A/B of the LM decode step between two source trees on one CUDA card.

Run from the root of a checkout:

    python3 tools/lm_step_ab.py OLD_SRC NEW_SRC

``OLD_SRC`` and ``NEW_SRC`` are ``src`` directories holding
``repro_torch`` (for instance the parent commit unpacked with ``git
archive`` under ``build/``, and this tree's ``src``).  The runs go OLD,
NEW, NEW, OLD, each in a process of its own with its tree first on
``sys.path``; each prints one JSON line.  The model is qwen2-0.5b at full
width in bf16 with seeded random weights (the same in every run):

* ``peak_mib``: the peak device memory of one eager slab decode step of
  8 rows over a cache of 32,768 positions, above what the step starts
  from (weights and state): ``chip_smoke.decode_step_peak``;
* ``replay_ms``: a replayed B = 1 decode step (``DecodeGraph``, cache
  128) by the host's clock, the mean of 50 calls ending in a synchronize;
* ``device_ms`` and ``top_ops``: 5 replayed steps under
  ``torch.profiler``: device time per step, and the five largest device
  operations (ms a step).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path


def measure(src: str) -> dict:
    # The tree under test first, then this checkout's root for chip_smoke's
    # measurement (it imports the port inside its functions).
    sys.path[:0] = [src, str(Path(__file__).resolve().parents[1])]
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import DecodeGraph

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["qwen2-0.5b"]
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), "cuda")
    peak = chip_smoke.decode_step_peak(torch, cfg, params, 8, chip_smoke.LONG_CACHE_LEN, "ab")

    g1 = DecodeGraph(bundle, params, 1, 128, name="ab B=1")
    g1.prefill(torch.zeros((1, 32), dtype=torch.int64, device="cuda"))
    feed = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    for _ in range(10):
        g1(feed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        g1(feed)
        torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / 50
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            g1(feed)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = Counter()
    for e in kernels:
        by_name[e.name[:80]] += e.time_range.elapsed_us() / 1e3 / 5
    return {"src": src, "peak_mib": peak / 2**20, "replay_ms": replay_ms,
            "device_ms": sum(by_name.values()), "device_ops": len(kernels) // 5,
            "top_ops": by_name.most_common(5)}


def main(argv) -> None:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1])), flush=True)
        return
    if len(argv) != 2:
        sys.exit(__doc__)
    old, new = argv
    for src in (old, new, new, old):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", src],
                             capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"run on {src} failed:\n{out.stderr[-4000:]}")
        print(out.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
