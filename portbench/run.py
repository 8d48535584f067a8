"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run makes its inputs and weights from
``--seed``, sets up the program (``repro_torch``) and warms every shape the
cell's traffic uses (``setup_s``: process start to window start), measures
for ``--seconds``, then judges what the window produced against a plain
reference under ``portbench/reference``.  With ``--trace 0`` the result
carries the cell's end-to-end metrics; with ``--trace 1`` the driver traces
a slice of the window (``torch.profiler`` or CUDA events) and the result
carries the per-layer metrics, the device's busy seconds and a breakdown.  The last line of
standard output is the JSON result; the comparisons and their limits are
the last lines of standard error and the result's last key.

The run exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), without the program beside ``portbench``, or
when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import faulthandler
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.harness import cells, report  # noqa: E402
from portbench.harness.context import Context  # noqa: E402

# Seconds from process start by which a run that hangs is ended (a run has
# 360), unless a first run's set-up leaves less than the window needs.
WATCHDOG_S = 345.0


def process_age_s() -> float:
    """Seconds since this process started (the kernel's clock, so the
    interpreter's own start-up counts)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own nvcc builds already go to ``build/kernels``)."""
    base = root / "build" / "portbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, str(base / sub))
    # A library that could pull in JAX by itself is told not to.
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def device_info(ctx: Context, peak: int) -> Dict:
    import torch

    if ctx.device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": ctx.cell.chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(ctx: Context) -> Tuple[str, List[report.Check]]:
    """Set up, measure and judge one run of ``ctx.cell``; return the result
    line and the comparisons."""
    import torch

    cuda = ctx.device == "cuda"
    driver = cells.load_driver(ctx.cell)
    bench = driver.Bench(ctx)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age_s()
    ctx.log(f"set-up {setup_s:.3f} s; window of {ctx.seconds} s")
    if ctx.watchdog:
        # A run that hangs (in the program or in the profiler) ends here
        # with every thread's stack on standard error, before the limit of
        # a run, and prints no result.
        faulthandler.dump_traceback_later(
            max(ctx.seconds + float(ctx.mix.get("drain_s", 0.0)) + 90.0, WATCHDOG_S - setup_s),
            exit=True)
    # The window runs on this thread: a driver that traces it starts and
    # stops the profiler here, on the thread that imported torch (from
    # another, the profiler's start logs "External init callback must run
    # in same thread as registerClient").
    bench.window()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    values = bench.end_to_end()
    units = {m["name"]: m["unit"] for m in ctx.cell.end_to_end + ctx.cell.per_layer}
    metrics: Dict[str, Dict] = {}
    # The driver traces its own window, at points where it knows the card
    # to be quiet (see ``portbench.harness.trace.Tracer``).
    trace = bench.device_trace() if ctx.trace else None
    if not ctx.trace:
        for m in ctx.cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else values.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in ctx.cell.per_layer:
            v = cells.load_metric(m["name"], ctx.root).read(bench.facts, trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    device = device_info(ctx, peak)
    breakdown = None
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        breakdown = {"device_ops": trace.top_ops(10), "idle_gaps": trace.idle_gaps(10)}
    bench.release()
    checks = bench.verify()
    if ctx.watchdog:
        faulthandler.cancel_dump_traceback_later()
    report.print_checks(checks)
    line = report.result_line(
        correct=report.checks_ok(checks) and bench.failed == 0,
        attempted=bench.attempted, failed=bench.failed, metrics=metrics, device=device,
        checks=checks, breakdown=breakdown, extra=bench.extra(),
    )
    return line, checks


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    cell = cells.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[portbench] {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  watchdog=True)
    line, _ = run_cell(ctx)
    loaded = report.forbidden_modules()
    if loaded:
        print(f"[portbench] forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    # Everything the run started has stopped (the balancer joined its
    # threads); leave without the interpreter's teardown, whose warnings
    # would follow the comparisons on standard error.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
