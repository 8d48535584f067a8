"""A run of a cell as ``portbench/run.py`` makes it, with the program's span
recorder on through the window; its result line gains a ``spans`` key.

    python3 portbench/tools/span_readings.py --workload mlda-paper \\
        --seed 11 --seconds 51 --trace 1 [--spans 0]

The recorder (``repro_torch.spans.SPANS``) is enabled as the
driver's window starts and drained once it has ended (the serving drivers'
windows end after their requests drain).  ``spans`` holds the five span
figures of ``portbench.harness.spans.figures``, the records the window
held and the records dropped.  In a traced run whose slice is a profiler
trace (the MLDA cells) it also holds the ten longest idle gaps named by the
program's spans (``idle_gaps``), the slice's idle time by name and the
check of the two clocks (``clock``).  The clocks meet at runtime calls
stamped on ``time.monotonic``: stream synchronisations just after the
tracer opens its window and just before it closes it, and a thread's
``torch.cuda.mem_get_info`` every 20 ms between.

``--spans 0`` leaves the recorder off and changes nothing else: pairs of
``--trace 0`` runs with ``--spans 1`` and ``--spans 0`` give what the
recorder costs while it records.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.harness import cells, report, spans  # noqa: E402
from portbench.harness import trace as tracing  # noqa: E402
from portbench.harness.context import Context  # noqa: E402


def readings(bench, log, t0: float, t1: float, anchors: Optional[List[float]] = None,
             probes: Sequence[Tuple[float, float]] = ()) -> Dict[str, Any]:
    """The ``spans`` key of a run's result line."""
    out: Dict[str, Any] = {"records": len(log.spans), "dropped": log.dropped,
                           **spans.figures(log, t0, t1)}
    trace = bench.device_trace()
    if isinstance(trace, tracing.Trace) and anchors and len(anchors) == 2:
        clock = spans.trace_clock(trace, *anchors, thread=threading.get_native_id(),
                                  probes=probes)
        out["idle_gaps"] = spans.named_idle_gaps(trace, log, clock)
        out["idle_by_name"] = spans.idle_by_name(trace, log, clock)
        out["clock"] = {**spans.clock_check(trace, log, clock), "anchors": clock.anchors,
                        "probes": len(probes)}
    return out


def _clock_anchor() -> float:
    """The middle of a stream synchronisation on this thread: a runtime
    call the trace holds, stamped on the program's clock."""
    import torch

    a = time.monotonic()
    if torch.cuda.is_available():
        torch.cuda.current_stream().synchronize()
    return 0.5 * (a + time.monotonic())


class _Probes:
    """A thread that, every ``every_s`` while started, makes one
    ``spans.PROBE_CALL`` (``torch.cuda.mem_get_info``) and keeps the
    program's clock before and after it: anchors inside the traced slice."""

    def __init__(self, every_s: float = 0.02) -> None:
        self.every_s = every_s
        self.stamps: List[Tuple[float, float]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        import torch

        while not self._stop.wait(self.every_s):
            a = time.monotonic()
            torch.cuda.mem_get_info()
            self.stamps.append((a, time.monotonic()))

    def start(self) -> None:
        import torch

        if torch.cuda.is_available():
            self._thread = threading.Thread(target=self._run, name="span-clock-probe",
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()


def spanned(driver, on: bool, runs: List) -> type:
    """A subclass of the driver's ``Bench`` whose window runs with the
    recorder on (when ``on``); each run's bench goes to ``runs``."""
    from repro_torch.spans import SPANS

    class Bench(driver.Bench):
        def window(self) -> None:
            anchors: List[float] = []
            probes = _Probes()
            start, stop = tracing.Tracer.start, tracing.Tracer.stop

            def anchored_start(tracer) -> None:
                start(tracer)
                anchors.append(_clock_anchor())
                probes.start()

            def anchored_stop(tracer):
                probes.stop()
                anchors.append(_clock_anchor())
                return stop(tracer)

            SPANS.drain()  # nothing from the set-up
            tracing.Tracer.start, tracing.Tracer.stop = anchored_start, anchored_stop
            if on:
                SPANS.enable()
            t0 = time.monotonic()
            try:
                super().window()
            finally:
                t1 = time.monotonic()
                SPANS.disable()
                tracing.Tracer.start, tracing.Tracer.stop = start, stop
            self.span_readings = readings(self, SPANS.drain(), t0, t1, anchors, probes.stamps)
            runs.append(self)

    return Bench


def run(ctx: Context, on: bool = True):
    """``portbench.run.run_cell`` with the recorder on through the window;
    returns the result line (with ``spans``) as a dict, and the checks."""
    from portbench.run import run_cell

    driver = cells.load_driver(ctx.cell)
    base, runs = driver.Bench, []
    driver.Bench = spanned(driver, on, runs)
    try:
        line, checks = run_cell(ctx)
    finally:
        driver.Bench = base
    out = json.loads(line)
    checks_key = out.pop("checks")
    out["spans"] = runs[-1].span_readings
    out["checks"] = checks_key
    return out, checks


def main(argv=None) -> int:
    from portbench.run import set_cache_dirs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    cell = cells.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[span_readings] {args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  watchdog=True)
    out, _ = run(ctx, on=bool(args.spans))
    loaded = report.forbidden_modules()
    if loaded:
        print(f"[span_readings] forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
