"""The compared numbers of a cell over several seeds, the program's and the
control's, in one process: what the limits in ``portbench/mixes`` are set
from.

    python3 portbench/tools/readings.py --workload mlda-paper \\
        --seeds 11,12,13 --seconds 10 [--control] [--fault half_batch]

For each seed the cell is set up, a window of ``--seconds`` is run and the
program's readings are taken as a run takes them; with ``--control`` the
control's readings are taken on the same sample: the plain reference put in
the program's place in the next lower precision (bfloat16 for the
float32 MLDA cells, float8 weights for the bfloat16 model).  With
``--fault`` a fault of ``portbench.tools.faults`` is planted in the program
first, so that the program's readings are the fault's.  One JSON line a
seed.  The benchmark's own runs never run the control or a fault.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.harness import cells  # noqa: E402
from portbench.harness.context import Context  # noqa: E402
from portbench.tools import faults  # noqa: E402


def readings(workload: str, seeds, seconds: float, control: bool, device: str = "cuda",
             overrides=None, fault=None):
    cell = cells.resolve(workload)
    driver = cells.load_driver(cell)
    if fault:
        faults.plant(cell.driver, fault)
    for seed in seeds:
        ctx = Context(cell=cell, seed=int(seed), seconds=seconds, trace=False, device=device,
                      overrides=overrides or {})
        t = time.perf_counter()
        bench = driver.Bench(ctx)
        bench.window()
        values = bench.end_to_end()
        bench.release()
        row = {"seed": int(seed), "program": bench.readings(False), "end_to_end": values,
               **bench.extra()}
        if control:
            row["control"] = bench.readings(True)
        row["seconds"] = time.perf_counter() - t
        yield row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None, help="a fault of portbench.tools.faults")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for row in readings(args.workload, seeds, args.seconds, args.control, fault=args.fault):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
