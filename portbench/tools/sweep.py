"""Find the highest rate an open-loop serving cell sustains: one set-up,
then a window at each offered rate, each reporting whether the backlog
stayed flat.

    python3 portbench/tools/sweep.py --workload granite-chat \\
        --rates 0.5,1,1.5,2,3 --seconds 40 --seed 7

The backlog at a moment is the requests already due and not yet finished.
A rate holds when the backlog at the window's end is no larger than at its
middle by more than a quarter (plus two requests); the median time to
first token of the window's first and last thirds is printed beside it.
The chosen rate goes into the mix file as a fixed number.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.harness import cells  # noqa: E402
from portbench.harness.context import Context  # noqa: E402


def backlog(records, t: float) -> int:
    n = 0
    for r in records:
        end = r.result.token_times[-1] if r.result is not None else float("inf")
        n += r.due <= t < end
    return n


def sweep(workload: str, rates, seconds: float, seed: int, device: str = "cuda", overrides=None):
    cell = cells.resolve(workload)
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=False, device=device,
                  overrides=overrides or {})
    bench = cells.load_driver(cell).Bench(ctx)
    try:
        for rate in rates:
            bench.mix["rate_rps"] = float(rate)
            bench._make_traffic()
            bench.window()
            recs = bench.records
            t0, t1 = bench.t0, bench.t1
            third = (t1 - t0) / 3
            first = [r.result.token_times[0] - r.due for r in recs
                     if r.result is not None and r.due < t0 + third]
            last = [r.result.token_times[0] - r.due for r in recs
                    if r.result is not None and r.due >= t1 - third]
            mid, end = backlog(recs, 0.5 * (t0 + t1)), backlog(recs, t1)
            row = {
                "rate_rps": rate, "requests": len(recs),
                "backlog_mid": mid, "backlog_end": end,
                "ttft_p50_first_third_ms": statistics.median(first) * 1e3 if first else None,
                "ttft_p50_last_third_ms": statistics.median(last) * 1e3 if last else None,
                **{k: v for k, v in bench.end_to_end().items()},
                "failed": bench.failed,
            }
            row["holds"] = bool(end <= 1.25 * mid + 2)
            yield row
    finally:
        bench.release()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    rates = [float(r) for r in args.rates.split(",") if r]
    for row in sweep(args.workload, rates, args.seconds, args.seed):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
