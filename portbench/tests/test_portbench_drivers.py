"""Every driver runs its cell end to end on the CPU at a small size, with
the port's plain kernel versions, and prints a result line of the
required shape."""
from __future__ import annotations

import json

import pytest

from portbench.tests import tiny
from portbench.harness import cells

CELLS = [w["name"] for w in cells.load_benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(name, trace):
    from portbench.run import run_cell

    line, checks = run_cell(tiny.context(name, trace=trace))
    return json.loads(line), checks


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_reports(name):
    out, checks = _run(name, trace=False)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    cell = cells.resolve(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        v = out["metrics"][m["name"]]
        assert v["unit"] == m["unit"] and v["value"] > 0
    assert out["checks"] and all(c.ok for c in checks)
    assert set(out["checks"]) == {c.name for c in checks}
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)


@pytest.mark.parametrize("name", [CELLS[0]] + [c for c in CELLS if c.startswith("granite")])
def test_traced_run_reports_per_layer_metrics(name):
    out, _ = _run(name, trace=True)
    cell = cells.resolve(name)
    names = {m["name"] for m in cell.per_layer}
    # On the CPU the trace holds no device operation: only the metrics that
    # read the program's counters can be there.
    assert set(out["metrics"]) <= names
    counted = [m for m in cell.per_layer if m["source"] == "program_counter"]
    assert {m["name"] for m in counted} <= set(out["metrics"])
    for m in counted:  # shares (slot occupancy, live MoE rows) are of a whole
        if m["unit"] == "%":
            assert 0 < out["metrics"][m["name"]]["value"] <= 100, m["name"]
    if cell.mix["driver"] != "mlda_rounds":
        # Serving reads its device spans from CUDA events: none on the CPU.
        assert "window_s" not in out["device"]
    else:  # the profiler over one round
        assert out["device"]["window_s"] > 0 and "breakdown" in out
    assert out["correct"] is True


def test_knee_sweep_reports_each_rate():
    from portbench.tools.sweep import sweep

    name = next(c for c in CELLS if c.startswith("granite") and "chat" in c)
    rows = list(sweep(name, [2.0, 8.0], 1.5, 5, device="cpu", overrides=tiny.overrides(name)))
    assert [r["rate_rps"] for r in rows] == [2.0, 8.0]
    assert all(isinstance(r["holds"], bool) and r["failed"] == 0 for r in rows)
