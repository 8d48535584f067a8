"""The check that decides ``correct`` fails what it must: the control (the
reference in the next lower precision, put in the program's place) and the
faults a cell can have (``portbench.tools.faults``), each planted in the
timed path underneath a run that skips the harness's look for a card.
Small sizes, on the CPU."""
from __future__ import annotations

import json

import pytest

from portbench.tests import tiny
from portbench.harness import cells
from portbench.tools import faults
from portbench.tools.readings import readings

MLDA_CELLS = [w["name"] for w in cells.load_benchmark()["workloads"] if w["name"].startswith("mlda")]
LM_CELLS = [w["name"] for w in cells.load_benchmark()["workloads"] if w["name"].startswith("granite")]


def _correct(name, seconds=1.5):
    from portbench.run import run_cell

    line, _ = run_cell(tiny.context(name, seconds=seconds))
    return json.loads(line)["correct"]


@pytest.mark.parametrize("name", MLDA_CELLS + LM_CELLS)
def test_control_fails(name):
    row = next(readings(name, [2**31 + 5], 1.5, True, device="cpu",
                        overrides=tiny.overrides(name)))
    limits = tiny.TINY_LIMITS
    assert all(v <= limits[k] for k, v in row["program"].items()), row
    assert any(v > limits[k] for k, v in row["control"].items()), row


@pytest.mark.parametrize("name", MLDA_CELLS)
@pytest.mark.parametrize("fault", faults.MLDA)
def test_mlda_faults_fail(name, fault, monkeypatch):
    faults.plant_mlda(fault, monkeypatch.setattr)
    # Judged by the run's own sample: a half-batch fault is caught because
    # the sample takes whole batches, those of two or more rows first.
    assert _correct(name) is False


@pytest.mark.parametrize("name", LM_CELLS)
@pytest.mark.parametrize("fault", faults.SERVING)
def test_serving_faults_fail(name, fault, monkeypatch):
    faults.plant_serving(fault, monkeypatch.setattr)
    # Two seconds: enough requests share the slots for a batch of several.
    assert _correct(name, seconds=2.0) is False
