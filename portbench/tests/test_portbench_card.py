"""On the card: each cell at its full size for a short window, and the
control failing where the program passes.  Skips without a CUDA card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests import tiny
from portbench.harness import cells

CELLS = [w["name"] for w in cells.load_benchmark()["workloads"]]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    _need_card()
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                          "3141592653", "--seconds", "10", "--trace", "0"],
                         cwd=tiny.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    _need_card()
    from portbench.tools.readings import readings

    limits = cells.resolve(name).mix["limits"]
    row = next(readings(name, [2718281828], 15.0, True))
    assert all(v <= limits[k] for k, v in row["program"].items()), row
    assert any(v > limits[k] for k, v in row["control"].items()), row
