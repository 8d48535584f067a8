"""No run may load JAX or the JAX package: the check compares whole
top-level module names, and the harness with everything it imports passes
it; the harness refuses to run without a card or without the program."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests import tiny
from portbench.harness.report import FORBIDDEN, forbidden_modules


@pytest.mark.parametrize("names, found", [
    (["repro_torch", "repro_torch.swe", "portbench.run"], []),
    (["repro", "repro.core.mlda"], ["repro"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "reprox", "jax_like"], ["flax"]),
])
def test_whole_top_level_names(names, found):
    assert forbidden_modules(names) == found


def test_harness_imports_no_jax():
    code = (
        "import sys; sys.path[:0] = ['src', '.'];\n"
        "import portbench.run, portbench.harness.serving, portbench.reference.lm,\\\n"
        "    portbench.reference.tohoku, portbench.tools.readings\n"
        "from portbench.harness import cells\n"
        "for w in cells.load_benchmark()['workloads']:\n"
        "    c = cells.resolve(w['name']); cells.load_driver(c)\n"
        "    [cells.load_metric(m['name']) for m in c.per_layer]\n"
        "    'arch' in c.files and cells.load_arch(c.config['model_type'])\n"
        "import repro_torch.core, repro_torch.swe, repro_torch.runtime.serve_loop\n"
        "from portbench.harness.report import forbidden_modules\n"
        "print(forbidden_modules())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}


def test_refuses_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mlda-paper",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=tiny.ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(tiny.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "granite-chat",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0 and out.stdout.strip() == ""
