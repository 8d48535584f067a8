"""The port's dry-run (``launch/dryrun.py``), as the reference's
``tests/test_dryrun_small.py`` holds its own: for the same five archs,
reduced, the sharded train step under TP and under pure DP and the decode
step trace on a (2, 4) fake mesh with status ok and flops > 0.

The reference's own copy of that test fails on this tree (ROADMAP Queue 3,
note 2: ``jax.make_mesh`` builds Explicit axes under jax 0.9), so the
port's dry-run is held against the reference's single-device pieces:
``model_flops`` and ``shape_applicable`` for every arch x shape.  The
traces run in subprocesses: the fake process group is global to a process,
and so is the reference's XLA_FLAGS.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import ARCHS, PORT_ONLY_ARCHS, SHAPES, shape_applicable
from repro_torch.launch import dryrun

REPO = os.path.join(os.path.dirname(__file__), "..")
FAMILY_ARCHS = ["qwen2-0.5b", "mixtral-8x22b", "mamba2-1.3b", "zamba2-1.2b", "whisper-large-v3"]

TRACE_SCRIPT = r"""
import json, sys
from repro_torch.launch import dryrun
dryrun.fake_world(8)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.runtime.sharding import make_policy
from repro_torch.runtime.train_loop import TrainRuntime
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
for arch in sys.argv[1:]:
    cfg = ARCHS[arch].reduced()
    out = {}
    train = ShapeConfig("t", seq_len=64, global_batch=8, kind="train")
    decode = ShapeConfig("d", seq_len=64, global_batch=8, kind="decode")
    for name, shape, pure_dp in (("train_tp", train, False), ("train_dp", train, True),
                                 ("decode", decode, False)):
        try:
            s, secs = dryrun.trace_cell(cfg, shape, make_policy(mesh, pure_dp=pure_dp),
                                        TrainRuntime())
            out[name] = {"status": "ok", "flops": s.flops, "bytes": s.bytes,
                         "collectives": s.collective_count, "peak": s.peak_bytes}
        except Exception as exc:
            out[name] = {"status": "error", "error": f"{type(exc).__name__}: {exc}"}
    print("RESULT:" + json.dumps({"arch": arch, **out}), flush=True)
"""

REFERENCE_SCRIPT = r"""
import json
from repro.configs import ARCHS, SHAPES, shape_applicable
from repro.launch.dryrun import model_flops
out = {}
for a in sorted(ARCHS):
    for s in SHAPES:
        out[f"{a}|{s}"] = [model_flops(a, s), list(shape_applicable(ARCHS[a], SHAPES[s]))]
print("RESULT:" + json.dumps(out))
"""


# One thread a subprocess: the suite runs beside them.
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")


def _nice():
    os.nice(10)  # below the suite's own workers, whose timing tests share the host


def _run(code, *args, timeout=600):
    proc = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                          env=ENV, cwd=REPO, timeout=timeout, preexec_fn=_nice)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(ln[len("RESULT:"):]) for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT:")]


@pytest.fixture(scope="module")
def traces():
    return {r["arch"]: r for r in _run(TRACE_SCRIPT, *FAMILY_ARCHS)}


@pytest.mark.parametrize("arch_id", FAMILY_ARCHS)
def test_multidevice_trace(traces, arch_id):
    out = traces[arch_id]
    for name in ("train_tp", "train_dp", "decode"):
        cell = out[name]
        assert cell["status"] == "ok", (name, cell)
        assert cell["flops"] > 0 and cell["bytes"] > 0 and cell["peak"] > 0
    # Both train layouts move data between ranks.
    assert out["train_tp"]["collectives"] > 0 and out["train_dp"]["collectives"] > 0


def test_model_flops_and_skip_rule_match_reference():
    """Every id both packages have, looked up in the reference's table; the
    port's own architectures are the only ids it lacks."""
    ref = _run(REFERENCE_SCRIPT)[0]
    theirs = {key.split("|")[0] for key in ref}
    assert set(ARCHS) - theirs == set(PORT_ONLY_ARCHS) and theirs <= set(ARCHS)
    for a in sorted(theirs):
        for s in SHAPES:
            flops, applicable = ref[f"{a}|{s}"]
            assert dryrun.model_flops(a, s) == flops, (a, s)
            assert list(shape_applicable(ARCHS[a], SHAPES[s])) == applicable


def test_cli_writes_the_reference_record(tmp_path):
    """The documented command at full size, qwen2-0.5b's decode_32k on the
    16 x 16 mesh of 256 fake ranks: status ok, the reference's keys with
    ``trace_s`` for ``lower_s``/``compile_s`` and ``*_kernel`` for
    ``*_pallas``, and the skip rule's record for a long_500k cell."""
    for shape in ("decode_32k", "long_500k"):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b",
             "--shape", shape, "--mesh", "single", "--device", "cpu", "--out", str(tmp_path)],
            capture_output=True, text=True, env=ENV, cwd=REPO, timeout=600, preexec_fn=_nice)
        assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((tmp_path / "qwen2-0.5b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["policy"]["model_axis"] == "model"
    assert {"memory", "cost", "collectives", "roofline", "trace_s"} <= set(rec)
    assert {"memory_s_kernel", "roofline_fraction_kernel", "compute_s", "memory_s",
            "collective_s"} <= set(rec["roofline"])
    assert rec["cost"]["flops_per_device"] > 0 and rec["memory"]["peak_bytes"] > 0
    assert rec["collectives"]["count"] > 0 and "H100" in rec["card"]
    skipped = json.loads((tmp_path / "qwen2-0.5b__long_500k__single.json").read_text())
    assert skipped["status"] == "skipped" and "sub-quadratic" in skipped["reason"]
