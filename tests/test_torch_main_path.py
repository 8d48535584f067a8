"""The port's main path end to end, its entry points and its imports.

A short Tōhoku MLDA run through the port's balancer and ensemble driver on
the CPU (tiny grids), the batching contract within the port (coalesced
chains equal per-request chains bit for bit), the level-0 surrogate against
the JAX reference's, the device rule (the card by default, never a silent
CPU fallback), and import hygiene: nothing of the port imports jax or the
JAX package.
"""
import dataclasses
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gp import fit_gp as jax_fit_gp
from repro_torch.configs.tohoku_mlda import CPU
from repro_torch.core import GaussianRandomWalk, balanced_mlda, make_device_ensemble
from repro_torch.device import resolve_device
from repro_torch.ensemble import DeviceEnsembleRunner, EnsembleRunner
from repro_torch.launch.tsunami import main as tsunami_main
from repro_torch.launch.tsunami import run
from repro_torch.swe import (
    TohokuScenario,
    device_densities,
    local_level_servers,
    make_hierarchy,
    make_level_servers,
    train_level0_gp,
)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
TINY = dataclasses.replace(
    CPU, coarse_grid=(16, 16), fine_grid=(24, 24), t_end_s=1200.0,
    gp_train_points=16, gp_opt_steps=8, n_chains=2, n_fine_samples=3,
    subchain_lengths=(3, 2), max_batch=4,
)


@pytest.fixture(scope="module")
def tiny_hierarchy():
    fine = TohokuScenario(nx=24, ny=24, t_end=TINY.t_end_s, device="cpu")
    coarse = TohokuScenario(nx=16, ny=16, t_end=TINY.t_end_s, device="cpu")
    h = make_hierarchy(fine=fine, coarse=coarse)
    h["gp"] = train_level0_gp(
        h["forward_coarse_batch"], h["problem"], n_train=TINY.gp_train_points,
        steps=TINY.gp_opt_steps,
    )
    return h


def _run_chains(h, batch: bool):
    w = dataclasses.replace(TINY, batch_solves=batch)
    prob = h["problem"]
    servers = make_level_servers(
        w, h["gp"], h["forward_coarse"], h["forward_fine"],
        batch_forwards=(None, h["forward_coarse_batch"], h["forward_fine_batch"])
        if batch else None,
    )
    runner, lb = balanced_mlda(
        servers, prob.log_likelihood, prob.log_prior,
        GaussianRandomWalk(w.rw_step_km), list(w.subchain_lengths),
        batchable_levels=w.batchable_levels, n_chains=w.n_chains,
        ensemble_seed=0, speculative=True, as_runner=True, **w.batch_kwargs(),
    )
    try:
        res = runner.run(lambda c, rng: prob.sample_prior(rng)[0] * 0.5, w.n_fine_samples)
        hist = lb.telemetry.batch_histogram()
    finally:
        lb.shutdown()
    return res, hist


def test_coalesced_chains_equal_per_request_chains(tiny_hierarchy):
    res_b, hist_b = _run_chains(tiny_hierarchy, batch=True)
    res_p, hist_p = _run_chains(tiny_hierarchy, batch=False)
    assert res_b.chains.shape == (2, 3, 2)
    assert np.isfinite(res_b.chains).all()
    assert np.array_equal(res_b.chains, res_p.chains)
    assert hist_p == {}
    assert hist_b and set(hist_b) <= {"level0", "level1", "level2"}
    assert not res_b.failures
    totals = res_b.level_totals()
    assert [row["level"] for row in totals] == [0, 1, 2]
    assert totals[0]["n_evals"] > totals[2]["n_evals"]


def test_level0_surrogate_matches_reference_surrogate(tiny_hierarchy):
    """The port's surrogate fitted on the port's coarse solves of a numpy
    design, against the reference's fitted on the same solves: loose, as
    two fp32 Adam runs through different autodiff systems drift apart."""
    h = tiny_hierarchy
    x = np.random.default_rng(0).uniform(-200, 200, (24, 2)).astype(np.float32)
    ys = h["forward_coarse_batch"](torch.from_numpy(x)).numpy()
    from repro_torch.core.gp import fit_gp

    gt = fit_gp(x, ys, steps=30, device="cpu")
    gj = jax_fit_gp(x, ys, steps=30)
    q = np.random.default_rng(1).uniform(-150, 150, (8, 2)).astype(np.float32)
    np.testing.assert_allclose(
        gt.batch_call(torch.from_numpy(q)).numpy(),
        np.asarray(gj.batch_call(jnp.asarray(q))),
        rtol=0, atol=2e-2,
    )


def test_tsunami_run_reports_every_stage(capsys):
    """The entry point's run() at TINY size on the CPU (the cpu preset is
    minutes of CPU work)."""
    res = run(TINY, n_chains=2, device="cpu", log=print)
    printed = capsys.readouterr().out
    for stage in ("[1/4]", "[2/4]", "[3/4]", "[4/4]", "balancer idle",
                  "reconstructed series: len="):
        assert stage in printed
    assert res["y_obs"].shape == (4,) and np.isfinite(res["y_obs"]).all()
    assert res["chains"].shape == (2, TINY.n_fine_samples, 2)
    assert np.isfinite(res["posterior_mean"]).all()
    assert set(res["walls"]) == {"hierarchy_s", "gp_train_s", "sampling_s", "series_gp_s"}
    n_steps = res["hierarchy"]["forward_coarse"].n_steps
    assert res["posterior_series"].shape == (n_steps,)
    assert bool(torch.isfinite(res["posterior_series"]).all())
    assert res["series_gp"].y_train.shape == (32, n_steps)


def test_tsunami_cli_rejects_unknown_workload(capsys):
    with pytest.raises(SystemExit):
        tsunami_main(["--workload", "nonesuch", "--device", "cpu"])
    assert "invalid choice" in capsys.readouterr().err


def test_device_defaults_to_card_and_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TohokuScenario(nx=8, ny=8).bathymetry()
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")


def test_later_slices_raise_not_implemented():
    """The on-disk checkpoints of the ensemble driver wait for the port of
    the checkpoint module (ROADMAP Queue 1 item 9)."""
    with pytest.raises(NotImplementedError, match="checkpoint"):
        EnsembleRunner(lambda c: None, 1, checkpoint_dir="anywhere")


def test_device_resident_validates_before_building_a_balancer(tiny_hierarchy):
    """A bad device-resident call raises ValueError before any dispatcher
    thread exists; a coupled ensemble without its fine density is refused."""
    prob = tiny_hierarchy["problem"]
    threads = threading.active_count()
    for kwargs in ({}, {"device_densities": [lambda t: t[:, 0]]}):
        with pytest.raises(ValueError, match="device_densities"):
            balanced_mlda(
                [], prob.log_likelihood, prob.log_prior, GaussianRandomWalk(1.0), [2, 2],
                device_resident=True, device="cpu", **kwargs,
            )
    assert threading.active_count() == threads
    coupled = make_device_ensemble([lambda t: t[:, 0]], [2], 1.0, remote_top=True,
                                   device="cpu")
    with pytest.raises(ValueError, match="fine_density"):
        DeviceEnsembleRunner(coupled)


def test_device_resident_main_path_on_cpu(tiny_hierarchy):
    """The coupled ensemble as chip_smoke's phase 4c drives it, at TINY
    size: GP and coarse densities on the device, the fine BatchServers
    behind the balancer."""
    h = tiny_hierarchy
    prob = h["problem"]
    servers = [s for s in local_level_servers(TINY, h["gp"], h) if "level2" in s.capacity_tags]
    runner, lb = balanced_mlda(
        servers, prob.log_likelihood, prob.log_prior, GaussianRandomWalk(TINY.rw_step_km),
        list(TINY.subchain_lengths), batchable_levels=TINY.batchable_levels,
        device_resident=True, device_densities=device_densities(
            prob, h["gp"], h["forward_coarse_batch"]),
        device="cpu", **TINY.batch_kwargs(),
    )
    theta0 = (prob.sample_prior(np.random.default_rng(0), 3) * 0.5).astype(np.float32)
    try:
        res = runner.run(theta0, 4)
        hist = lb.telemetry.batch_histogram()
    finally:
        lb.shutdown()
    assert res.chains.shape == (3, 4, 2) and np.isfinite(res.chains).all()
    assert set(hist) == {"level2"}  # only fine solves reach the balancer
    for row in res.level_totals():
        assert row["n_evals"] >= 1
    for stats in res.samplers:
        assert all(0 <= r.n_accepted <= r.n_proposed for r in stats.levels)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_hygiene_no_jax_no_reference_package():
    """Importing the whole port and chip_smoke pulls in neither jax nor the
    JAX package (checked in a fresh interpreter)."""
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_source_scan_imports_neither_jax_nor_reference():
    pattern = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)(?:\s|\.|$)", re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    """No card (or a directory without the port): non-zero exit, no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke would run for real")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True,
            timeout=300,
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_batched_forward_rows_equal_on_card(card):
    """B = 1 rows equal B = 4 rows bit for bit through the fused kernel."""
    sc = TohokuScenario(nx=32, ny=32, t_end=1800.0, device="cuda")
    fb = sc.build_batch_forward()
    thetas = torch.tensor([[0.0, 0.0], [60.0, -40.0], [-90.0, 15.0], [5.0, 5.0]], device=card)
    full = fb(thetas)
    assert torch.equal(full, torch.cat([fb(thetas[i : i + 1]) for i in range(4)]))
