"""PyTorch port of the SWE solver and scenario against the JAX reference.

Both packages get the same numpy bathymetry and initial state (fp32
``linspace`` differs between the frameworks in the last ulp of some cell
edges, so a tight step comparison must not rebuild the grid in each).  The
port runs on the CPU here, through the plain versions of its kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.swe import TohokuScenario as JaxScenario
from repro.swe import make_hierarchy as jax_make_hierarchy
from repro.swe import solver as jsolver
from repro_torch.kernels import build
from repro_torch.kernels.swe_flux import ops as swe_ops
from repro_torch.swe import TohokuScenario, lake_at_rest_error, make_hierarchy
from repro_torch.swe import solver as tsolver

CPU = "cpu"


def _rel(a, c) -> float:
    a, c = np.asarray(a), np.asarray(c)
    return float(np.abs(a - c).max()) / max(float(np.abs(a).max()), 1.0)


def _inputs(nx, ny, seed=0, momentum=False):
    """Numpy bathymetry, initial state, config and dt of the reference grid."""
    sc = JaxScenario(nx=nx, ny=ny, t_end=600.0)
    cfg = sc.cfg
    b = np.array(sc.bathymetry(), np.float32)
    h0 = np.maximum(
        np.maximum(-b, 0.0) + np.asarray(sc.displacement(jnp.array([0.0, 0.0]))), 0.0
    ).astype(np.float32)
    rng = np.random.default_rng(seed)
    if momentum:
        hu = (rng.normal(size=h0.shape) * 50.0 * (h0 > 1.0)).astype(np.float32)
        hv = (rng.normal(size=h0.shape) * 50.0 * (h0 > 1.0)).astype(np.float32)
    else:
        hu = np.zeros_like(h0)
        hv = np.zeros_like(h0)
    dt = jsolver.stable_dt(cfg, float(h0.max()))
    tcfg = tsolver.SWEConfig(nx=cfg.nx, ny=cfg.ny, dx=cfg.dx, dy=cfg.dy, t_end=cfg.t_end)
    return cfg, tcfg, b, (h0, hu, hv), dt


@pytest.mark.parametrize("nx,ny", [(48, 40), (33, 17), (64, 64)])
def test_step_matches_reference(nx, ny):
    """4 steps within 1e-5 relative, the bound of the reference's kernel test."""
    cfg, tcfg, b, state, dt = _inputs(nx, ny)
    sj = jsolver.SWEState(*(jnp.asarray(x) for x in state))
    st = tsolver.SWEState(*(torch.from_numpy(x) for x in state))
    bj, bt = jnp.asarray(b), torch.from_numpy(b)
    for _ in range(4):
        sj = jsolver.step(sj, bj, cfg, dt)
        st = tsolver.step(st, bt, tcfg, dt)
    for a, c in zip(sj, st):
        assert c.dtype == torch.float32
        assert _rel(a, c.numpy()) < 1e-5


@pytest.mark.parametrize("nx,ny", [(48, 40), (33, 17)])
@pytest.mark.parametrize("axis", ["x", "y"])
def test_directional_updates_match_reference(nx, ny, axis):
    cfg, _, b, state, _ = _inputs(nx, ny, seed=nx, momentum=True)
    fj = jsolver._x_update if axis == "x" else jsolver._y_update
    ft = tsolver._x_update if axis == "x" else tsolver._y_update
    d = cfg.dx if axis == "x" else cfg.dy
    want = fj(*(jnp.asarray(x) for x in state), jnp.asarray(b), d, cfg.g)
    got = ft(*(torch.from_numpy(x) for x in state), torch.from_numpy(b), d, cfg.g)
    for a, c in zip(want, got):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=1e-5, atol=1e-7)


def test_lake_at_rest():
    """Well-balancedness (paper §3.2): the reference's bound, and in fact exact."""
    sc = TohokuScenario(nx=48, ny=48, t_end=600.0, device=CPU)
    err = lake_at_rest_error(sc.cfg, sc.bathymetry(), n_steps=40)
    assert err < 1e-3
    assert err == 0.0


def test_batched_rows_equal_unbatched():
    sc = TohokuScenario(nx=24, ny=24, t_end=900.0, device=CPU)
    cfg, b, probes = sc.cfg, sc.bathymetry(), sc.probe_indices()
    single = tsolver.make_solver(cfg, b, probes)
    batched = tsolver.make_solver(cfg, b, probes, batch=True)
    thetas = torch.tensor([[0.0, 0.0], [60.0, -40.0], [-90.0, 15.0]])
    etas = torch.stack([sc.displacement(t) for t in thetas])
    series_b, final_b = batched(etas)
    assert series_b.shape == (3, single.n_steps, 2)
    for k in range(3):
        series_1, final_1 = single(etas[k])
        assert torch.equal(series_1, series_b[k])
        for a, c in zip(final_1, final_b):
            assert torch.equal(a, c[k])
    with pytest.raises(ValueError, match="B, ny, nx"):
        batched(etas[0])


def test_scenario_batch_forward_rows_equal_single():
    sc = TohokuScenario(nx=24, ny=24, t_end=900.0, device=CPU)
    single, batched = sc.build_forward(), sc.build_batch_forward()
    thetas = torch.tensor([[0.0, 0.0], [60.0, -40.0], [-90.0, 15.0]])
    got = batched(thetas)
    assert torch.equal(got, torch.stack([single(t) for t in thetas]))
    assert torch.equal(batched(thetas[1:2])[0], got[1])
    series = sc.build_series_forward()(thetas[1])  # probe 0's full series
    assert series.shape == (single.n_steps,)
    assert torch.equal(torch.amax(series), got[1, 0])


def test_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors the kernel wrappers are the plain versions exactly and
    launch nothing."""
    _, tcfg, b, state, dt = _inputs(33, 17, momentum=True)
    st = tsolver.SWEState(*(torch.from_numpy(x) for x in state))
    bt = torch.from_numpy(b)
    before = {k: c.value for k, c in build.COUNTERS.items()}
    want = tsolver.step(st, bt, tcfg, dt)
    for got in (
        swe_ops.swe_step(st, bt, dt, cfg=tcfg),
        swe_ops.swe_step_batched(
            tsolver.SWEState(*(x[None] for x in st)), bt, dt, cfg=tcfg
        ),
    ):
        for a, c in zip(want, got):
            assert torch.equal(a, c.reshape(a.shape))
    assert {k: c.value for k, c in build.COUNTERS.items()} == before


@pytest.mark.parametrize("nx", [32, 48])
def test_scenario_observables_match_reference(nx):
    """Whole-scenario parity.  Probe heights are h + b with h ~ 7 km, so they
    move in steps of one fp32 ulp of h (4.9e-4 m); the grids are rebuilt by
    each framework (their linspace differs in the last ulp), so allow 2e-3
    (four such steps, a twentieth of the height noise)."""
    js = JaxScenario(nx=nx, ny=nx, t_end=2 * 3600.0)
    ts = TohokuScenario(nx=nx, ny=nx, t_end=2 * 3600.0, device=CPU)
    assert ts.probe_indices() == js.probe_indices()
    np.testing.assert_allclose(
        ts.bathymetry().numpy(), np.asarray(js.bathymetry()), rtol=0, atol=2e-3
    )
    fj_raw, ft = js.build_forward(), ts.build_forward()
    assert (ft.n_steps, ft.dt) == (fj_raw.n_steps, fj_raw.dt)
    fj = jax.jit(fj_raw)
    for theta in ([0.0, 0.0], [-120.0, 80.0], [150.0, -60.0]):
        want = np.asarray(fj(jnp.asarray(theta)))
        got = ft(torch.tensor(theta))
        assert got.shape == (4,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def test_y_obs_matches_reference():
    """Same obs_seed, same numpy noise: y_obs agrees to the scenario tolerance."""
    jh = jax_make_hierarchy(
        fine=JaxScenario(nx=32, ny=32, t_end=3600.0),
        coarse=JaxScenario(nx=16, ny=16, t_end=3600.0),
    )
    th = make_hierarchy(
        fine=TohokuScenario(nx=32, ny=32, t_end=3600.0, device=CPU),
        coarse=TohokuScenario(nx=16, ny=16, t_end=3600.0, device=CPU),
    )
    np.testing.assert_allclose(
        th["problem"].y_obs, jh["problem"].y_obs, rtol=0, atol=2e-3
    )
    coarse_t = th["forward_coarse_batch"](torch.tensor([[10.0, -20.0]]))[0].numpy()
    coarse_j = np.asarray(jh["forward_coarse"](jnp.array([10.0, -20.0])))
    np.testing.assert_allclose(coarse_t, coarse_j, rtol=0, atol=2e-3)


def test_dt_override_validated():
    sc = TohokuScenario(nx=24, ny=24, t_end=600.0, device=CPU)
    base = sc.cfg
    cfg = tsolver.SWEConfig(
        nx=base.nx, ny=base.ny, dx=base.dx, dy=base.dy, t_end=base.t_end, dt_override=0.5
    )
    solver = tsolver.make_solver(cfg, sc.bathymetry(), sc.probe_indices())
    assert solver.dt == 0.5 and solver.n_steps == 1200
    bad = tsolver.SWEConfig(
        nx=base.nx, ny=base.ny, dx=base.dx, dy=base.dy, t_end=base.t_end, dt_override=0.0
    )
    with pytest.raises(ValueError, match="dt_override"):
        tsolver.make_solver(bad, sc.bathymetry(), sc.probe_indices())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_swe_kernels_match_plain_on_card(card):
    """Each kernel, one step from the same input, against its plain version."""
    _, tcfg, b, state, dt = _inputs(48, 40, momentum=True)
    st = tsolver.SWEState(*(torch.from_numpy(x).to(card) for x in state))
    bt = torch.from_numpy(b).to(card)
    want = tsolver.step(st, bt, tcfg, dt)
    fused = swe_ops.swe_step_batched(
        tsolver.SWEState(*(x[None].contiguous() for x in st)), bt, dt, cfg=tcfg
    )
    sweep = swe_ops.swe_step(st, bt, dt, cfg=tcfg)
    for a, f, s in zip(want, fused, sweep):
        assert _rel(a.cpu(), f[0].cpu()) < 1e-5
        assert _rel(a.cpu(), s.cpu()) < 1e-5
