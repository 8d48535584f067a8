"""The Fig. 6 series GP stage of the port against the JAX package, on the CPU.

The same numpy design goes through the reference's
``jax.lax.map(jax.jit(coarse.build_series_forward()), xs, batch_size=8)``
and through the port's ``build_batch_series_forward`` (the port's LHS is
drawn with torch's generator, so the tests hand both sides one numpy
design).  Series are held at the observables' atol 2e-3 (probe heights move
in fp32 steps of h ~ 7 km, 4.9e-4 m; the grids are rebuilt by each
framework); the series GP from the reference's fitted fields at atol 1e-4
of the reference's prediction; the port's own fit at the loose 3e-2 of two
fp32 Adam runs through different autodiff systems.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gp import fit_gp as jax_fit_gp
from repro.swe import TohokuScenario as JaxScenario
from repro_torch.core.gp import fit_gp, gp_from_arrays
from repro_torch.launch.tsunami import SERIES_GP_BATCH, SERIES_GP_POINTS, SERIES_GP_STEPS
from repro_torch.launch.tsunami import series_gp
from repro_torch.swe import TohokuInverseProblem, TohokuScenario

NX, T_END = 32, 1800.0


@pytest.fixture(scope="module")
def design():
    """The numpy LHS-like design, both series forwards and both sides' series."""
    xs = np.random.default_rng(7).uniform(-200, 200, (SERIES_GP_POINTS, 2)).astype(np.float32)
    js = JaxScenario(nx=NX, ny=NX, t_end=T_END)
    ts = TohokuScenario(nx=NX, ny=NX, t_end=T_END, device="cpu")
    fj = jax.jit(js.build_series_forward())
    want = np.array(jax.lax.map(fj, jnp.asarray(xs), batch_size=SERIES_GP_BATCH))
    fb = ts.build_batch_series_forward()
    got = torch.cat([fb(torch.from_numpy(xs[i : i + SERIES_GP_BATCH]))
                     for i in range(0, SERIES_GP_POINTS, SERIES_GP_BATCH)])
    return xs, ts, fb, want, got


def test_batched_series_matches_reference(design):
    xs, ts, fb, want, got = design
    assert got.shape == (SERIES_GP_POINTS, fb.n_steps) == want.shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def test_batched_series_rows_do_not_depend_on_batch(design):
    """B = 1 rows equal B = 8 rows bit for bit, and equal the single series
    forward's rows (on the CPU both step through the same plain step)."""
    xs, ts, fb, _, got = design
    x8 = torch.from_numpy(xs[:8])
    full = fb(x8)
    assert torch.equal(full, got[:8])
    single = ts.build_series_forward()
    for i in range(8):
        assert torch.equal(fb(x8[i : i + 1])[0], full[i])
        assert torch.equal(single(x8[i]), full[i])
    assert torch.equal(fb.eager(x8[:3]), full[:3])


def _jax_fields(gj):
    fields = {
        "x_train": gj.x_train, "y_train": gj.y_train, "y_mean": gj.y_mean,
        "y_scale": gj.y_scale, "log_lengthscales": gj.params.log_lengthscales,
        "log_outputscale": gj.params.log_outputscale, "log_noise": gj.params.log_noise,
        "chol": gj.chol, "alpha": gj.alpha,
    }
    return {k: np.asarray(v) for k, v in fields.items()}


@pytest.fixture(scope="module")
def series_gps(design):
    xs, _, _, want, _ = design
    gj = jax_fit_gp(xs, want, steps=SERIES_GP_STEPS)
    q = np.random.default_rng(8).uniform(-150, 150, (3, 2)).astype(np.float32)
    return xs, want, gj, q


def test_series_gp_from_reference_fields_matches_reference(series_gps):
    """At p = n_steps outputs (the mean kernel's output tiles): the port's
    prediction from the reference's fitted fields within atol 1e-4."""
    _, want, gj, q = series_gps
    gt = gp_from_arrays(_jax_fields(gj), device="cpu")
    got = gt.predict(torch.from_numpy(q))
    assert got.shape == (3, want.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(gj.predict(jnp.asarray(q))),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(gt(torch.from_numpy(q[0])).numpy(),
                               np.asarray(gj(jnp.asarray(q[0]))), rtol=0, atol=1e-4)


def test_series_gp_fit_matches_reference_loosely(series_gps):
    xs, want, gj, q = series_gps
    gt = fit_gp(xs, want, steps=SERIES_GP_STEPS, device="cpu")
    np.testing.assert_allclose(gt.predict(torch.from_numpy(q)).numpy(),
                               np.asarray(gj.predict(jnp.asarray(q))), rtol=0, atol=3e-2)


def test_series_gp_stage_gives_a_finite_series():
    """The stage as ``run`` calls it: a series of n_steps finite values."""
    coarse = TohokuScenario(nx=16, ny=16, t_end=1200.0, device="cpu")
    prob = TohokuInverseProblem(scenario_fine=coarse)
    gp, series = series_gp(coarse, prob, np.array([10.0, -20.0]), device="cpu")
    n_steps = coarse.build_series_forward().n_steps
    assert gp.x_train.shape == (SERIES_GP_POINTS, 2)
    assert gp.y_train.shape == (SERIES_GP_POINTS, n_steps)
    assert series.shape == (n_steps,) and bool(torch.isfinite(series).all())
