"""The port's GP surrogate against the JAX reference, on the same numpy data.

The NLL and its gradient at fixed parameters are compared tightly; a fit
on the same design loosely (200 fp32 Adam steps through two autodiff
systems drift apart); predictions from the same fitted fields
(``gp_from_arrays``) tightly.  Also the numeric traps of the port:
median, std, float64 inputs and a failed Cholesky.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gp import GPParams as JaxParams
from repro.core.gp import fit_gp as jax_fit_gp
from repro.core.gp import neg_log_marginal_likelihood as jax_nll
from repro_torch.core.gp import (
    GP_FIELDS,
    GPParams,
    _median,
    fit_gp,
    gp_from_arrays,
    neg_log_marginal_likelihood,
)
from repro_torch.core.lhs import latin_hypercube, scale_to_bounds
from repro_torch.kernels.matern import ops as matern_ops
from repro_torch.kernels.matern.ref import (
    matern52_mean_ref,
    matern52_ref,
    posterior_mean_from_matrix,
)

CPU = "cpu"


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-200, 200, (n, 2)).astype(np.float32)
    y = np.stack(
        [np.sin(x[:, 0] / 90), np.cos(x[:, 1] / 70), x[:, 0] * x[:, 1] / 4e4,
         np.tanh(x[:, 0] / 150)], axis=1,
    ).astype(np.float32)
    return x, y


def _params(d=2):
    ls = np.log(np.array([80.0, 120.0][:d], np.float32))
    return np.float32(0.3), np.float32(np.log(1e-2)), ls


def test_nll_and_gradient_match_reference():
    x, y = _data()
    y = (y - y.mean(0)) / y.std(0)
    s, noise, ls = _params()
    jp = JaxParams(jnp.asarray(ls), jnp.asarray(s), jnp.asarray(noise))
    want, gj = jax.value_and_grad(jax_nll)(jp, jnp.asarray(x), jnp.asarray(y))
    tp = [torch.tensor(v, requires_grad=True) for v in (ls, s, noise)]
    got = neg_log_marginal_likelihood(GPParams(*tp), torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(got, tp)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    for g, w in zip(grads, (gj.log_lengthscales, gj.log_outputscale, gj.log_noise)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3, atol=1e-2)


def test_fit_gp_matches_reference_loosely():
    x, y = _data(96, seed=1)
    gj = jax_fit_gp(x, y, steps=60)
    gt = fit_gp(x, y, steps=60, device=CPU)
    np.testing.assert_allclose(
        gt.params.log_lengthscales.numpy(), np.asarray(gj.params.log_lengthscales),
        atol=0.05,
    )
    q = np.random.default_rng(2).uniform(-180, 180, (16, 2)).astype(np.float32)
    want = np.asarray(gj.predict(jnp.asarray(q)))
    got = gt.predict(torch.from_numpy(q)).numpy()
    # outputs are O(1); two fits of the same design agree to a few 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)


def test_gp_from_arrays_reproduces_reference_predictions():
    x, y = _data(80, seed=3)
    gj = jax_fit_gp(x, y, steps=30)
    fields = {
        "x_train": gj.x_train, "y_train": gj.y_train, "y_mean": gj.y_mean,
        "y_scale": gj.y_scale, "log_lengthscales": gj.params.log_lengthscales,
        "log_outputscale": gj.params.log_outputscale, "log_noise": gj.params.log_noise,
        "chol": gj.chol, "alpha": gj.alpha,
    }
    gt = gp_from_arrays({k: np.asarray(v) for k, v in fields.items()}, device=CPU)
    assert set(fields) == set(GP_FIELDS)
    q = np.random.default_rng(4).uniform(-200, 200, (12, 2)).astype(np.float32)
    want_m, want_v = gj.predict(jnp.asarray(q), return_var=True)
    got_m, got_v = gt.predict(torch.from_numpy(q), return_var=True)
    # Same fields: differences are the kernel's distance form (direct vs
    # expanded) and the summation order of the posterior mean.
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(
        gt(torch.from_numpy(q[0])).numpy(), np.asarray(gj(jnp.asarray(q[0]))), atol=1e-4
    )
    with pytest.raises(KeyError, match="alpha"):
        gp_from_arrays({k: v for k, v in fields.items() if k != "alpha"}, device=CPU)


def _reference_fields(seed):
    x, y = _data(80, seed=seed)
    gj = jax_fit_gp(x, y, steps=30)
    fields = {
        "x_train": gj.x_train, "y_train": gj.y_train, "y_mean": gj.y_mean,
        "y_scale": gj.y_scale, "log_lengthscales": gj.params.log_lengthscales,
        "log_outputscale": gj.params.log_outputscale, "log_noise": gj.params.log_noise,
        "chol": gj.chol, "alpha": gj.alpha,
    }
    return gj, {k: np.asarray(v) for k, v in fields.items()}


@pytest.mark.parametrize("seed,batch", [(3, 12), (7, 1), (11, 8)])
def test_plain_mean_matches_reference_predict(seed, batch):
    """The posterior-mean kernel's plain version on the reference's fitted
    fields against the reference's predict, at the bound of
    ``test_gp_from_arrays_reproduces_reference_predictions``."""
    gj, f = _reference_fields(seed)
    ls = np.exp(f["log_lengthscales"])
    q = np.random.default_rng(seed + 1).uniform(-200, 200, (batch, 2)).astype(np.float32)
    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in f.items()}
    got = matern52_mean_ref(
        torch.from_numpy(q), torch.from_numpy(ls), t["x_train"] / torch.from_numpy(ls),
        t["alpha"], t["y_scale"], t["y_mean"], float(np.exp(f["log_outputscale"])),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(gj.predict(jnp.asarray(q))),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("batch", [1, 5, 8])
def test_predict_equals_matrix_and_contraction_bit_for_bit(batch):
    """``predict`` (the posterior-mean wrapper) has the bits of the matrix
    kernel followed by the elementwise product, the halving sum and the
    affine step, which is how it computed the mean before."""
    _, f = _reference_fields(3)
    gt = gp_from_arrays(f, device=CPU)
    q = torch.from_numpy(np.random.default_rng(9).uniform(-200, 200, (batch, 2)).astype(np.float32))
    ls = torch.exp(gt.params.log_lengthscales)
    ks = matern52_ref(q / ls, gt.x_train / ls, float(torch.exp(gt.params.log_outputscale)))
    want = posterior_mean_from_matrix(ks, gt.alpha, gt.y_scale, gt.y_mean)
    assert torch.equal(gt.predict(q), want)
    assert torch.equal(gt.predict(q, return_var=True)[0], want)


def test_predict_goes_through_the_mean_wrapper(monkeypatch):
    """Without ``return_var`` the mean comes from ``matern52_mean`` alone;
    the matrix wrapper is called only for the variance."""
    _, f = _reference_fields(3)
    gt = gp_from_arrays(f, device=CPU)
    calls = []
    for name in ("matern52_mean", "matern52_scaled"):
        fn = getattr(matern_ops, name)
        monkeypatch.setattr(matern_ops, name,
                            lambda *a, _fn=fn, _n=name: (calls.append(_n), _fn(*a))[1])
    q = torch.zeros((3, 2))
    gt.batch_call(q)
    gt(q[0])
    assert calls == ["matern52_mean", "matern52_mean"]
    calls.clear()
    gt.predict(q, return_var=True)
    assert calls == ["matern52_mean", "matern52_scaled"]


def test_predict_passes_the_plan_made_once(monkeypatch):
    """The GP plans its mean kernel once, at construction, for its (n, p),
    and hands that plan to every ``matern52_mean`` call."""
    _, f = _reference_fields(3)
    made = []
    plan = matern_ops.mean_plan
    monkeypatch.setattr(matern_ops, "mean_plan", lambda n, p: (made.append((n, p)), plan(n, p))[1])
    gt = gp_from_arrays(f, device=CPU)
    n, p = gt.alpha.shape
    assert made == [(n, p)]
    seen = []
    mean = matern_ops.matern52_mean
    monkeypatch.setattr(matern_ops, "matern52_mean",
                        lambda *a: (seen.append(a[-1]), mean(*a))[1])
    for _ in range(3):
        gt.batch_call(torch.zeros((2, 2)))
    assert seen == [plan(n, p)] * 3 and made == [(n, p)]


def test_batch_call_rows_bit_identical():
    x, y = _data(48, seed=5)
    gp = fit_gp(x, y, steps=20, device=CPU)
    thetas = torch.from_numpy(np.random.default_rng(6).uniform(-150, 150, (6, 2)).astype(np.float32))
    got = gp.batch_call(thetas)
    want = torch.stack([gp(t) for t in thetas])
    assert torch.equal(got, want)


def test_median_of_even_count_averages_middles():
    x = torch.tensor([[1.0, 5.0], [2.0, 6.0], [3.0, 7.0], [4.0, 9.0]])
    np.testing.assert_allclose(_median(x, 0).numpy(), np.asarray(jnp.median(jnp.asarray(x.numpy()), 0)))
    np.testing.assert_allclose(_median(x, 0).numpy(), [2.5, 6.5])


def test_std_is_population_std():
    x = np.array([[1.0, 5.0], [2.0, 6.0], [3.0, 7.0], [4.0, 9.0]], np.float32)
    gp = fit_gp(x, x, steps=1, device=CPU)
    np.testing.assert_allclose(gp.y_scale.numpy(), np.asarray(jnp.std(jnp.asarray(x), 0)), rtol=1e-6)
    np.testing.assert_allclose(gp.y_scale.numpy(), [1.118034, 1.4790199], rtol=1e-6)


def test_float64_inputs_become_float32():
    x, y = _data(32)
    gp = fit_gp(x.astype(np.float64), y.astype(np.float64), steps=2, device=CPU)
    for t in (gp.x_train, gp.y_train, gp.chol, gp.alpha, *gp.params):
        assert t.dtype == torch.float32
    out = gp.batch_call(torch.from_numpy(x[:3].astype(np.float64)))
    assert out.dtype == torch.float32


def test_failed_cholesky_gives_nan_and_ladder_recovers():
    """torch.linalg.cholesky raises where the reference's returns NaN: the
    port uses cholesky_ex, so a non-factorisable matrix gives a NaN loss,
    and the jitter ladder still factorises a singular design."""
    x, y = _data(16)
    s, _, ls = _params()
    tp = GPParams(torch.from_numpy(ls), torch.tensor(s), torch.tensor(-30.0))
    nll = neg_log_marginal_likelihood(tp, torch.from_numpy(x), torch.from_numpy(y), jitter=-5.0)
    assert torch.isnan(nll)
    xd = np.repeat(x[:8], 4, axis=0)  # every point four times: singular kernel
    yd = np.repeat(y[:8], 4, axis=0)
    gp = fit_gp(xd, yd, steps=5, init_noise=1e-12, device=CPU)
    assert bool(torch.isfinite(gp.chol).all()) and bool(torch.isfinite(gp.alpha).all())


def test_latin_hypercube_strata():
    u = latin_hypercube(torch.Generator().manual_seed(0), 64, 3)
    assert u.shape == (64, 3) and u.dtype == torch.float32
    strata = torch.floor(u * 64).long()
    for col in strata.T:
        assert sorted(col.tolist()) == list(range(64))
    x = scale_to_bounds(u, np.array([-200.0, -200.0, 0.0]), np.array([200.0, 200.0, 1.0]))
    assert x.dtype == torch.float32 and float(x[:, 0].min()) >= -200.0


def _wide_fields(n, p, steps):
    """The reference GP fitted on ``n`` points with ``p`` smooth outputs
    (series-like in the output index), and its fields as numpy arrays."""
    rng = np.random.default_rng(n + p)
    x = rng.uniform(-200, 200, (n, 2)).astype(np.float32)
    t = np.linspace(0.0, 1.0, p, dtype=np.float32)
    y = (np.sin(x[:, :1] / 90 + 6 * t) * np.exp(-((x[:, 1:] / 150) ** 2) - t)).astype(np.float32)
    gj = jax_fit_gp(x, y, steps=steps)
    fields = {
        "x_train": gj.x_train, "y_train": gj.y_train, "y_mean": gj.y_mean,
        "y_scale": gj.y_scale, "log_lengthscales": gj.params.log_lengthscales,
        "log_outputscale": gj.params.log_outputscale, "log_noise": gj.params.log_noise,
        "chol": gj.chol, "alpha": gj.alpha,
    }
    return x, y, gj, {k: np.asarray(v) for k, v in fields.items()}


@pytest.mark.parametrize("n,p,steps", [(32, 519, 10), (4096, 4, 0)])
def test_predict_over_the_shared_memory_budget_matches_reference(n, p, steps):
    """Shapes whose summation tree exceeds the mean kernel's shared memory
    (the Fig. 6 series GP's p = 519; n = 4096 training points): the port's
    ``fit_gp(...).predict`` returns them, and its prediction from the
    reference's fitted fields is within atol 1e-4 of the reference's."""
    x, y, gj, f = _wide_fields(n, p, steps)
    q = np.random.default_rng(p).uniform(-150, 150, (3, 2)).astype(np.float32)
    gt = gp_from_arrays(f, device=CPU)
    got = gt.predict(torch.from_numpy(q))
    assert got.shape == (3, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(gj.predict(jnp.asarray(q))),
                               rtol=0, atol=1e-4)
    own = fit_gp(x, y, steps=0, device=CPU).predict(torch.from_numpy(q))
    assert own.shape == (3, p) and bool(torch.isfinite(own).all())
