"""The port's model protocol and MALA against the JAX package.

``TorchModel`` (``repro_torch.core.model``) against ``JaxModel`` on the same
numpy inputs: values, batched values, gradients and Jacobians in float32;
the reference's three MALA tests (``tests/test_mala.py``) against the port's
``mala`` with the reference's bounds; the quickstart's port on the CPU; and
the kernels' refusal to run under autograd or ``torch.func``.
"""
import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.model import JaxModel
from repro_torch.balancer import LoadBalancer, Server
from repro_torch.core import (
    GaussianRandomWalk,
    LogDensityModel,
    ModelInfo,
    TorchModel,
    metropolis_hastings,
)
from repro_torch.core.diagnostics import effective_sample_size
from repro_torch.core.mala import BalancedGradDensity, mala
from repro_torch.kernels import build
from repro_torch.launch import quickstart

CPU = "cpu"
VALUE_ATOL = 1e-6  # float32 through the same elementary functions
DERIV_ATOL = 1e-5  # derivatives: the same, through two autodiff systems


def _jax_nonlinear(t):
    return jnp.stack([jnp.sin(t[0]) * jnp.exp(t[1]), t[0] * t[1], jnp.exp(-t[0]) + t[1] ** 2])


def _torch_nonlinear(t):
    return torch.stack([torch.sin(t[0]) * torch.exp(t[1]), t[0] * t[1],
                        torch.exp(-t[0]) + t[1] ** 2])


MAPS = {
    "shift": (lambda t: t + 0.25, lambda t: t + 0.25, 2),
    "nonlinear": (_jax_nonlinear, _torch_nonlinear, 3),
}


def _pair(name):
    fj, ft, m = MAPS[name]
    jm = JaxModel(fj, name=name, input_dim=2, output_dim=m)
    tm = TorchModel(ft, name=name, input_dim=2, output_dim=m, device=CPU)
    return jm, tm


def _thetas(n=5, seed=0):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (n, 2)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(MAPS))
def test_call_and_batch_match_jax_model(name):
    jm, tm = _pair(name)
    thetas = _thetas()
    for th in thetas:
        got = tm(th)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(jm(th)), rtol=0, atol=VALUE_ATOL)
    got = tm.evaluate_batch(thetas)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.evaluate_batch(thetas)),
                               rtol=0, atol=VALUE_ATOL)
    assert tm.n_calls == jm.n_calls == 2 * len(thetas)


@pytest.mark.parametrize("name", sorted(MAPS))
def test_gradient_and_jacobian_match_jax_model(name):
    jm, tm = _pair(name)
    for th in _thetas(seed=1):
        np.testing.assert_allclose(tm.gradient(th).numpy(), np.asarray(jm.gradient(th)),
                                   rtol=0, atol=DERIV_ATOL)
        np.testing.assert_allclose(tm.jacobian(th).numpy(), np.asarray(jm.jacobian(th)),
                                   rtol=0, atol=DERIV_ATOL)


def test_model_info_and_derivative_switch():
    tm = TorchModel(lambda t: t, name="id", input_dim=2, output_dim=2,
                    with_derivatives=False, device=CPU)
    assert tm.info == ModelInfo("id", 2, 2, False, False, False)
    with pytest.raises(NotImplementedError, match="gradients"):
        tm.gradient(np.zeros(2))
    with pytest.raises(NotImplementedError, match="Jacobians"):
        tm.jacobian(np.zeros(2))


def test_model_defaults_to_the_card():
    make = lambda: TorchModel(lambda t: t, name="id", input_dim=2, output_dim=2)  # noqa: E731
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_log_density_model_short_circuits_outside_prior():
    calls = []
    fwd = TorchModel(lambda t: t, name="id", input_dim=2, output_dim=2, device=CPU)

    def forward(t):
        calls.append(1)
        return fwd(t)

    ld = LogDensityModel(
        "post", forward,
        lambda obs: -0.5 * float(torch.sum((obs - 1.0) ** 2)),
        lambda t: 0.0 if np.all(np.abs(t) < 2) else float("-inf"),
    )
    assert ld(np.array([5.0, 0.0])) == float("-inf") and not calls
    assert ld(np.array([1.0, 0.0])) == pytest.approx(-0.5)
    assert len(calls) == 1


def test_kernel_wrappers_refuse_autograd_and_transforms():
    """No CUDA kernel has a backward or a batching rule: a launch under
    autograd or torch.func raises, never running the plain version."""
    plain = torch.ones(3)
    build.require_plain([plain], "k")
    with pytest.raises(RuntimeError, match="no backward"):
        build.require_plain([plain.clone().requires_grad_(True)], "k")
    for transform in (torch.func.grad, torch.func.jacfwd):
        with pytest.raises(RuntimeError, match="no backward"):
            transform(lambda t: (build.require_plain([t], "k"), t.sum())[1])(plain)
    with pytest.raises(RuntimeError, match="batching rule"):
        torch.func.vmap(lambda t: (build.require_plain([t], "k"), t)[1])(torch.ones(2, 3))


# -- MALA: the reference's tests against the port -----------------------------
def test_mala_targets_standard_normal():
    rng = np.random.default_rng(0)
    value = lambda t: float(-0.5 * np.sum(t**2))  # noqa: E731
    grad = lambda t: -np.asarray(t)  # noqa: E731
    chain, stats = mala(value, grad, np.zeros(2), 6000, rng, eps=0.8)
    x = chain[1500:]
    assert np.all(np.abs(x.mean(0)) < 0.12)
    assert np.all(np.abs(x.var(0) - 1.0) < 0.2)
    assert 0.3 < stats.acceptance_rate < 0.9
    assert stats.n_evals >= 2 * stats.n_proposed  # value + grad per step


def test_mala_beats_rwm_on_anisotropic_target():
    """Gradient information should raise ESS on a badly-scaled target."""
    scales = np.array([1.0, 0.05])
    value = lambda t: float(-0.5 * np.sum((np.asarray(t) / scales) ** 2))  # noqa: E731
    grad = lambda t: -np.asarray(t) / scales**2  # noqa: E731

    rng = np.random.default_rng(1)
    mala_chain, _ = mala(value, grad, np.zeros(2), 4000, rng, eps=0.05)
    rng = np.random.default_rng(1)
    rwm_chain, _, _ = metropolis_hastings(
        value, GaussianRandomWalk(0.05), np.zeros(2), 4000, rng
    )
    assert effective_sample_size(mala_chain[500:, 0]) > effective_sample_size(rwm_chain[500:, 0])


def test_mala_through_balancer_with_separate_pools():
    """Value and gradient requests carry different tags; here the pools
    serve TorchModels, whose gradients come back as tensors."""
    post = TorchModel(lambda t: -0.5 * torch.sum(t * t), name="post", input_dim=2,
                      output_dim=1, device=CPU)
    lb = LoadBalancer(
        [
            Server(post, name="val-0", capacity_tags=("post:value",)),
            Server(post.gradient, name="grad-0", capacity_tags=("post:grad",)),
        ]
    )
    try:
        dens = BalancedGradDensity(lb, "post", post, post.gradient)
        rng = np.random.default_rng(2)
        chain, stats = mala(dens.value, dens.grad, np.zeros(2), 200, rng, eps=0.8)
        ups = lb.summary()["per_server_uptime"]
        tags = {row["tag"] for row in lb.stats_table()}
    finally:
        lb.shutdown()
    assert np.all(np.isfinite(chain))
    assert ups["val-0"] > 0 and ups["grad-0"] > 0  # both pools exercised
    assert tags == {"post:value", "post:grad"}
    assert stats.n_evals >= 2 * stats.n_proposed


def test_quickstart_runs_on_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "MLDA via balancer (policy=fifo)" in printed and "vectorised MLDA" in printed
    assert out["mlda_chain"].shape == (100, 2) and np.isfinite(out["mlda_chain"]).all()
    vec = out["vectorised"].chain
    assert vec.shape == (quickstart.N_VECTOR_CHAINS, quickstart.N_VECTOR_STEPS, 2)
    # The posterior is N(y, 0.1 I): 8 x 150 correlated samples put the mean
    # within a few of its standard errors (0.316 / sqrt(ESS)).
    mean = vec[:, 50:].reshape(-1, 2).mean(0).numpy()
    assert np.all(np.abs(mean - quickstart.Y_OBS) < 0.2)
