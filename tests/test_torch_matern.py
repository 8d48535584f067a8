"""The port's Matérn-5/2 kernel matrix against the JAX reference.

On the CPU the wrapper runs the plain version (direct differences, one row
at a time); it is held at atol 5e-6, the bound of the reference's own
kernel test, against both the reference's jnp ``matern52`` and its Pallas
kernel in interpret mode, on the same numpy inputs.
"""
import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gp import GPParams as JaxParams
from repro.core.gp import matern52 as jax_matern
from repro.kernels.matern.ops import matern52 as pallas_matern
from repro_torch.core.gp import GPParams, matern52 as port_matern_autograd
from repro_torch.kernels.matern import ops
from repro_torch.kernels.matern.ref import matern52_ref

SHAPES = [(16, 16, 2), (64, 128, 2), (130, 70, 5), (17, 33, 11), (512, 512, 2)]


def _case(n, m, d):
    rng = np.random.default_rng(n * m + d)
    x1 = rng.normal(size=(n, d)).astype(np.float32)
    x2 = rng.normal(size=(m, d)).astype(np.float32)
    ls, s = np.full((d,), np.log(0.7), np.float32), np.float32(np.log(1.3))
    jp = JaxParams(jnp.asarray(ls), jnp.asarray(s), jnp.zeros(()))
    tp = GPParams(torch.from_numpy(ls), torch.tensor(s), torch.zeros(()))
    return x1, x2, jp, tp


@pytest.mark.parametrize("n,m,d", SHAPES)
def test_plain_matern_matches_reference(n, m, d):
    x1, x2, jp, tp = _case(n, m, d)
    got = ops.matern52(torch.from_numpy(x1), torch.from_numpy(x2), tp)
    assert got.shape == (n, m) and got.dtype == torch.float32
    for want in (
        jax_matern(jnp.asarray(x1), jnp.asarray(x2), jp),
        pallas_matern(jnp.asarray(x1), jnp.asarray(x2), jp),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-6)


@pytest.mark.parametrize("n,m,d", SHAPES[:3])
def test_differentiable_matern_matches_reference(n, m, d):
    """core.gp.matern52 (training's expanded form) against the reference's."""
    x1, x2, jp, tp = _case(n, m, d)
    got = port_matern_autograd(torch.from_numpy(x1), torch.from_numpy(x2), tp)
    want = jax_matern(jnp.asarray(x1), jnp.asarray(x2), jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-6)


def test_symmetry_and_unit_diagonal():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(48, 3)).astype(np.float32))
    p = GPParams(torch.zeros(3), torch.zeros(()), torch.zeros(()))
    k = ops.matern52(x, x, p)
    assert k.dtype == torch.float32
    np.testing.assert_allclose(k.numpy(), k.numpy().T, atol=1e-6)
    np.testing.assert_allclose(np.diag(k.numpy()), 1.0, atol=1e-5)


def test_rows_do_not_depend_on_row_count():
    """Row i is a function of a[i] alone (the level-0 batch contract): the
    rows of a 6-row call equal six 1-row calls bit for bit."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(6, 2)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(47, 2)).astype(np.float32))
    full = matern52_ref(a, b, 1.3)
    for i in range(6):
        assert torch.equal(matern52_ref(a[i : i + 1], b, 1.3)[0], full[i])


def test_wrapper_rejects_bad_shapes():
    a = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="want"):
        ops.matern52_scaled(a, torch.zeros((5, 3)), 1.0)
    with pytest.raises(ValueError, match="want"):
        ops.matern52_scaled(a[0], torch.zeros((5, 2)), 1.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_matern_kernel_matches_plain_on_card(card, n, m, d):
    x1, x2, _, _ = _case(n, m, d)
    a = torch.from_numpy(x1 / 0.7).to(card)
    b = torch.from_numpy(x2 / 0.7).to(card)
    before = ops.LAUNCHES.value
    got = ops.matern52_scaled(a, b, 1.3)
    assert ops.LAUNCHES.value == before + 1
    want = matern52_ref(a, b, 1.3)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=5e-6)
