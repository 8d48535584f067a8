"""The port's Matérn-5/2 kernels against the JAX reference.

On the CPU the wrappers run the plain versions (direct differences, one row
at a time).  The matrix is held at atol 5e-6, the bound of the reference's
own kernel test, against both the reference's jnp ``matern52`` and its
Pallas kernel in interpret mode, on the same numpy inputs.  The posterior
mean is held bit for bit against the matrix followed by the contraction,
and its wrapper's checks, which run before any launch, are tested here.
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
from repro_torch.kernels.matern.ref import (
    fixed_order_sum,
    matern52_mean_ref,
    matern52_ref,
    posterior_mean_from_matrix,
    tree_width,
)

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


MEAN_SHAPES = [(8, 512, 2, 4), (1, 512, 2, 4), (5, 300, 3, 4), (3, 1, 2, 2), (4, 70, 5, 1),
               (2, 20, 2, 40)]


def _mean_case(B, n, d, p, seed=0):
    rng = np.random.default_rng(seed + B * n + d * p)
    ls = (100.0 * np.exp(0.3 * rng.normal(size=d))).astype(np.float32)
    x = rng.uniform(-200, 200, (B, d)).astype(np.float32)
    xs = (rng.uniform(-200, 200, (n, d)) / ls).astype(np.float32)
    alpha = rng.normal(size=(n, p)).astype(np.float32)
    y_scale = np.exp(rng.normal(size=p)).astype(np.float32)
    y_mean = rng.normal(size=p).astype(np.float32)
    return [torch.from_numpy(v) for v in (x, ls, xs, alpha, y_scale, y_mean)]


@pytest.mark.parametrize("B,n,d,p", MEAN_SHAPES)
def test_mean_wrapper_equals_matrix_and_contraction(B, n, d, p):
    """On the CPU the mean wrapper has the bits of the matrix followed by
    the elementwise product, the halving sum and the affine step."""
    x, ls, xs, alpha, ys, ym = _mean_case(B, n, d, p)
    got = ops.matern52_mean(x, ls, xs, alpha, ys, ym, 1.3)
    ks = ops.matern52_scaled((x / ls).contiguous(), xs, 1.3)
    assert got.shape == (B, p) and got.dtype == torch.float32
    assert torch.equal(got, posterior_mean_from_matrix(ks, alpha, ys, ym))


@pytest.mark.parametrize("B,n,d,p", MEAN_SHAPES[:3])
def test_mean_rows_do_not_depend_on_row_count(B, n, d, p):
    """B = 1 rows equal B = 8 rows bit for bit (the level-0 batch contract)."""
    x, *rest = _mean_case(8, n, d, p)
    full = ops.matern52_mean(x, *rest, 1.3)
    for i in range(8):
        assert torch.equal(ops.matern52_mean(x[i : i + 1], *rest, 1.3)[0], full[i])


def test_mean_against_matrix_of_reference():
    """The mean from the reference's matrix (expanded form) and the plain
    mean agree within the Matérn bound carried through the sum."""
    x, ls, xs, alpha, ys, ym = _mean_case(6, 128, 2, 4)
    jp = JaxParams(jnp.zeros(2), jnp.asarray(np.log(1.3), jnp.float32), jnp.zeros(()))
    ks = np.asarray(jax_matern(jnp.asarray((x / ls).numpy()), jnp.asarray(xs.numpy()), jp))
    want = (ks[:, :, None] * alpha.numpy()[None]).sum(1) * ys.numpy() + ym.numpy()
    got = matern52_mean_ref(x, ls, xs, alpha, ys, ym, 1.3).numpy()
    bound = 5e-6 * np.abs(alpha.numpy()).sum(0) * ys.numpy() + 1e-5 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("n,want", [(0, 1), (1, 1), (2, 2), (3, 4), (512, 512), (513, 1024)])
def test_tree_width(n, want):
    assert tree_width(n) == want


def test_fixed_order_sum_is_the_halving_order():
    x = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0], dtype=torch.float32)
    # ((1e8 + 3) + (-1e8)) + (1 + 1): the halving tree over 8 padded terms.
    want = ((x[0] + x[4]) + (x[2] + 0.0)) + ((x[1] + 0.0) + (x[3] + 0.0))
    assert torch.equal(fixed_order_sum(x, 0), want)
    y = torch.stack([x, 2 * x, x.flip(0)], dim=1)
    assert torch.equal(fixed_order_sum(y, 0)[0], want)


@pytest.mark.parametrize("case", ["x 1-d", "ls shape", "xs width", "alpha rows",
                                  "y_scale length", "y_mean length"])
def test_mean_wrapper_rejects_bad_shapes(case):
    args = _mean_case(4, 16, 2, 3)
    i, bad = {
        "x 1-d": (0, torch.zeros(2)),
        "ls shape": (1, torch.ones(3)),
        "xs width": (2, torch.zeros((16, 3))),
        "alpha rows": (3, torch.zeros((15, 3))),
        "y_scale length": (4, torch.ones(2)),
        "y_mean length": (5, torch.zeros(4)),
    }[case]
    args[i] = bad
    with pytest.raises(ValueError, match="matern52_mean: want"):
        ops.matern52_mean(*args, 1.0)


@pytest.mark.parametrize("i", range(6))
def test_mean_wrapper_rejects_other_dtypes(i):
    args = _mean_case(4, 16, 2, 3)
    args[i] = args[i].double()
    with pytest.raises(TypeError, match="float32"):
        ops.matern52_mean(*args, 1.0)


@pytest.mark.parametrize("n,p,fits", [(512, 4, True), (2048, 6, True), (2048, 7, False),
                                      (3000, 3, True), (3000, 4, False), (12288, 1, False),
                                      (8192, 1, True)])
def test_mean_wrapper_takes_trees_over_the_shared_memory_budget(n, p, fits):
    """No shape is refused: trees that fit the budget whole and trees that
    do not (``fits``) both return ``(1, p)`` with the bits of the matrix
    followed by the contraction, on the CPU."""
    x, ls, xs, alpha, ys, ym = _mean_case(1, n, 2, p)
    assert (4 * tree_width(n) * p <= ops.MEAN_SMEM_BYTES) == fits
    got = ops.matern52_mean(x, ls, xs, alpha, ys, ym, 1.0)
    ks = ops.matern52_scaled((x / ls).contiguous(), xs, 1.0)
    assert got.shape == (1, p)
    assert torch.equal(got, posterior_mean_from_matrix(ks, alpha, ys, ym))


PLAN_CASES = [(512, 4), (32, 519), (4096, 4), (5000, 37), (2048, 7), (3000, 4), (12288, 1),
              (8192, 1), (1, 1), (0, 3), (10**6, 3), (20000, 100), (300, 4), (20, 40)]


@pytest.mark.parametrize("n,p", PLAN_CASES)
def test_mean_plan_fits_the_budget(n, p):
    """The plan's trees fit the budget, its tiles cover p, and register
    levels come only with tiles of at most the kernel's register tile."""
    qt, levels = ops.mean_plan(n, p)
    assert 1 <= qt <= max(p, 1) and 0 <= levels <= 30
    assert (tree_width(n) >> levels) >= 1
    assert 4 * (tree_width(n) >> levels) * qt <= ops.MEAN_SMEM_BYTES
    tiles = -(-p // qt)
    assert (tiles - 1) * qt < p <= tiles * qt or p == 0
    if levels:
        assert qt <= ops.MEAN_REG_TILE
        assert 4 * (tree_width(n) >> (levels - 1)) * qt > ops.MEAN_SMEM_BYTES


def test_mean_plan_limits_match_the_kernel_source():
    """The plan's register tile is the kernel's, and its levels stay within
    the kernel's stack of partial sums."""
    import re

    from repro_torch.kernels import build

    src = (build.CSRC / "matern.cu").read_text()
    assert int(re.search(r"constexpr int kRegTile = (\d+);", src).group(1)) == ops.MEAN_REG_TILE
    max_levels = int(re.search(r"constexpr int kMaxLevels = (\d+);", src).group(1))
    assert ops.mean_plan(2**30, 7)[1] <= max_levels


@pytest.mark.parametrize("n,p,plan", [(512, 4, (4, 0)), (32, 519, (260, 0)), (4096, 4, (4, 1)),
                                      (5000, 37, (4, 2))])
def test_mean_plan_at_the_checked_shapes(n, p, plan):
    """The main path's shape keeps one tile and no register level (the
    kernel's path before the repair); the Fig. 6 shape takes two tiles,
    n = 4096 one register level, and (5000, 37) both means at once."""
    assert ops.mean_plan(n, p) == plan


def _kernel_order_sum(terms: torch.Tensor, levels: int) -> torch.Tensor:
    """The mean kernel's summation of ``terms`` (n, q) over n, written out:
    each slot's register levels (terms j + m width in bit-reversed order of
    m, merged on a stack), then the shared-memory halving tree."""
    n, nq = terms.shape
    width = tree_width(n) >> levels
    slots = []
    for j in range(width):
        stack = []
        for r in range(1 << levels):
            m = int(format(r, f"0{levels}b")[::-1], 2) if levels else 0
            jj = j + m * width
            stack.append(terms[jj] if jj < n else torch.zeros(nq))
            c = r + 1
            while c % 2 == 0:
                top = stack.pop()
                stack[-1] = stack[-1] + top
                c //= 2
        slots.append(stack[0])
    s = torch.stack(slots)
    while s.shape[0] > 1:
        half = s.shape[0] // 2
        s = s[:half] + s[half:]
    return s[0]


@pytest.mark.parametrize("n,levels", [(n, lv) for n in (1, 3, 17, 100, 300, 513)
                                      for lv in (0, 1, 2, 4) if tree_width(n) >> lv >= 1])
def test_register_levels_keep_the_halving_order(n, levels):
    """The kernel's register levels followed by its tree add the same pairs
    in the same order as ``fixed_order_sum``: the same bits, on terms of
    widely different sizes (where another order would change them)."""
    g = torch.Generator().manual_seed(n * 10 + levels)
    terms = torch.randn((n, 3), generator=g) * torch.exp(4 * torch.randn((n, 1), generator=g))
    assert torch.equal(_kernel_order_sum(terms, levels), fixed_order_sum(terms, 0))


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


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,d,p", MEAN_SHAPES)
def test_mean_kernel_matches_plain_on_card(card, B, n, d, p):
    """The mean kernel against its plain version within the Matérn bound
    carried through the sum, and bit for bit against the matrix kernel and
    the contraction on the card."""
    args = [t.to(card) for t in _mean_case(B, n, d, p)]
    x, ls, xs, alpha, ys, ym = args
    before, before_p = ops.MEAN_LAUNCHES.value, ops.mean_launches_at(p).value
    got = ops.matern52_mean(*args, 1.3)
    assert ops.MEAN_LAUNCHES.value == before + 1
    assert ops.mean_launches_at(p).value == before_p + 1
    want = matern52_mean_ref(*args, 1.3)
    bound = 5e-6 * alpha.abs().sum(0) * ys
    assert bool(((got - want).abs() <= bound).all())
    ks = ops.matern52_scaled((x / ls).contiguous(), xs, 1.3)
    assert torch.equal(got, posterior_mean_from_matrix(ks, alpha, ys, ym))


def test_matern_source_builds_without_fma_contraction():
    """The mean kernel's bits are those of separately rounded products and
    sums, so its source is built as the SWE source is: no FMA contraction."""
    from repro_torch.kernels import build

    assert "--fmad=false" in build.KernelLibrary.flags("matern")
    assert "--fmad=false" in build.KernelLibrary.flags("swe_flux")
