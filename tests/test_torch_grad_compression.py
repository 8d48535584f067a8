"""The port's int8 error-feedback gradient compression against the
reference's, on the CPU and in this process.

The reference's own test runs an 8-device subprocess (and is intermittent
in long runs); here the reference's functions run in-process under
``jax.vmap(..., axis_name="data")`` over 8 shards, where ``pmax`` and
``psum`` resolve as across 8 devices, and the port runs on a ``DataMesh``
that lists the CPU 8 times.  ``quantize_int8`` and ``ef_compress_leaf``
agree bit for bit (the same IEEE operations, ``round`` half to even in
both); a whole compressed gradient step within 1e-6 relative (the shards'
gradients come from two autodiff libraries).  Then the reference's
properties: the int8 round trip within half a grid step, a zero tensor,
and error feedback's convergence on its least-squares problem.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.grad_compression import dequantize_int8 as jax_dequantize
from repro.optim.grad_compression import ef_compress_leaf as jax_ef_compress_leaf
from repro.optim.grad_compression import quantize_int8 as jax_quantize
from repro_torch.optim.grad_compression import (
    dequantize_int8,
    ef_compress_leaf,
    init_error_buffers,
    make_compressed_dp_grad_fn,
    quantize_int8,
)
from repro_torch.optim.tree import value_and_grad
from repro_torch.runtime.sharding import DataMesh

N_SHARDS = 8
MESH = DataMesh(["cpu"] * N_SHARDS)


def _ls_problem():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(16, 4)) * 0.1).astype(np.float32)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    w_true = (rng.normal(size=(16, 4)) * 0.5).astype(np.float32)
    y = (x @ w_true + 0.01 * rng.normal(size=(64, 4))).astype(np.float32)
    return w, x, y


def _loss(w, batch):
    xx, yy = batch
    return torch.mean((xx @ w - yy) ** 2)


def _jax_loss(w, batch):
    xx, yy = batch
    return jnp.mean((xx @ w - yy) ** 2)


@pytest.mark.parametrize("scale", [3.0, 1e-3, 0.0])
def test_quantize_matches_reference(scale):
    x = (np.random.default_rng(1).normal(size=(257,)) * scale).astype(np.float32)
    x[:3] = [0.5 * scale, -1.5 * scale, 2.5 * scale]
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq)) and float(s) == float(js)
    back = dequantize_int8(q, s, torch.float32)
    assert np.array_equal(back.numpy(), np.asarray(jax_dequantize(jq, js, jnp.float32)))


def test_quantize_roundtrip_error_bound_and_zero():
    """The reference's two quantiser tests on the port."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(256,)).astype(np.float32) * 3.0)
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s, torch.float32) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6  # half a step of the int8 grid
    q, s = quantize_int8(torch.zeros(8))
    assert float(dequantize_int8(q, s, torch.float32).abs().max()) == 0.0


def test_ef_compress_leaf_matches_reference_over_8_shards():
    rng = np.random.default_rng(2)
    g = (rng.normal(size=(N_SHARDS, 5, 7)) * rng.uniform(0.1, 3.0, (N_SHARDS, 1, 1))
         ).astype(np.float32)
    err = (rng.normal(size=(N_SHARDS, 5, 7)) * 0.01).astype(np.float32)
    jg, jerr = jax.vmap(lambda a, e: jax_ef_compress_leaf(a, e, "data"), axis_name="data")(
        jnp.asarray(g), jnp.asarray(err))
    hats, new_errs = ef_compress_leaf([torch.from_numpy(a) for a in g],
                                      [torch.from_numpy(e) for e in err])
    assert len(hats) == len(new_errs) == N_SHARDS
    for i in range(N_SHARDS):
        assert np.array_equal(hats[i].numpy(), np.asarray(jg[i]))
        assert np.array_equal(new_errs[i].numpy(), np.asarray(jerr[i]))
    # Every shard holds the same reduced gradient.
    assert all(torch.equal(h, hats[0]) for h in hats)


def test_compressed_grad_fn_matches_the_reference_arithmetic():
    """One step of ``make_compressed_dp_grad_fn`` on the 8-entry CPU mesh
    against the reference's per-shard function (its value_and_grad, its
    ``ef_compress_leaf``, ``pmean`` of the loss) under ``jax.vmap`` over
    the 8 batch shards; the new error is the first shard's, as the
    reference's replicated out-spec returns mesh position 0's value."""
    w, x, y = _ls_problem()
    err0 = (np.random.default_rng(3).normal(size=w.shape) * 1e-3).astype(np.float32)

    def per_shard(xs, ys):
        loss, g = jax.value_and_grad(_jax_loss)(jnp.asarray(w), (xs, ys))
        g_hat, new_err = jax_ef_compress_leaf(g, jnp.asarray(err0), "data")
        return jax.lax.pmean(loss, "data"), g_hat, new_err

    jl, jg, je = jax.vmap(per_shard, axis_name="data")(
        jnp.asarray(x).reshape(N_SHARDS, -1, 16), jnp.asarray(y).reshape(N_SHARDS, -1, 4))
    grad_fn = make_compressed_dp_grad_fn(_loss, MESH)
    loss, g_hat, new_err = grad_fn(torch.from_numpy(w), torch.from_numpy(err0),
                                   (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(loss), float(jl[0]), rtol=1e-6)
    scale = float(np.abs(np.asarray(jg[0])).max())
    np.testing.assert_allclose(g_hat.numpy(), np.asarray(jg[0]), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(new_err.numpy(), np.asarray(je[0]), rtol=0, atol=1e-6 * scale)


def test_compressed_allreduce_ef_convergence():
    """The reference's convergence test (``tests/test_grad_compression.py``)
    on the port, its bounds unchanged: one step close to the exact
    gradient, error feedback keeping the average unbiased, and training
    converging with the compressed gradients."""
    w, x, y = (torch.from_numpy(a) for a in _ls_problem())
    grad_fn = make_compressed_dp_grad_fn(_loss, MESH)
    exact = value_and_grad(_loss, w, (x, y))[1]

    _, g_hat, _ = grad_fn(w, init_error_buffers(w), (x, y))
    rel1 = float(torch.linalg.norm(g_hat - exact) / torch.linalg.norm(exact))

    acc, err = torch.zeros_like(w), init_error_buffers(w)
    for _ in range(20):
        _, g_hat, err = grad_fn(w, err, (x, y))
        acc = acc + g_hat
    rel20 = float(torch.linalg.norm(acc / 20 - exact) / torch.linalg.norm(exact))

    w2, err = w, init_error_buffers(w)
    l0 = float(_loss(w2, (x, y)))
    for _ in range(100):
        _, g_hat, err = grad_fn(w2, err, (x, y))
        w2 = w2 - 0.1 * g_hat
    l1 = float(_loss(w2, (x, y)))
    assert rel1 < 0.05
    assert rel20 < rel1 + 0.01
    assert l1 < 0.5 * l0


def test_grad_fn_refuses_what_it_cannot_shard():
    grad_fn = make_compressed_dp_grad_fn(_loss, MESH)
    w = torch.zeros((16, 4))
    with pytest.raises(ValueError, match="does not split"):
        grad_fn(w, init_error_buffers(w), (torch.zeros((12, 16)), torch.zeros((12, 4))))
    with pytest.raises(ValueError, match="axes"):
        make_compressed_dp_grad_fn(_loss, MESH, axis_name="model")
