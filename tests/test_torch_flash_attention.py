"""The port's attention against the JAX reference's flash-attention kernel.

On the CPU the ``"kernel"`` implementation runs the plain version
(``attention_ref``), so the plain version and the plain blocked loop
(``attention_chunked``) are each held against the reference's Pallas kernel
in interpret mode and against its jnp oracle, on the same numpy inputs,
over the reference's six test cases.  Tolerances are the reference's own
kernel bounds (``tests/test_kernels.py``): fp32 atol 3e-5, since the two
frameworks sum the score and PV products in different orders (~1e-6 of
scores of size ~10, through the softmax); bf16 atol 3e-2, a little over one
rounding step of bf16 outputs of size 2 to 4, which are rounded at other
places in the two frameworks (scores, p and the output).  The CUDA kernel
itself is held against the plain version by the ``gpu``-marked test, which
skips here.
"""
import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.chunked_attention import attention_chunked

CASES = [
    (2, 4, 2, 128, 64, True, None),
    (1, 8, 8, 256, 32, True, None),
    (2, 4, 1, 200, 64, True, None),  # unaligned seq, MQA
    (1, 4, 2, 256, 64, False, None),
    (1, 4, 2, 384, 64, True, 128),  # sliding window
    (1, 2, 2, 512, 128, True, 256),
    # Beyond the reference's cases: a ragged non-causal length (the whisper
    # encoder's path) and nemotron's head dim 192.
    (1, 4, 4, 300, 64, False, None),
    (1, 4, 2, 256, 192, True, None),
    (1, 4, 2, 384, 192, True, 128),
    (1, 2, 2, 300, 192, False, None),
]
FP32_ATOL = 3e-5
BF16_ATOL = 3e-2


def _inputs(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _jax_witnesses(q, k, v, causal, window):
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    return (
        np.asarray(jax_attention(jq, jk, jv, causal=causal, window=window, impl="pallas")),
        np.asarray(jax_attention_ref(jq, jk, jv, causal=causal, window=window)),
    )


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", CASES)
def test_plain_attention_matches_reference(b, h, hkv, s, d, causal, window):
    q, k, v = _inputs(b, h, hkv, s, d, seed=b * s + h)
    got = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal, window=window)
    for want in _jax_witnesses(q, k, v, causal, window):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", CASES)
def test_chunked_attention_matches_reference(b, h, hkv, s, d, causal, window):
    q, k, v = _inputs(b, h, hkv, s, d, seed=b * s + h + 1)
    got = attention_chunked(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=causal, window=window, block_k=128)
    for want in _jax_witnesses(q, k, v, causal, window):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("impl", ["plain", "chunked"])
def test_bf16_matches_reference_kernel(impl):
    """bf16 inputs: the port against the reference's Pallas kernel on the
    same bf16 values, and against the fp32 oracle of those values."""
    q, k, v = (x.astype(ml_dtypes.bfloat16) for x in _inputs(1, 2, 2, 128, 64, seed=9))
    tq, tk, tv = (torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
                  for x in (q, k, v))
    fn = attention_ref if impl == "plain" else attention_chunked
    got = fn(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kernel = np.asarray(jax_attention(jq, jk, jv, impl="pallas"), np.float32)
    oracle = np.asarray(jax_attention_ref(*(x.astype(jnp.float32) for x in (jq, jk, jv))))
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BF16_ATOL)


def test_dispatch_follows_the_reference():
    """"xla" and "kernel" on CPU tensors run the plain version; "chunked"
    and unequal query/key lengths run the blocked loop."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 96, 32, seed=3))
    plain = attention_ref(q, k, v)
    assert torch.equal(ops.attention(q, k, v, impl="xla"), plain)
    assert torch.equal(ops.attention(q, k, v, impl="kernel"), plain)
    assert torch.equal(ops.attention(q, k, v, impl="chunked"), attention_chunked(q, k, v))
    q_short = q[:, :, :40].contiguous()
    assert torch.equal(
        ops.attention(q_short, k, v, causal=False, impl="kernel"),
        attention_chunked(q_short, k, v, causal=False),
    )
    with pytest.raises(ValueError, match="impl"):
        ops.attention(q, k, v, impl="pallas")


def test_kernel_wrapper_refuses_what_the_kernel_cannot_take():
    """The wrapper raises, never falls back: CPU tensors, head dims without a
    kernel instance, GQA shapes that do not divide, bad windows."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 64, 64, seed=4))
    with pytest.raises(ValueError, match="same card"):
        ops.flash_attention(q, k, v)
    q16, k16, v16 = (torch.zeros(shape) for shape in ((1, 4, 64, 16), (1, 2, 64, 16), (1, 2, 64, 16)))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q16, k16, v16)
    with pytest.raises(ValueError, match="disagree"):
        ops.flash_attention(q[:, :3], k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), k.double(), v.double())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", CASES)
def test_flash_kernel_matches_plain_on_card(card, dtype, b, h, hkv, s, d, causal, window):
    q, k, v = (torch.from_numpy(x).to(card, getattr(torch, dtype))
               for x in _inputs(b, h, hkv, s, d, seed=s + d))
    counter = ops.LAUNCHES[ops.route(q.dtype, d)]
    before = counter.value
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert counter.value == before + 1
    # The plain blocked loop has the kernel's arithmetic (fp32 scores, p
    # rounded to the input type); the fp32 bound is the reference's.
    want = attention_chunked(q, k, v, causal=causal, window=window)
    atol = FP32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=0, atol=atol)
