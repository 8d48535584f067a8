"""Counter-mode random numbers: Philox-4x32-10 in plain torch integer ops.

The port's counterpart of the reference's ``jax.random.fold_in(key,
counter)`` on threefry (``repro/core/mlda_jax.py``): every draw of a chain
is a pure function of the chain's key and a draw counter, so a fused
``(C,)``-wide chain ensemble and ``C`` independent step machines consume the
same stream whatever ``C`` is and wherever a chain sits in the batch.  The
stream is not jax's: the two frameworks' bits are not meant to agree.

Philox-4x32-10 (Salmon et al., SC'11, the Random123 generator): a 4-word
counter ``(counter_lo, counter_hi, block, 0)`` and a 2-word key, ten rounds
of two 32 x 32 -> 64-bit products.  torch has no complete ``uint32``
arithmetic on CUDA, so words live in ``int64`` tensors and the products are
taken in 16-bit limbs, where no partial product or sum overflows.

The transforms from words to numbers use only integer operations and
IEEE-rounded float64 ``+ - * /`` and ``sqrt`` (no ``exp``, ``log`` or
``erfinv`` from a library), each one torch operation.  A library's
transcendental may round differently in a vectorised body and in a scalar
tail (the CPU's does), which would make a chain's numbers depend on where it
sits in the batch; these transforms give the same bits at every position,
on the CPU and on the card alike:

* ``uniform``: the top 24 bits of word 0, times 2^-24 (float32, [0, 1));
* ``integers(lo, hi)``: ``lo + (word0 * (hi - lo)) >> 32``;
* ``normal``: the inverse normal CDF (Acklam's rational approximation,
  relative error < 1.2e-9) of ``(word + 0.5) 2^-32``, one word per value,
  rounded once to float32; its tails take :func:`log_f64`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10
# The fourth counter word of the key derivation: chain keys and draws never
# share a Philox input.
KEY_DOMAIN = 0x6B657973

_LN2 = math.log(2.0)
_SQRT_HALF = math.sqrt(0.5)
# Acklam's inverse normal CDF: central rational a/b, tail rational c/d.
_A = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
      1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
_B = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
      6.680131188771972e01, -1.328068155288572e01, 1.0)
_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
      -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00)
_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
      3.754408661907416e00, 1.0)
_P_LOW = 0.02425
# atanh series for log: 2 s (1 + s^2/3 + s^4/5 + ...), |s| <= 0.1716.
_LOG_TERMS = tuple(1.0 / (2 * k + 1) for k in range(11))


def _mulhilo(a: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit halves of ``a * m`` for words ``a`` (int64 holding
    values below 2^32) and a 32-bit constant ``m``, in 16-bit limbs."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    t0 = a_lo * m_lo
    t1 = a_hi * m_lo + a_lo * m_hi
    mid = t0 + ((t1 & 0xFFFF) << 16)
    return a_hi * m_hi + (t1 >> 16) + (mid >> 32), mid & MASK32


def philox4x32(counter: Sequence[torch.Tensor], key: Sequence[torch.Tensor],
               rounds: int = PHILOX_ROUNDS):
    """Philox-4x32 of four counter words and two key words (int64 tensors
    holding 32-bit values, broadcast together): four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(rounds):
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r + 1 < rounds:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
    return c0, c1, c2, c3


def chain_keys(seed: int, n_chains: int, device="cpu") -> torch.Tensor:
    """``(n_chains, 2)`` int64 chain keys from one seed: chain ``c``'s key
    is the first two words of Philox at counter ``(c, 0, 0, KEY_DOMAIN)``
    under the key ``(seed_lo, seed_hi)``, so it does not depend on
    ``n_chains``.  The port's ``jax.random.split(jax.random.key(seed), C)``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    c = torch.arange(n_chains, dtype=torch.int64, device=device)
    z = torch.zeros_like(c)
    key = (torch.full_like(c, seed & MASK32), torch.full_like(c, seed >> 32))
    w0, w1, _, _ = philox4x32((c, z, z, torch.full_like(c, KEY_DOMAIN)), key)
    return torch.stack([w0, w1], dim=-1)


def draw_words(keys: torch.Tensor, counters: torch.Tensor, n_words: int) -> torch.Tensor:
    """The first ``n_words`` output words at each counter: ``keys`` is
    ``(C, 2)``, ``counters`` is ``(C, *S)`` int64; returns ``(C, *S,
    n_words)`` int64.  Words 4j..4j+3 are Philox at counter ``(counter_lo,
    counter_hi, j, 0)``."""
    n_blocks = -(-n_words // 4)
    ctr = counters[..., None].expand(*counters.shape, n_blocks)
    block = torch.arange(n_blocks, dtype=torch.int64, device=keys.device).expand_as(ctr)
    key = keys.reshape(keys.shape[0], *([1] * counters.ndim), 2)
    words = philox4x32((ctr & MASK32, ctr >> 32, block, torch.zeros_like(block)),
                       (key[..., 0], key[..., 1]))
    return torch.stack(words, dim=-1).flatten(-2)[..., :n_words]


# ---------------------------------------------------------------------------
# words -> numbers: integer ops and IEEE-rounded float64 arithmetic only
# ---------------------------------------------------------------------------
def uniform_of(word: torch.Tensor) -> torch.Tensor:
    """float32 uniforms on [0, 1) from words: the top 24 bits, exactly."""
    return (word >> 8).to(torch.float32) * 2.0**-24


def integers_of(word: torch.Tensor, low, high) -> torch.Tensor:
    """Integers on ``[low, high)`` from words (multiply and shift), int64;
    ``low`` and ``high`` may be ints or int64 tensors, ``high - low`` below
    2^31."""
    return low + ((word * (high - low)) >> 32)


def _horner(coefs: Sequence[float], x: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(x, coefs[0])
    for c in coefs[1:]:
        acc = acc * x + c
    return acc


def log_f64(y: torch.Tensor) -> torch.Tensor:
    """Natural log of positive float64 ``y`` (``-inf`` at 0) from ``frexp``
    and an atanh series, in a fixed order of IEEE operations: the same bits
    at every position of every tensor, on the CPU and on the card.  Within
    a few ulp of the correctly rounded log."""
    m, e = torch.frexp(y)  # y = m 2^e, m in [0.5, 1)
    low = m < _SQRT_HALF
    m = torch.where(low, m * 2.0, m)
    e = (e - low.to(e.dtype)).to(torch.float64)
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    acc = torch.full_like(s, _LOG_TERMS[-1])
    for c in _LOG_TERMS[-2::-1]:
        acc = acc * s2 + c
    out = e * _LN2 + 2.0 * s * acc
    return torch.where(y > 0, out, -math.inf)


def normal_of(word: torch.Tensor) -> torch.Tensor:
    """float32 standard normals from words: Acklam's inverse CDF of
    ``(word + 0.5) 2^-32`` in float64, one word per value."""
    p = (word.to(torch.float64) + 0.5) * 2.0**-32
    tail_p = torch.minimum(p, 1.0 - p)  # both exact: p has 33 bits
    q = p - 0.5
    r = q * q
    central = _horner(_A, r) * q / _horner(_B, r)
    t = torch.sqrt(-2.0 * log_f64(tail_p))
    tail = _horner(_C, t) / _horner(_D, t)
    tail = torch.where(p < 0.5, tail, -tail)
    return torch.where(tail_p < _P_LOW, tail, central).to(torch.float32)


def log_uniform_of(word: torch.Tensor) -> torch.Tensor:
    """``log(uniform)`` in float64 for the MH accept test: the float32
    uniform of the word, widened, through :func:`log_f64`."""
    return log_f64(uniform_of(word).to(torch.float64))


# ---------------------------------------------------------------------------
# the host stream: one chain, np.random.Generator-shaped
# ---------------------------------------------------------------------------
KeyLike = Union[torch.Tensor, Sequence[int], np.ndarray]


class CounterStream:
    """``np.random.Generator``-shaped stream in device counter mode.

    Every draw is Philox at ``(chain key, counter)`` with the counter
    incremented per draw: the stream the fused ensemble consumes, so an
    :class:`repro_torch.core.mlda.MLDASampler` driven by this object visits
    the fused chain's states bit for bit.  Implements what the MLDA machine
    uses: ``normal(size=)``, ``uniform()``, ``integers(lo, hi)``.  The words
    and transforms run where the key lies (a row of :func:`chain_keys`),
    one chain at a time.
    """

    def __init__(self, key: KeyLike, counter: int = 0) -> None:
        self.key = torch.as_tensor(key, dtype=torch.int64).reshape(1, 2)
        self.device = self.key.device
        self.counter = int(counter)

    def _words(self, n: int) -> torch.Tensor:
        ctr = torch.tensor([self.counter], dtype=torch.int64, device=self.device)
        self.counter += 1
        return draw_words(self.key, ctr, n)[0]

    def normal(self, size: Optional[Union[int, Sequence[int]]] = None):
        shape = (size,) if isinstance(size, int) else tuple(size or ())
        n = int(np.prod(shape)) if shape else 1
        out = normal_of(self._words(n)).cpu().numpy().reshape(shape)
        return out if size is not None else float(out)

    def uniform(self) -> float:
        return float(uniform_of(self._words(1))[0])

    def integers(self, low, high=None) -> int:
        if high is None:
            low, high = 0, low
        return int(integers_of(self._words(1), int(low), int(high))[0])
