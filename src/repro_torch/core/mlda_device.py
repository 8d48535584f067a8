"""Vectorised, device-resident MLDA (beyond the paper; DESIGN.md §2, §9).

The port of the JAX package's ``core/mlda_jax.py``.  The paper's
architecture evaluates one forward solve per HTTP request.  On an
accelerator the natural execution model is *lockstep*: advance many chains
at once, with every density evaluation batched.  Two samplers live here:

* :func:`make_mlda_kernel` / :func:`run_chains`: the masked lockstep MLDA
  recursion over ``(C, d)`` chains (randomised subchain lengths realised by
  masking a fixed ``2n - 1``-iteration loop), with the level-0 density
  evaluated for all chains in one batched call;
* :class:`DeviceEnsemble`: the same recursion with *counter-mode* draws
  (:mod:`repro_torch.core.counter_rng`): each chain carries a key and a draw
  counter, and the counter advances only where the Python step machine
  (:class:`repro_torch.core.mlda.MLDASampler`) would consume a draw.
  Driving that machine with :class:`~repro_torch.core.counter_rng.CounterStream`
  and :class:`DeviceMatchedRandomWalk` replays the identical stream and
  arithmetic on the host, so the fused ``(C,)``-wide chains equal ``C``
  independent step machines bit for bit (tests/test_torch_device_ensemble.py).

Densities are batched callables: ``lp(thetas)`` maps float32 ``(B, d)``
parameters on the chains' device to float32 ``(B,)`` log densities, and a
row must not depend on ``B`` (the port's GP mean kernel and batched
forwards keep that contract).  Log densities are carried in float64: a
device density's float32 value widens exactly, a host-evaluated fine density
(the coupled mode's top level) keeps its float64 bits, and every accept test
is ``log(u) < log_alpha`` in float64 with the step machine's operations, so
each decision is the machine's.

``lax.scan`` over ``t_fixed`` masked iterations becomes a Python loop of the
same fixed length over ``(C, ...)`` tensors, so control flow is static: on
the card, one top-level step of the fused mode, :meth:`DeviceEnsemble.propose`
and :meth:`DeviceEnsemble.accept` are each one captured CUDA graph
(:class:`repro_torch.swe.solver.GraphBatchCache`, keyed by the power-of-two
padded chain count, padding repeating chain 0); on the CPU the same
functions run eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from .counter_rng import chain_keys, draw_words, integers_of, log_uniform_of, normal_of
from .mh import Proposal

# (B, d) float32 -> (B,) float32 on the chains' device.
Density = Callable[[torch.Tensor], torch.Tensor]

# Counters a lockstep draw table covers at most (chains x counters), so a
# long run_chains call builds its table in blocks of top-level steps.
_TABLE_COUNTERS = 1 << 20


class MLDAResult(NamedTuple):
    chain: torch.Tensor  # (C, n_samples, d) fine-level states
    logp: torch.Tensor  # (C, n_samples) float64
    accepts: torch.Tensor  # (C, n_levels) accepted transitions per level
    proposals: torch.Tensor  # (C, n_levels) proposed transitions per level


class _Draws:
    """Every chain's numbers at counters ``base .. base + span - 1``: one
    Philox evaluation and one transform for a whole top-level step, read
    back at each chain's own counter (``normal``, ``log_uniform``,
    ``integers``) or, where counters are static, by slicing ``z``, ``logu``
    and ``word`` at a position."""

    def __init__(self, keys: torch.Tensor, base: torch.Tensor, span: int, dim: int) -> None:
        counters = base[:, None] + torch.arange(span, dtype=torch.int64, device=keys.device)
        words = draw_words(keys, counters, max(dim, 1))
        self.base = base
        self.last = span - 1
        self.z = normal_of(words)  # (C, span, dim) float32
        self.logu = log_uniform_of(words[..., 0])  # (C, span) float64
        self.word = words[..., 0]  # (C, span) int64

    def _index(self, counter: torch.Tensor) -> torch.Tensor:
        # Reads of masked iterations may sit past the last live draw; the
        # clamp keeps every index inside the table.
        return torch.clamp(counter - self.base, max=self.last)[:, None]

    def normal(self, counter: torch.Tensor) -> torch.Tensor:
        idx = self._index(counter)[..., None].expand(-1, 1, self.z.shape[-1])
        return self.z.gather(1, idx)[:, 0]

    def log_uniform(self, counter: torch.Tensor) -> torch.Tensor:
        return self.logu.gather(1, self._index(counter))[:, 0]

    def integers(self, counter: torch.Tensor, low: int, high: int) -> torch.Tensor:
        return integers_of(self.word.gather(1, self._index(counter))[:, 0], low, high)


def _as_chains(theta0, device: torch.device) -> torch.Tensor:
    if not torch.is_tensor(theta0):
        theta0 = np.asarray(theta0, dtype=np.float32)
    theta = torch.as_tensor(theta0, dtype=torch.float32, device=device)
    if theta.ndim != 2:
        raise ValueError(f"theta0 must be (C, d), got {tuple(theta.shape)}")
    return theta.contiguous()


def _scale(step_scale, device: torch.device) -> torch.Tensor:
    """The level-0 random-walk scale, quantised to float32."""
    return torch.as_tensor(np.asarray(step_scale, dtype=np.float32), device=device)


def _add_counts(counts: torch.Tensor, level: int, *columns) -> torch.Tensor:
    counts[:, level] += torch.stack([c.to(torch.int64) for c in columns], dim=-1)
    return counts


# ---------------------------------------------------------------------------
# The masked lockstep kernel
# ---------------------------------------------------------------------------
def make_mlda_kernel(
    log_posteriors: Sequence[Density],
    subchain_lengths: Sequence[int],
    step_scale,
    *,
    randomize: bool = True,
):
    """Build ``sample(keys, theta0, n_samples) -> MLDAResult`` for ``C``
    chains at once: ``keys`` ``(C, 2)`` (:func:`chain_keys`), ``theta0``
    ``(C, d)`` float32 on the densities' device.

    ``log_posteriors`` are batched densities coarse -> fine; ``step_scale``
    is the level-0 random-walk scale (scalar or per-dim).  As the
    reference's kernel, every iteration draws whether or not its mask is
    live (the counters are static: one table per block of top-level steps),
    a subchain that did not move is accepted, and ``accepts``/``proposals``
    count the live iterations of each level.  One difference: a masked
    iteration here runs its lower subchain with length 0, where the
    reference's runs it (masked out of the state) and counts its steps.
    """
    lp = list(log_posteriors)
    n_levels = len(lp)
    if len(subchain_lengths) != n_levels - 1:
        raise ValueError("need one subchain length per level above 0")
    lengths = [int(n) for n in subchain_lengths]

    def t_max(level: int) -> int:
        n = lengths[level - 1]
        return (2 * n - 1) if randomize else n

    def draws_length(level: int) -> int:
        return int(randomize and lengths[level - 1] > 1)

    def n_draws(level: int, t_fixed: int) -> int:
        if level == 0:
            return 2 * t_fixed
        return t_fixed * (draws_length(level) + n_draws(level - 1, t_max(level)) + 1)

    top = n_levels - 1
    per_step = n_draws(top, 1)

    def chain(level, tab, pos, theta, logp, length, t_fixed, counts, scale):
        """``t_fixed`` lockstep iterations of the level-``level`` chain, the
        first ``length`` (per chain) live; draws from ``tab`` from position
        ``pos`` on.  Returns ``(theta, logp, pos)``; ``counts`` is updated."""
        if level == 0:
            for i in range(t_fixed):
                cand = theta + tab.z[:, pos] * scale
                logp_cand = lp[0](cand).double()
                active = length > i
                accept = (tab.logu[:, pos + 1] < logp_cand - logp) & active
                pos += 2
                theta = torch.where(accept[:, None], cand, theta)
                logp = torch.where(accept, logp_cand, logp)
                _add_counts(counts, 0, accept, active)
            return theta, logp, pos
        logp_low = lp[level - 1](theta).double()
        t_low = t_max(level)
        for i in range(t_fixed):
            active = length > i
            if draws_length(level):
                sub_len = integers_of(tab.word[:, pos], 1, 2 * lengths[level - 1])
                pos += 1
            else:
                sub_len = torch.full_like(length, lengths[level - 1])
            psi, logp_psi_low, pos = chain(
                level - 1, tab, pos, theta, logp_low,
                torch.where(active, sub_len, 0), t_low, counts, scale,
            )
            logp_psi = lp[level](psi).double()
            # alpha = pi_l(psi) pi_{l-1}(theta) / (pi_l(theta) pi_{l-1}(psi))
            log_alpha = (logp_psi - logp) + (logp_low - logp_psi_low)
            accept = (tab.logu[:, pos] < log_alpha) & active
            pos += 1
            theta = torch.where(accept[:, None], psi, theta)
            logp = torch.where(accept, logp_psi, logp)
            logp_low = torch.where(accept, logp_psi_low, logp_low)
            _add_counts(counts, level, accept, active)
        return theta, logp, pos

    def sample(keys: torch.Tensor, theta0, n_samples: int) -> MLDAResult:
        theta = _as_chains(theta0, keys.device)
        n_chains, dim = theta.shape
        scale = _scale(step_scale, theta.device)
        logp = lp[top](theta).double()
        counts = torch.zeros((n_chains, n_levels, 2), dtype=torch.int64, device=theta.device)
        one = torch.ones(n_chains, dtype=torch.int64, device=theta.device)
        block = max(1, _TABLE_COUNTERS // (n_chains * per_step * max(dim, 1)))
        thetas, logps = [], []
        for start in range(0, n_samples, block):
            steps = min(block, n_samples - start)
            base = torch.full((n_chains,), start * per_step, dtype=torch.int64,
                              device=theta.device)
            tab = _Draws(keys, base, steps * per_step, dim)
            for j in range(steps):
                theta, logp, _ = chain(top, tab, j * per_step, theta, logp, one, 1,
                                       counts, scale)
                thetas.append(theta)
                logps.append(logp)
        return MLDAResult(
            chain=torch.stack(thetas, dim=1),
            logp=torch.stack(logps, dim=1),
            accepts=counts[..., 0],
            proposals=counts[..., 1],
        )

    return sample


def run_chains(
    log_posteriors: Sequence[Density],
    subchain_lengths: Sequence[int],
    step_scale,
    seed: int,
    theta0,
    n_samples: int,
    *,
    randomize: bool = True,
    device: DeviceLike = "cuda",
) -> MLDAResult:
    """Lockstep parallel chains: ``theta0`` ``(C, d)`` moved to ``device``
    (the card unless the caller asks for the CPU), chain keys from
    ``seed`` (:func:`chain_keys`, the port's ``jax.random.split``)."""
    dev = resolve_device(device)
    theta = _as_chains(theta0, dev)
    kern = make_mlda_kernel(log_posteriors, subchain_lengths, step_scale, randomize=randomize)
    return kern(chain_keys(seed, theta.shape[0], dev), theta, n_samples)


# ---------------------------------------------------------------------------
# Device-resident ensemble (DESIGN.md §9)
# ---------------------------------------------------------------------------
class EnsembleState(NamedTuple):
    """Device-resident state of ``C`` MLDA chains, ``(C,)``-leading.

    ``logp`` is the density of ``theta`` at the *top* level (the remote
    level in coupled mode), ``logp_low`` one level below it (zeros for a
    single-level hierarchy), both float64.  ``keydata`` holds the chain
    keys, ``counter`` each chain's next draw.  ``counts`` is ``(C,
    n_levels, 3)`` int64 ``(n_accepted, n_proposed, n_evals)``: exactly the
    :class:`repro_torch.core.mlda.LevelRecord` totals.
    """

    theta: torch.Tensor  # (C, d) float32
    logp: torch.Tensor  # (C,) float64 pi_top(theta)
    logp_low: torch.Tensor  # (C,) float64 pi_{top-1}(theta)
    keydata: torch.Tensor  # (C, 2) int64 chain keys
    counter: torch.Tensor  # (C,) int64 draw counter
    counts: torch.Tensor  # (C, n_levels, 3) int64 (accepted, proposed, evals)


class PendingProposal(NamedTuple):
    """Coupled-mode hand-off: one top-level proposal per chain.

    ``log_u`` is the log of the accept uniform (float64), already
    (conditionally) consumed by :meth:`DeviceEnsemble.propose` so the device
    stream position matches the Python machine's; chains with ``moved ==
    False`` took the MLDA unmoved shortcut (proposal == current state: no
    fine solve, no uniform consumed, ``log_u`` meaningless there).
    """

    psi: torch.Tensor  # (C, d) proposed fine states
    logp_psi_low: torch.Tensor  # (C,) float64 pi_{top-1}(psi)
    log_u: torch.Tensor  # (C,) float64 log accept uniforms (valid where moved)
    moved: torch.Tensor  # (C,) bool: the chain needs a fine-level solve


def _pad_rows(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """``x`` with rows appended up to ``n_pad``, each a copy of row 0."""
    n = x.shape[0]
    if n == n_pad:
        return x
    return torch.cat([x, x[:1].expand(n_pad - n, *x.shape[1:])])


class DeviceEnsemble:
    """Fused lockstep MLDA stepping for a ``(C,)``-leading chain ensemble.

    Built by :func:`make_device_ensemble`.  Two operating modes:

    * fully fused (``remote_top=False``): every level's density is a
      batched device callable; :meth:`advance` runs ``k`` top-level steps
      for all chains, each one replay of one captured graph, and the caller
      syncs once;
    * coupled (``remote_top=True``): the finest level lives behind the
      load balancer.  :meth:`propose` runs the whole coarse subchain
      recursion on the device and surfaces ``(C,)`` fine proposals; the host
      evaluates the moved chains' densities (coalesced through the
      balancer's batch pools) and :meth:`accept` folds the results back in.

    Each program is a :class:`repro_torch.swe.solver.GraphBatchCache` keyed
    ``(*cache_key, program, padded C)``: power-of-two chain padding whose
    rows repeat chain 0 and are sliced off.  One ensemble serves one driver
    thread.
    """

    def __init__(
        self,
        log_posteriors: Sequence[Density],
        subchain_lengths: Sequence[int],
        step_scale,
        *,
        remote_top: bool = False,
        randomize: bool = True,
        cache_key: Sequence = (),
        device: DeviceLike = "cuda",
    ) -> None:
        self.n_dev = len(log_posteriors)
        if self.n_dev < 1:
            raise ValueError("need at least one device-resident density")
        self.n_levels = self.n_dev + int(remote_top)
        if len(subchain_lengths) != self.n_levels - 1:
            raise ValueError("need one subchain length per level above 0")
        self.log_posteriors = list(log_posteriors)
        self.subchain_lengths = [int(n) for n in subchain_lengths]
        self.device = resolve_device(device)
        self.step_scale = _scale(step_scale, self.device)
        self.remote_top = bool(remote_top)
        self.randomize = bool(randomize)
        self.cache_key = tuple(cache_key)
        self._caches: Dict[str, Any] = {}

    # -- counter-mode draw helpers --------------------------------------------
    def _sub_n(self, level: int) -> int:
        """Mean length of the subchain run AT ``level`` (proposing for
        ``level + 1``): ``subchain_lengths[level]`` in 0-based form."""
        return self.subchain_lengths[level]

    def _t_fixed(self, level: int) -> int:
        n = self._sub_n(level)
        return (2 * n - 1) if (self.randomize and n > 1) else n

    def _n_draw(self, level: int) -> int:
        """Draws the length of a subchain at ``level`` takes (0 or 1)."""
        return int(self.randomize and self._sub_n(level) > 1)

    def _span(self, level: int) -> int:
        """The most counters one :meth:`_chain` call at ``level`` consumes."""
        t = self._t_fixed(level)
        if level == 0:
            return 2 * t
        return t * (self._n_draw(level - 1) + self._span(level - 1) + 1)

    def _step_span(self) -> int:
        """The most counters one top-level step (fused) or one proposal
        (coupled) consumes: the draw table's length."""
        if self.n_levels == 1:
            return 2
        sub = self.n_levels - 2
        return self._n_draw(sub) + self._span(sub) + 1

    def _draw_length(self, tab: _Draws, counter: torch.Tensor, level: int):
        """Subchain-length draw for the chain AT ``level``: ``(length,
        n_draws_consumed)`` mirroring :meth:`MLDASampler._draw_subchain_length`
        (no draw when the length is deterministic)."""
        n = self._sub_n(level)
        if not self._n_draw(level):
            return torch.full_like(counter, n), 0
        return tab.integers(counter, 1, 2 * n), 1

    # -- the masked counter-RNG recursion -------------------------------------
    def _chain(self, level, tab, theta, logp, counter, counts, length):
        """``t_fixed(level)`` masked iterations of the level-``level`` chain
        for every chain, of which the first ``length`` are live.  Returns
        ``(theta, logp, counter, counts)`` with ``logp`` the level-``level``
        density of the returned state.  Draw order per live step replicates
        the Python machine exactly:

        * level 0: proposal normal, accept uniform (both always);
        * level > 0: length draw for the lower subchain, the subchain's own
          draws, then the accept uniform ONLY if the subchain moved (the
          unmoved shortcut consumes nothing and skips the upper eval).
        """
        lp = self.log_posteriors
        acc = torch.zeros_like(counter)
        prop = torch.zeros_like(counter)
        if level == 0:
            for i in range(self._t_fixed(0)):
                active = length > i
                cand = theta + tab.normal(counter) * self.step_scale
                logp_cand = lp[0](cand).double()
                accept = active & (tab.log_uniform(counter + 1) < logp_cand - logp)
                theta = torch.where(accept[:, None], cand, theta)
                logp = torch.where(accept, logp_cand, logp)
                counter = counter + 2 * active
                acc = acc + accept
                prop = prop + active
            return theta, logp, counter, _add_counts(counts, 0, acc, prop, prop)
        # Entry density one level down: the Python machine memoises it, so
        # recomputing here lands on the identical value.
        logp_low = lp[level - 1](theta).double()
        evals = torch.zeros_like(counter)
        for i in range(self._t_fixed(level)):
            active = length > i
            sub_len, n_draw = self._draw_length(tab, counter, level - 1)
            counter = counter + n_draw * active
            psi, logp_psi_low, counter, counts = self._chain(
                level - 1, tab, theta, logp_low, counter, counts,
                torch.where(active, sub_len, 0),
            )
            moved = active & torch.any(psi != theta, dim=-1)
            logp_psi = lp[level](psi).double()
            log_u = tab.log_uniform(counter)
            counter = counter + moved
            # alpha = pi_l(psi) pi_{l-1}(theta) / (pi_l(theta) pi_{l-1}(psi))
            log_alpha = (logp_psi - logp) + (logp_low - logp_psi_low)
            accept = moved & (log_u < log_alpha)
            theta = torch.where(accept[:, None], psi, theta)
            logp = torch.where(accept, logp_psi, logp)
            logp_low = torch.where(accept, logp_psi_low, logp_low)
            acc = acc + accept
            prop = prop + active
            evals = evals + moved
        return theta, logp, counter, _add_counts(counts, level, acc, prop, evals)

    def _propose_top(self, tab, theta, logp_low, counter, counts):
        """The subchain proposing for the top level, then its accept
        uniform where it moved: ``(psi, logp_psi_low, log_u, moved,
        counter, counts)``."""
        sub = self.n_levels - 2
        sub_len, n_draw = self._draw_length(tab, counter, sub)
        psi, logp_psi_low, counter, counts = self._chain(
            sub, tab, theta, logp_low, counter + n_draw, counts, sub_len
        )
        moved = torch.any(psi != theta, dim=-1)
        log_u = tab.log_uniform(counter)
        return psi, logp_psi_low, log_u, moved, counter + moved, counts

    def _accept_top(self, theta, logp, logp_low, counts, psi, logp_psi_low, log_u,
                    moved, logp_psi):
        """Fold the top level's densities of the proposals back in."""
        log_alpha = (logp_psi - logp) + (logp_low - logp_psi_low)
        accept = moved & (log_u < log_alpha)
        theta = torch.where(accept[:, None], psi, theta)
        logp = torch.where(accept, logp_psi, logp)
        logp_low = torch.where(accept, logp_psi_low, logp_low)
        counts = _add_counts(counts, self.n_levels - 1, accept, torch.ones_like(moved), moved)
        return theta, logp, logp_low, counts, accept

    # -- the three programs (one graph each on the card) ------------------------
    def _advance_program(self, theta, logp, logp_low, keydata, counter, counts):
        """Fully fused mode: one top-level transition of every chain."""
        tab = _Draws(keydata, counter, self._step_span(), theta.shape[1])
        counts = counts.clone()
        if self.n_levels == 1:
            cand = theta + tab.normal(counter) * self.step_scale
            logp_cand = self.log_posteriors[0](cand).double()
            accept = tab.log_uniform(counter + 1) < logp_cand - logp
            true = torch.ones_like(accept)
            return (torch.where(accept[:, None], cand, theta),
                    torch.where(accept, logp_cand, logp), logp_low, counter + 2,
                    _add_counts(counts, 0, accept, true, true))
        psi, logp_psi_low, log_u, moved, counter, counts = self._propose_top(
            tab, theta, logp_low, counter, counts
        )
        logp_psi = self.log_posteriors[-1](psi).double()
        theta, logp, logp_low, counts, _ = self._accept_top(
            theta, logp, logp_low, counts, psi, logp_psi_low, log_u, moved, logp_psi
        )
        return theta, logp, logp_low, counter, counts

    def _propose_program(self, theta, logp_low, keydata, counter, counts):
        tab = _Draws(keydata, counter, self._step_span(), theta.shape[1])
        return self._propose_top(tab, theta, logp_low, counter, counts.clone())

    def _accept_program(self, theta, logp, logp_low, counts, psi, logp_psi_low, log_u,
                        moved, logp_psi):
        return self._accept_top(theta, logp, logp_low, counts.clone(), psi, logp_psi_low,
                                log_u, moved, logp_psi)

    def _program(self, name: str, fn: Callable):
        cache = self._caches.get(name)
        if cache is None:
            from repro_torch.swe.solver import GraphBatchCache  # call time: no cycle

            cache = self._caches[name] = GraphBatchCache(
                fn, key=(*self.cache_key, name), pad="repeat", name=f"ensemble {name}"
            )
        return cache

    @property
    def executables(self) -> Dict:
        """The captured graphs by ``(*cache_key, program, padded C)``."""
        return {k: v for cache in self._caches.values() for k, v in cache.executables.items()}

    # -- public API -------------------------------------------------------------
    def init(self, theta0, *, seed: int = 0, keys=None, logp0=None) -> EnsembleState:
        """Start ``C`` chains.  ``theta0`` is ``(C, d)``; chain keys come
        from :func:`chain_keys` ``(seed, C)`` unless given.  Coupled mode
        needs ``logp0``: the host-evaluated top densities.
        ``counts[..., 2]`` starts at 1 per level: the initial state
        evaluation each level performs exactly once (further subchain-entry
        evaluations are cache hits in the Python machine)."""
        theta = _as_chains(theta0, self.device)
        n_chains = theta.shape[0]
        lp = self.log_posteriors
        if keys is None:
            keys = chain_keys(seed, n_chains, self.device)
        keys = torch.as_tensor(keys, dtype=torch.int64, device=self.device).reshape(n_chains, 2)
        if self.remote_top:
            if logp0 is None:
                raise ValueError("coupled mode needs logp0 (host top densities)")
            logp = torch.as_tensor(np.asarray(logp0, dtype=np.float64), device=self.device)
            logp_low = lp[-1](theta).double()
        else:
            logp = lp[-1](theta).double()
            logp_low = (lp[-2](theta).double() if self.n_dev > 1 else
                        torch.zeros(n_chains, dtype=torch.float64, device=self.device))
        counts = torch.zeros((n_chains, self.n_levels, 3), dtype=torch.int64, device=self.device)
        counts[:, :, 2] = 1
        return EnsembleState(
            theta=theta, logp=logp, logp_low=logp_low, keydata=keys,
            counter=torch.zeros(n_chains, dtype=torch.int64, device=self.device),
            counts=counts,
        )

    def advance(self, state: EnsembleState, k: int):
        """Fully fused mode: ``k`` top-level steps for ALL chains, each one
        replay of the one-step graph; nothing syncs with the host.  Returns
        ``(state', thetas (C, k, d), logps (C, k))``."""
        if self.remote_top:
            raise RuntimeError(
                "advance() is the fully-fused driver; coupled ensembles "
                "step via propose()/accept()"
            )
        k = int(k)
        if k < 1:
            raise ValueError("k must be >= 1")
        from repro_torch.swe.solver import pow2_batch

        cache = self._program("advance", self._advance_program)
        n = state.theta.shape[0]
        theta, logp, logp_low, keydata, counter, counts = (
            _pad_rows(x, pow2_batch(n)) for x in state
        )
        thetas, logps = [], []
        for _ in range(k):
            (theta, logp, logp_low, counter, counts), _ = cache(
                theta, logp, logp_low, keydata, counter, counts
            )
            thetas.append(theta[:n])
            logps.append(logp[:n])
        new = EnsembleState(theta[:n], logp[:n], logp_low[:n], state.keydata, counter[:n],
                            counts[:n])
        return new, torch.stack(thetas, dim=1), torch.stack(logps, dim=1)

    def propose(self, state: EnsembleState):
        """Coupled mode: run every chain's full coarse subchain on the
        device; returns ``(state', PendingProposal)``.  The host must
        evaluate the top density of ``pending.psi`` wherever
        ``pending.moved`` and feed the values to :meth:`accept`."""
        if not self.remote_top:
            raise RuntimeError("propose() is for coupled (remote-top) mode")
        cache = self._program("propose", self._propose_program)
        out, n = cache(state.theta, state.logp_low, state.keydata, state.counter, state.counts)
        psi, logp_psi_low, log_u, moved, counter, counts = (x[:n] for x in out)
        return (state._replace(counter=counter, counts=counts),
                PendingProposal(psi, logp_psi_low, log_u, moved))

    def accept(self, state: EnsembleState, pending: PendingProposal, logp_psi):
        """Coupled mode: fold host-evaluated top densities back in.
        ``logp_psi`` is ``(C,)`` (ignored where ``~moved``), kept in
        float64.  Returns ``(state', accepted (C,) bool)``."""
        if not self.remote_top:
            raise RuntimeError("accept() is for coupled (remote-top) mode")
        cache = self._program("accept", self._accept_program)
        logp_psi = torch.as_tensor(np.asarray(logp_psi, dtype=np.float64), device=self.device)
        out, n = cache(state.theta, state.logp, state.logp_low, state.counts, *pending,
                       logp_psi)
        theta, logp, logp_low, counts, accepted = (x[:n] for x in out)
        return (state._replace(theta=theta, logp=logp, logp_low=logp_low, counts=counts),
                accepted)


def make_device_ensemble(
    log_posteriors: Sequence[Density],
    subchain_lengths: Sequence[int],
    step_scale,
    *,
    remote_top: bool = False,
    randomize: bool = True,
    cache_key: Sequence = (),
    device: DeviceLike = "cuda",
) -> DeviceEnsemble:
    """Build a :class:`DeviceEnsemble` on ``device`` (the card unless the
    caller asks for the CPU).

    ``log_posteriors`` are the *device-resident* densities coarse -> fine
    (batched callables, ``(B, d)`` -> ``(B,)``).  With ``remote_top=True``
    the hierarchy has one more level on top whose density lives behind the
    balancer; ``subchain_lengths`` always covers the full hierarchy (one
    entry per level above 0).  ``step_scale`` is the level-0 random-walk
    scale (scalar or per-dim), quantised to float32: pair host chains with
    :class:`DeviceMatchedRandomWalk` and
    :class:`~repro_torch.core.counter_rng.CounterStream` for a bit-identical
    replay.
    """
    return DeviceEnsemble(
        log_posteriors, subchain_lengths, step_scale,
        remote_top=remote_top, randomize=randomize, cache_key=cache_key, device=device,
    )


@dataclass
class DeviceMatchedRandomWalk(Proposal):
    """Random walk reproducing the ensemble's candidate arithmetic exactly.

    Two deltas against :class:`repro_torch.core.mh.GaussianRandomWalk`: (1)
    the state is quantised to float32 (the float64-accumulating host chain
    would drift from the device chain after the first accepted step); (2)
    the update rounds as the device's does.  The ensemble computes ``theta +
    z * scale`` as two float32 tensor operations, each rounded (eager
    PyTorch contracts nothing into an FMA, on the CPU or the card), so the
    host does the same: a float32 product, then a float32 sum.  (The
    reference's twin emulates XLA's fused multiply-add instead.)
    """

    scale: Any = 1.0

    def sample(self, rng, theta):
        theta32 = np.asarray(theta, np.float32)
        z = np.asarray(rng.normal(size=theta32.shape), np.float32)
        return theta32 + z * np.asarray(self.scale, np.float32)
