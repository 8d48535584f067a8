"""Delayed Acceptance and Multilevel Delayed Acceptance MCMC (paper §5).

Algorithm 2 (DA, Christen & Fox 2005) and its multilevel generalisation
(MLDA, Lykkegaard et al. 2023): the proposal for level ``l`` is the final
state of a randomised-length subchain run at level ``l-1``, recursing down
to plain MH at level 0.  The fine-level acceptance probability

    alpha_l(psi | theta) = min(1, [pi_l(psi) pi_{l-1}(theta)]
                                / [pi_l(theta) pi_{l-1}(psi)])

corrects the coarse filter so the level-l chain targets pi_l exactly.

This is the *request-driven* implementation, structured as a resumable
**step machine** (DESIGN.md §8): the MLDA recursion is expressed as
generators that *yield* pending density evaluations
(:class:`PendingEval`) instead of blocking on them.  :class:`ChainState`
wraps one chain's machine behind a ``step()`` API; the blocking
:meth:`MLDASampler.sample` is a thin eager driver over it (bit-identical
to the historical recursive implementation at fixed RNG), while
:class:`repro_torch.ensemble.EnsembleRunner` multiplexes many chains' machines
through one shared :class:`repro_torch.balancer.LoadBalancer` from a single
thread.  With ``speculative=True`` the machine additionally prefetches the
next coarse subchain while a fine solve is still on a server, rewinding
RNG/bookkeeping on a wrong guess so chains stay bit-identical.

The fully vectorised lockstep (device-resident) variant is not ported yet:
``balanced_mlda(device_resident=True)`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.balancer import LoadBalancer, Server  # Server: quoted annotations
from .mh import Proposal, mh_step_steps


@dataclass
class LevelRecord:
    """Per-level bookkeeping matching the paper's Table 1 columns.

    ``n_evals`` counts forward solves that actually ran (including ones a
    mis-speculated prefetch later discarded — the servers did the work);
    ``n_spec_discarded`` counts the discarded subset separately so
    telemetry can report speculation waste (DESIGN.md §8).
    """

    samples: List[np.ndarray] = field(default_factory=list)
    n_evals: int = 0
    n_accepted: int = 0
    n_proposed: int = 0
    eval_seconds: float = 0.0
    n_spec_discarded: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.n_accepted / max(self.n_proposed, 1)


@dataclass
class PendingEval:
    """One pending density evaluation, yielded by the step machine.

    The machine yields ``(kind, PendingEval)`` actions:

    * ``("eval", pe)``   — the driver must :meth:`resolve` ``pe`` before
      stepping the chain again (the blocking round trip);
    * ``("submit", pe)`` — the driver should *start* the evaluation (e.g.
      ``submit_async`` on a balancer) and step again immediately;
    * ``("await", pe)``  — the driver steps again only once a previously
      submitted ``pe`` is resolved.

    ``speculative`` marks evaluations issued by the prefetch machinery —
    their results may be discarded (but are still real forward solves).
    """

    level: int
    theta: np.ndarray
    speculative: bool = False
    value: Optional[float] = None
    seconds: float = 0.0
    done: bool = False

    def resolve(self, value: float, seconds: float = 0.0) -> None:
        """Fulfil the evaluation: record the log-density + solve seconds."""
        self.value = float(value)
        self.seconds = float(seconds)
        self.done = True


EvalAction = Tuple[str, PendingEval]


class BalancedDensity:
    """log-posterior whose forward solve is dispatched via the load balancer.

    Mirrors the paper's split of concerns: the UQ client (this object)
    computes prior/likelihood; the forward map runs on a pooled server.

    Two entry points:

    * ``__call__`` — the blocking round trip (the paper's HTTP call);
    * :meth:`begin` / :meth:`finish` — the async split used by the
      ensemble driver: ``begin`` submits the forward solve and returns the
      pending :class:`~repro_torch.balancer.types.Request` without waiting, so
      one thread can keep many chains' solves outstanding.  Hedging is a
      blocking-only feature: on the async path hedged levels fall back to
      plain submission (a duplicate race needs a blocking wait).
    """

    def __init__(
        self,
        balancer: LoadBalancer,
        tag: str,
        log_likelihood: Callable,
        log_prior: Callable,
        *,
        batchable: bool = False,
        hedged: bool = False,
    ) -> None:
        if batchable and hedged:
            raise ValueError(
                "batchable and hedged are mutually exclusive: submit_hedged "
                "dispatches duplicates individually and never coalesces"
            )
        self.balancer = balancer
        self.tag = tag
        self.log_likelihood = log_likelihood
        self.log_prior = log_prior
        self.batchable = batchable
        self.hedged = hedged

    def __call__(self, theta) -> float:
        lp = float(self.log_prior(np.asarray(theta)))
        if not np.isfinite(lp):
            return float("-inf")
        if self.hedged:
            obs = self.balancer.submit_hedged(theta, tag=self.tag)
            return lp + float(self.log_likelihood(obs))
        return self.finish(lp, self._submit(theta))

    # -- async split (consumed by repro_torch.ensemble) ----------------------------
    def begin(self, theta) -> Tuple[float, Optional[Any]]:
        """Start an evaluation; returns ``(log_prior, pending_request)``.

        A ``None`` request means the evaluation already finished locally
        (prior rejected the state): the density value is the returned
        log-prior (``-inf``).
        """
        lp = float(self.log_prior(np.asarray(theta)))
        if not np.isfinite(lp):
            return float("-inf"), None
        return lp, self._submit(theta)

    def finish(self, lp: float, request) -> float:
        """Complete an evaluation started by :meth:`begin`."""
        obs = self.balancer.result(request)
        return lp + float(self.log_likelihood(obs))

    def _submit(self, theta):
        return self.balancer.submit_async(
            theta, tag=self.tag, batchable=self.batchable
        )


class MLDASampler:
    """Recursive MLDA over an arbitrary number of levels.

    Parameters
    ----------
    log_posteriors: densities ``[pi_0, ..., pi_L]`` coarse -> fine.
    proposal: base random-walk proposal used at level 0.
    subchain_lengths: ``[n_1, ..., n_L]`` — mean subchain length used to
        propose for each level above 0.
    randomize: draw each subchain length uniformly from
        ``{1, ..., 2*n_l - 1}`` (randomised-length subchains per the MLDA
        paper; keeps ergodicity without tuning).
    speculative: prefetch the next coarse subchain while a fine solve is
        outstanding (DESIGN.md §8).  Chains are bit-identical either way:
        on a wrong guess the RNG state, proposal adaptation and per-level
        bookkeeping are rewound and the discarded forward solves counted
        in ``LevelRecord.n_spec_discarded``.
    """

    def __init__(
        self,
        log_posteriors: Sequence[Callable],
        proposal: Proposal,
        subchain_lengths: Sequence[int],
        *,
        randomize: bool = True,
        adapt: bool = False,
        balancer: Optional[LoadBalancer] = None,
        speculative: bool = False,
    ) -> None:
        if len(subchain_lengths) != len(log_posteriors) - 1:
            raise ValueError("need one subchain length per level above 0")
        if speculative and adapt and hasattr(proposal, "update") and not proposal.state():
            # A wrong prefetch guess rewinds adaptation via
            # proposal.state()/restore(); the base-class no-op defaults
            # would silently break the bit-identical-chains invariant.
            raise ValueError(
                "speculative prefetch with an adaptive proposal requires "
                "the proposal to implement state()/restore() so "
                "mis-speculated updates can be rewound"
            )
        self.log_posteriors = list(log_posteriors)
        self.proposal = proposal
        self.subchain_lengths = list(subchain_lengths)
        self.randomize = randomize
        self.adapt = adapt
        # The balancer serving this sampler's densities, when built via
        # balanced_mlda(); exposes idle-time telemetry next to chain stats.
        self.balancer = balancer
        self.speculative = speculative
        self.levels = [LevelRecord() for _ in log_posteriors]
        self.n_speculated = 0  # prefetches attempted
        self.n_spec_hits = 0  # prefetches whose accept/reject guess held
        self._speculating = False
        self._active_chain: Optional["ChainState"] = None

    @property
    def n_levels(self) -> int:
        return len(self.log_posteriors)

    # -- density evaluation with bookkeeping ---------------------------------
    _CACHE_MAX = 4096

    def _cache_dict(self) -> Dict:
        cache = getattr(self, "_cache", None)
        if cache is None:
            cache = self._cache = {}
        return cache

    @staticmethod
    def _cache_key(level: int, theta) -> Tuple[int, bytes]:
        return (level, np.asarray(theta, dtype=float).tobytes())

    def _eval_steps(self, level: int, theta) -> Iterator[EvalAction]:
        """Sub-generator: memoised evaluation of ``pi_level(theta)``.

        Densities are deterministic, so caching is exact; it prevents
        re-evaluating the current state at subchain entry (the paper's eval
        counts — 1.5M/3005/155 — count *forward solves*, i.e. unique
        states).  Yields one ``("eval", pe)`` action on a cache miss; the
        driver must resolve it before resuming.  Returns the log-density.
        """
        cache = self._cache_dict()
        key = self._cache_key(level, theta)
        if key in cache:
            return cache[key]
        pe = PendingEval(
            level=level,
            theta=np.asarray(theta, dtype=float),
            speculative=self._speculating,
        )
        yield ("eval", pe)
        return self._book_eval(level, key, pe)

    def _book_eval(self, level: int, key, pe: PendingEval) -> float:
        """Record a resolved evaluation: Table-1 counters + memo cache."""
        if not pe.done:
            raise RuntimeError(
                "driver resumed the chain with an unresolved evaluation"
            )
        rec = self.levels[level]
        rec.n_evals += 1
        rec.eval_seconds += pe.seconds
        cache = self._cache_dict()
        if len(cache) >= self._CACHE_MAX:
            cache.pop(next(iter(cache)))
        v = cache[key] = float(pe.value)
        return v

    # -- the MLDA recursion, as a resumable generator -------------------------
    def _subchain_steps(
        self,
        level: int,
        theta: np.ndarray,
        logp: float,
        length: int,
        rng: np.random.Generator,
        *,
        speculate: bool = False,
    ) -> Iterator[EvalAction]:
        """Run ``length`` steps of the level-``level`` chain; return end state.

        ``logp`` is the cached density of ``theta`` at ``level``.  Yields
        :class:`PendingEval` actions (see there for the driver contract)
        and returns ``(theta, logp)`` via ``StopIteration.value``.
        """
        rec = self.levels[level]
        if level == 0:
            eval0 = lambda cand: self._eval_steps(0, cand)  # noqa: E731
            for _ in range(length):
                theta, logp, accepted = yield from mh_step_steps(
                    eval0, self.proposal, rng, theta, logp
                )
                rec.n_proposed += 1
                if accepted:
                    rec.n_accepted += 1
                if self.adapt and hasattr(self.proposal, "update"):
                    self.proposal.update(theta)
                rec.samples.append(theta.copy())
            return theta, logp

        # level > 0: each step proposes via a subchain at level-1.
        lower = level - 1
        logp_lower = yield from self._eval_steps(lower, theta)
        prefetched: Optional[Tuple[np.ndarray, float]] = None
        for i in range(length):
            if prefetched is not None:
                psi, logp_psi_lower = prefetched
                prefetched = None
            else:
                n_sub = self._draw_subchain_length(level, rng)
                psi, logp_psi_lower = yield from self._subchain_steps(
                    lower, theta, logp_lower, n_sub, rng
                )
            rec.n_proposed += 1
            if np.all(psi == theta):
                # Subchain never moved: proposal == current, always accepted,
                # no fine evaluation needed (pi_l cancels).
                rec.samples.append(theta.copy())
                continue
            cache = self._cache_dict()
            key = self._cache_key(level, psi)
            spec = None
            if key in cache:
                logp_psi = cache[key]
                u = rng.uniform()
            elif speculate and i + 1 < length:
                # Submit the fine solve, draw the accept uniform now (density
                # evaluations consume no chain RNG, so the stream position is
                # identical to the blocking order), then prefetch the next
                # coarse subchain while the solve is on a server.
                pe = PendingEval(level=level, theta=np.asarray(psi, dtype=float))
                yield ("submit", pe)
                u = rng.uniform()
                spec = yield from self._speculate_steps(
                    level, theta, logp_lower, psi, logp_psi_lower, rng
                )
                yield ("await", pe)
                logp_psi = self._book_eval(level, key, pe)
            else:
                logp_psi = yield from self._eval_steps(level, psi)
                u = rng.uniform()
            # alpha = pi_l(psi) pi_{l-1}(theta) / (pi_l(theta) pi_{l-1}(psi))
            log_alpha = (logp_psi - logp) + (logp_lower - logp_psi_lower)
            accepted = bool(np.log(u) < log_alpha)
            if accepted:
                theta, logp = psi, logp_psi
                logp_lower = logp_psi_lower
                rec.n_accepted += 1
            rec.samples.append(theta.copy())
            if spec is not None:
                prefetched = self._commit_or_discard(spec, accepted, rng)
        return theta, logp

    def _speculate_steps(
        self,
        level: int,
        theta: np.ndarray,
        logp_lower: float,
        psi: np.ndarray,
        logp_psi_lower: float,
        rng: np.random.Generator,
    ) -> Iterator[EvalAction]:
        """Prefetch the next level-(l-1) proposal subchain on a guessed branch.

        Snapshots RNG/proposal/bookkeeping first so a wrong guess can be
        rewound bit-exactly by :meth:`_commit_or_discard`.  Speculation is
        never nested (the prefetched subchain runs with ``speculate=False``).
        """
        rec = self.levels[level]
        guess_accept = rec.n_proposed > 0 and rec.n_accepted * 2 >= rec.n_proposed
        snap = {
            "guess": guess_accept,
            "rng": copy.deepcopy(rng.bit_generator.state),
            "proposal": self.proposal.state(),
            "records": [
                (r, len(r.samples), r.n_proposed, r.n_accepted, r.n_evals)
                for r in self.levels[:level]
            ],
        }
        n_sub = self._draw_subchain_length(level, rng)
        start = psi if guess_accept else theta
        start_lower = logp_psi_lower if guess_accept else logp_lower
        self._speculating = True
        try:
            snap["result"] = yield from self._subchain_steps(
                level - 1, start, start_lower, n_sub, rng
            )
        finally:
            self._speculating = False
        return snap

    def _commit_or_discard(
        self, spec: Dict[str, Any], accepted: bool, rng: np.random.Generator
    ) -> Optional[Tuple[np.ndarray, float]]:
        """Resolve a prefetch once the real accept/reject is known."""
        self.n_speculated += 1
        if accepted == spec["guess"]:
            self.n_spec_hits += 1
            return spec["result"]
        # Mis-speculation: rewind the RNG stream, proposal adaptation and
        # chain bookkeeping to the snapshot; the forward solves stay counted
        # in n_evals (they ran) and are additionally booked as discarded.
        rng.bit_generator.state = spec["rng"]
        self.proposal.restore(spec["proposal"])
        for r, n_samples, n_prop, n_acc, n_evals in spec["records"]:
            r.n_spec_discarded += r.n_evals - n_evals
            del r.samples[n_samples:]
            r.n_proposed = n_prop
            r.n_accepted = n_acc
        return None

    def _draw_subchain_length(self, level: int, rng: np.random.Generator) -> int:
        n = self.subchain_lengths[level - 1]
        if not self.randomize or n <= 1:
            return n
        return int(rng.integers(1, 2 * n))  # uniform on {1, .., 2n-1}, mean n

    def _sample_steps(
        self, theta0: np.ndarray, n_samples: int, rng: np.random.Generator
    ) -> Iterator[EvalAction]:
        """Top-level machine: evaluate the start state, then run the chain."""
        theta = np.asarray(theta0, dtype=float)
        top = self.n_levels - 1
        logp = yield from self._eval_steps(top, theta)
        theta, logp = yield from self._subchain_steps(
            top, theta, logp, n_samples, rng,
            speculate=self.speculative and top > 0,
        )
        return theta, logp

    # -- public API -----------------------------------------------------------
    def sample(
        self,
        theta0: np.ndarray,
        n_samples: int,
        rng: np.random.Generator,
        *,
        progress_every: int = 0,
    ) -> np.ndarray:
        """Draw ``n_samples`` states of the finest-level chain.

        This is the eager driver over :class:`ChainState`: every pending
        evaluation is resolved on the spot by calling the level's density
        (which may itself block on the load balancer).  Identical chains to
        the historical recursive implementation at fixed RNG — verified
        bit-for-bit in ``tests/test_async_mlda.py``.
        """
        chain = ChainState(self, theta0, n_samples, rng)
        t0 = time.monotonic()
        printed = 0
        action = chain.step()
        while action is not None:
            _, pe = action
            if not pe.done:
                t1 = time.monotonic()
                v = float(self.log_posteriors[pe.level](pe.theta))
                pe.resolve(v, seconds=time.monotonic() - t1)
            action = chain.step()
            if progress_every:
                while chain.samples_drawn >= printed + progress_every:
                    printed += progress_every
                    dt = time.monotonic() - t0
                    print(
                        f"[mlda] {printed}/{n_samples} fine samples, {dt:.1f}s",
                        flush=True,
                    )
        return chain.samples()

    # -- checkpointable state (paper §7 future work) ---------------------------
    def stats_table(self) -> List[Dict[str, Any]]:
        """Rows shaped like the paper's Table 1.

        When the sampler runs through a balancer, each row also reports
        the realised coalesced-batch sizes for its level's tag
        (``batch_hist``: ``{size: count}``) — how often batched dispatch
        actually fused same-level solves (DESIGN.md §2).
        """
        rows = []
        for lvl, rec in enumerate(self.levels):
            xs = np.asarray(rec.samples) if rec.samples else np.zeros((0, 1))
            row = {
                "level": lvl,
                "n_evals": rec.n_evals,
                "n_samples": len(rec.samples),
                "acceptance_rate": rec.acceptance_rate,
                "mean_eval_s": rec.eval_seconds / max(rec.n_evals, 1),
                "n_spec_discarded": rec.n_spec_discarded,
                "E_phi": xs.mean(axis=0).tolist() if len(xs) else None,
                "V_phi": xs.var(axis=0).tolist() if len(xs) else None,
            }
            tag = getattr(self.log_posteriors[lvl], "tag", None)
            if self.balancer is not None and tag is not None:
                row["batch_hist"] = self.balancer.telemetry.batch_histogram(tag)
            rows.append(row)
        return rows

    def speculation_summary(self) -> Dict[str, Any]:
        """Prefetch telemetry (DESIGN.md §8): attempts, hits, wasted solves."""
        return {
            "n_speculated": self.n_speculated,
            "n_spec_hits": self.n_spec_hits,
            "hit_rate": self.n_spec_hits / max(self.n_speculated, 1),
            "discarded_evals_per_level": [
                rec.n_spec_discarded for rec in self.levels
            ],
        }


class ChainState:
    """Resumable step machine for one MLDA chain (DESIGN.md §8).

    Wraps :meth:`MLDASampler._sample_steps`; drivers repeatedly call
    :meth:`step` and fulfil the returned ``(kind, PendingEval)`` actions:

    * ``("eval", pe)``   — resolve ``pe`` before the next ``step()``;
    * ``("submit", pe)`` — start evaluating ``pe``; ``step()`` again now;
    * ``("await", pe)``  — ``step()`` again only once ``pe`` is resolved.

    ``step()`` returns ``None`` when the chain has drawn all its samples;
    :meth:`samples` then yields the ``(n_samples, dim)`` fine chain.  One
    sampler hosts one live chain at a time (per-chain samplers are how the
    ensemble keeps LevelRecords separate).
    """

    def __init__(
        self,
        sampler: MLDASampler,
        theta0: np.ndarray,
        n_samples: int,
        rng: np.random.Generator,
    ) -> None:
        if sampler._active_chain is not None and not sampler._active_chain.done:
            raise RuntimeError(
                "sampler already has a live ChainState; use one sampler per "
                "chain (see repro_torch.ensemble.EnsembleRunner)"
            )
        theta0 = np.asarray(theta0, dtype=float)
        self.sampler = sampler
        self.rng = rng
        self.dim = theta0.size
        self.n_samples = int(n_samples)
        self.done = False
        self.final_state: Optional[Tuple[np.ndarray, float]] = None
        self._top = sampler.n_levels - 1
        self._start = len(sampler.levels[self._top].samples)
        self._gen = sampler._sample_steps(theta0, n_samples, rng)
        self._primed = False
        sampler._active_chain = self

    def step(self) -> Optional[EvalAction]:
        """Advance to the next pending evaluation; ``None`` when finished."""
        if self.done:
            return None
        try:
            if not self._primed:
                self._primed = True
                return next(self._gen)
            return self._gen.send(None)
        except StopIteration as e:
            self.done = True
            self.final_state = e.value
            self.sampler._active_chain = None
            return None
        except BaseException:
            # A failed evaluation (server death past retries, shutdown)
            # kills this chain, not the sampler: mark it finished so the
            # sampler can host a fresh chain afterwards.
            self.done = True
            self.sampler._active_chain = None
            raise

    def abort(self) -> None:
        """Kill the chain (driver-side failure): the generator is closed
        and the sampler freed for a fresh chain.  Idempotent."""
        if not self.done:
            self.done = True
            self._gen.close()
            self.sampler._active_chain = None

    @property
    def samples_drawn(self) -> int:
        """Fine-level samples completed so far (monotone during the run)."""
        return len(self.sampler.levels[self._top].samples) - self._start

    def samples(self) -> np.ndarray:
        """The fine chain drawn by this machine, shape ``(n_samples, dim)``."""
        rows = self.sampler.levels[self._top].samples[
            self._start : self._start + self.n_samples
        ]
        if not rows:
            return np.zeros((0, self.dim))
        return np.asarray(rows, dtype=float)


def balanced_mlda(
    servers_or_balancer: "Sequence[Server] | LoadBalancer",
    log_likelihood: Callable,
    log_prior: Callable,
    proposal: Proposal,
    subchain_lengths: Sequence[int],
    *,
    policy: Optional[str] = None,
    level_tag: Callable[[int], str] = "level{}".format,
    batchable_levels: Sequence[int] = (0,),
    hedged_levels: Sequence[int] = (),
    randomize: bool = True,
    speculative: bool = False,
    n_chains: int = 1,
    ensemble_seed: int = 0,
    as_runner: bool = False,
    max_restarts: int = 0,
    checkpoint_every: int = 0,
    checkpoint_dir: Optional[str] = None,
    device_resident: bool = False,
    device_densities: Optional[Sequence[Callable]] = None,
    device_chunk: int = 16,
    **balancer_kwargs,
) -> Tuple[Any, LoadBalancer]:
    """Wire an MLDA hierarchy through the load balancer in one call.

    This is the stack's policy-selection entry point: pass ``policy`` (a
    registry name — ``fifo`` | ``round_robin`` | ``least_loaded`` |
    ``power_of_two`` | ``cost_aware`` — default ``fifo``, the
    paper-faithful Algorithm 1) and every density evaluation of the
    returned sampler is dispatched under that policy.  Accepts either a
    server pool (a balancer is built) or an existing :class:`LoadBalancer`
    (shared across samplers/chains; ``policy``, if given, must then match
    the balancer's own).

    Ensemble mode: with ``n_chains > 1`` the return value is
    ``(EnsembleRunner, balancer)`` — N independent chains (per-chain
    proposal copies, per-chain LevelRecords, RNG streams spawned from
    ``ensemble_seed``) multiplexed through the shared balancer by a single
    driver thread; call ``runner.run(theta0, n_samples)``.  With the
    default ``n_chains=1`` it returns ``(MLDASampler, balancer)`` as
    before — pass ``as_runner=True`` to get an ``EnsembleRunner`` even for
    one chain (uniform driving code across chain counts).  ``speculative``
    enables coarse-subchain prefetch either way (bit-identical chains; see
    DESIGN.md §8).  ``max_restarts`` / ``checkpoint_every`` /
    ``checkpoint_dir`` flow to the runner's chain auto-resume (DESIGN.md
    §12): a chain whose step dies restarts from its latest snapshot.

    A level listed in both ``batchable_levels`` and ``hedged_levels`` is
    hedged, not batched (duplicated submissions are never coalesced).

    Device-resident mode (``device_resident=True``, the fused on-device
    chain ensemble) waits for its own slice of the port and raises
    :class:`NotImplementedError`; ``device_densities`` and ``device_chunk``
    are accepted only so that call sites keep the reference's signature.

    Returns ``(sampler_or_runner, balancer)``; call ``balancer.shutdown()``
    when done.
    """
    n_levels = len(subchain_lengths) + 1
    if device_resident:
        # Checked before the balancer exists: no dispatcher threads leak.
        raise NotImplementedError(
            "device_resident=True needs the fused device ensemble "
            "(core/mlda_jax in the reference), a later slice of the port"
        )
    if isinstance(servers_or_balancer, LoadBalancer):
        balancer = servers_or_balancer
        if policy is not None and policy != balancer.policy.name:
            raise ValueError(
                f"policy is fixed at balancer construction (this balancer "
                f"runs '{balancer.policy.name}', not '{policy}'); pass "
                f"servers instead of a LoadBalancer to choose one here"
            )
        if balancer_kwargs:
            raise ValueError(
                f"balancer options {sorted(balancer_kwargs)} are fixed at "
                f"balancer construction; pass servers instead of a "
                f"LoadBalancer to set them here"
            )
    else:
        balancer = LoadBalancer(
            servers_or_balancer, policy=policy or "fifo", **balancer_kwargs
        )

    def make_sampler(prop: Proposal) -> MLDASampler:
        densities = [
            BalancedDensity(
                balancer,
                level_tag(lvl),
                log_likelihood,
                log_prior,
                batchable=lvl in batchable_levels and lvl not in hedged_levels,
                hedged=lvl in hedged_levels,
            )
            for lvl in range(n_levels)
        ]
        return MLDASampler(
            densities, prop, subchain_lengths, randomize=randomize,
            balancer=balancer, speculative=speculative,
        )

    if n_chains <= 1 and not as_runner:
        return make_sampler(proposal), balancer
    from repro_torch.ensemble import EnsembleRunner  # local import: cycle-free

    runner = EnsembleRunner(
        lambda _c: make_sampler(copy.deepcopy(proposal)),
        max(n_chains, 1),
        seed=ensemble_seed,
        balancer=balancer,
        max_restarts=max_restarts,
        checkpoint_every=checkpoint_every,
        checkpoint_dir=checkpoint_dir,
    )
    return runner, balancer


def delayed_acceptance(
    log_post_fine: Callable,
    log_post_coarse: Callable,
    proposal: Proposal,
    theta0: np.ndarray,
    n_steps: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, MLDASampler]:
    """Classic two-level DA (paper Algorithm 2) — MLDA with L=1, subchain=1."""
    sampler = MLDASampler(
        [log_post_coarse, log_post_fine], proposal, [1], randomize=False
    )
    chain = sampler.sample(theta0, n_steps, rng)
    return chain, sampler
