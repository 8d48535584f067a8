"""Single-threaded driver multiplexing N MLDA step machines (DESIGN.md §8).

The seed ran multi-chain MLDA as one OS thread per chain, each blocking
inside ``sampler.sample`` — the balancer saw at most ``n_chains`` requests
and the client burned a thread per chain.  Here one driver thread *pumps*
every chain's :class:`~repro_torch.core.mlda.ChainState` until it parks on a
remote evaluation, submits those evaluations through the shared balancer
(``submit_async`` via :meth:`BalancedDensity.begin`), and sleeps in
:func:`repro_torch.balancer.futures.wait_any` until any of them completes —
event-driven fan-in, no polling, no per-chain threads.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.balancer import LoadBalancer
from repro_torch.core.diagnostics import effective_sample_size, gelman_rubin
from repro_torch.core.mlda import ChainState, LevelRecord, MLDASampler, PendingEval


Theta0 = Union[np.ndarray, Sequence[float], Callable[[int, np.random.Generator], np.ndarray]]


@dataclass
class EnsembleResult:
    """Chains + pooled cross-chain diagnostics of one ensemble run.

    ``chains``/``samplers`` cover the chains that completed; a chain whose
    evaluation errored past the balancer's retries (server death,
    shutdown) is dropped into ``failures`` (original chain index ->
    exception) without taking the rest of the ensemble down.
    ``restarts`` counts auto-resume recoveries per chain (chain index ->
    restarts consumed; absent = ran clean) — see
    :class:`EnsembleRunner`'s ``max_restarts``.
    """

    chains: np.ndarray  # (n_completed_chains, n_samples, dim)
    samplers: List[MLDASampler]
    failures: Dict[int, BaseException] = field(default_factory=dict)
    restarts: Dict[int, int] = field(default_factory=dict)

    @property
    def n_chains(self) -> int:
        return self.chains.shape[0]

    def gelman_rubin(self) -> np.ndarray:
        """Split-R-hat per coordinate across the ensemble (shape ``(dim,)``)."""
        return np.atleast_1d(gelman_rubin(self.chains))

    def ess(self) -> np.ndarray:
        """Per-chain, per-coordinate effective sample size ``(n_chains, dim)``."""
        m, _, d = self.chains.shape
        return np.array(
            [
                [effective_sample_size(self.chains[c, :, j]) for j in range(d)]
                for c in range(m)
            ]
        )

    def pooled(self, burn: int = 0) -> np.ndarray:
        """All chains' post-burn samples stacked to ``(m*(n-burn), dim)``."""
        return self.chains[:, burn:, :].reshape(-1, self.chains.shape[-1])

    def level_totals(self) -> List[Dict[str, Any]]:
        """Per-level eval/acceptance totals summed across chains."""
        rows = []
        for lvl in range(self.samplers[0].n_levels):
            recs = [s.levels[lvl] for s in self.samplers]
            n_evals = sum(r.n_evals for r in recs)
            rows.append(
                {
                    "level": lvl,
                    "n_evals": n_evals,
                    "n_spec_discarded": sum(r.n_spec_discarded for r in recs),
                    "acceptance_rate": float(
                        np.mean([r.acceptance_rate for r in recs])
                    ),
                    "mean_eval_s": sum(r.eval_seconds for r in recs)
                    / max(n_evals, 1),
                }
            )
        return rows

    def summary(self) -> Dict[str, Any]:
        ess = self.ess()
        spec = [s.speculation_summary() for s in self.samplers]
        return {
            "n_chains": int(self.n_chains),
            "n_samples": int(self.chains.shape[1]),
            "gelman_rubin": self.gelman_rubin().tolist(),
            "ess_per_chain_min": float(ess.min()) if ess.size else 0.0,
            "ess_total": ess.sum(axis=0).tolist() if ess.size else [],
            "levels": self.level_totals(),
            "n_speculated": sum(s["n_speculated"] for s in spec),
            "n_spec_hits": sum(s["n_spec_hits"] for s in spec),
        }


class EnsembleRunner:
    """Run N independent MLDA chains through one shared balancer.

    ``sampler_factory(c)`` must return a *fresh* :class:`MLDASampler` for
    chain ``c`` (own proposal instance, own LevelRecords) — chains share
    servers, never sampler state.  Per-chain RNGs are spawned from one
    :class:`numpy.random.SeedSequence`, so the ensemble is reproducible
    from ``seed`` and chains are statistically independent streams.

    Densities that expose the :meth:`~repro_torch.core.mlda.BalancedDensity.begin`
    / ``finish`` async split are dispatched through the balancer without
    blocking the driver; plain callables are evaluated inline (useful in
    tests and surrogate-only hierarchies).

    **Auto-resume** (``max_restarts > 0``): a chain whose evaluation
    errors past the balancer's retries is restarted from its latest
    snapshot — last secured fine sample, samples drawn so far, and the
    chain RNG state as of the snapshot — on a *fresh* sampler from the
    factory, up to ``max_restarts`` times before it counts as failed.
    Snapshots are taken every ``checkpoint_every`` fine samples (0 =
    start-state only: a restart replays the chain from its beginning).
    Snapshots live in memory; ``checkpoint_dir`` (on-disk snapshots)
    raises :class:`NotImplementedError` until the checkpoint module is
    ported.  The resumed chain continues the Markov chain from the
    snapshot state — statistically valid, but not bit-identical to the
    uninterrupted run (steps between the snapshot and the crash are
    redrawn).
    """

    def __init__(
        self,
        sampler_factory: Callable[[int], MLDASampler],
        n_chains: int,
        *,
        seed: Union[int, np.random.SeedSequence] = 0,
        balancer: Optional[LoadBalancer] = None,
        max_restarts: int = 0,
        checkpoint_every: int = 0,
        checkpoint_dir: Optional[str] = None,
    ) -> None:
        if n_chains < 1:
            raise ValueError("n_chains must be >= 1")
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "on-disk chain snapshots (checkpoint_dir) need the checkpoint "
                "module, a later slice of the port; in-memory auto-resume "
                "(max_restarts, checkpoint_every) works without it"
            )
        self.n_chains = int(n_chains)
        self._factory = sampler_factory
        self.samplers = [sampler_factory(c) for c in range(self.n_chains)]
        ss = (
            seed
            if isinstance(seed, np.random.SeedSequence)
            else np.random.SeedSequence(seed)
        )
        self.rngs = [np.random.default_rng(child) for child in ss.spawn(self.n_chains)]
        self.balancer = balancer or next(
            (s.balancer for s in self.samplers if s.balancer is not None), None
        )
        self.max_restarts = int(max_restarts)
        self.checkpoint_every = int(checkpoint_every)

    # -- driver ---------------------------------------------------------------
    def run(
        self,
        theta0: Theta0,
        n_samples: int,
        *,
        progress_every: int = 0,
    ) -> EnsembleResult:
        """Drive every chain to ``n_samples`` fine samples; pooled result.

        ``theta0`` is either one start state shared by all chains or a
        callable ``(chain_index, rng) -> theta`` for over-dispersed starts
        (what R-hat wants).

        Failure isolation: an evaluation error (server death past retries,
        balancer shutdown) fails only the chain that hit it — the rest run
        to completion and the casualty lands in ``EnsembleResult.failures``.
        With ``max_restarts`` the chain first auto-resumes from its latest
        snapshot that many times.  The run raises only when *every* chain
        failed.
        """
        chains: List[ChainState] = []
        inflight: List[Dict[int, Tuple[float, Any]]] = []
        # Auto-resume state: ``prefix[c]`` holds the fine samples secured
        # by chain c's previous incarnations (empty while it runs clean);
        # the live ChainState only draws the remainder.
        prefix: List[np.ndarray] = []
        snapshots: List[Dict[str, Any]] = []
        last_snap: List[int] = [0] * self.n_chains
        restarts: Dict[int, int] = {}
        for c, (sampler, rng) in enumerate(zip(self.samplers, self.rngs)):
            start = theta0(c, rng) if callable(theta0) else theta0
            start = np.asarray(start, dtype=float)
            chains.append(ChainState(sampler, start, n_samples, rng))
            inflight.append({})
            prefix.append(np.empty((0,) + start.shape))
            snapshots.append(self._snapshot(c, start, prefix[c], rng))
        runnable = list(range(self.n_chains))
        # chain index -> (pe, log_prior, request) it is parked on
        parked: Dict[int, Tuple[PendingEval, float, Any]] = {}
        failures: Dict[int, BaseException] = {}
        # One shared wakeup event, registered ONCE per parked request (not
        # per wait round), so long-running solves don't accumulate stale
        # callbacks while other chains' requests churn.
        wake = threading.Event()
        printed = 0
        while runnable or parked:
            revived: List[int] = []
            for c in runnable:
                try:
                    wait = self._pump(c, chains[c], inflight[c])
                except Exception as e:  # noqa: BLE001 - isolate this chain
                    if self._resume(
                        c, e, chains, inflight, prefix, snapshots,
                        last_snap, restarts, failures, n_samples,
                    ):
                        revived.append(c)
                    continue
                if wait is not None:
                    parked[c] = wait
                    wait[2].add_done_callback(lambda _r: wake.set())
            # Snapshot chains that just advanced (cadence: checkpoint_every
            # fine samples since the chain's last snapshot).
            if self.checkpoint_every > 0:
                for c in runnable:
                    if c in failures or chains[c].done:
                        continue
                    drawn = len(prefix[c]) + chains[c].samples_drawn
                    if drawn >= last_snap[c] + self.checkpoint_every:
                        last_snap[c] = drawn
                        snapshots[c] = self._take_snapshot(
                            c, chains[c], prefix[c], snapshots[c]["theta"]
                        )
            runnable = revived
            if runnable:
                continue  # pump restarted chains before sleeping
            if not parked:
                break  # every chain finished (or failed)
            if not any(req.done.is_set() for (_pe, _lp, req) in parked.values()):
                wake.wait()
            wake.clear()
            for c in list(parked):
                pe, lp, req = parked[c]
                if req.done.is_set():
                    del parked[c]
                    try:
                        self._finish(chains[c].sampler, pe, lp, req)
                    except Exception as e:  # noqa: BLE001
                        if self._resume(
                            c, e, chains, inflight, prefix, snapshots,
                            last_snap, restarts, failures, n_samples,
                        ):
                            runnable.append(c)
                        continue
                    runnable.append(c)
            if progress_every:
                total = sum(
                    len(p) + ch.samples_drawn for p, ch in zip(prefix, chains)
                )
                while total >= printed + progress_every:
                    printed += progress_every
                    print(
                        f"[ensemble] {printed}/{n_samples * self.n_chains} "
                        f"fine samples across {self.n_chains} chains",
                        flush=True,
                    )
        ok = [c for c in range(self.n_chains) if c not in failures]
        if not ok:
            raise RuntimeError(
                f"all {self.n_chains} chains failed"
            ) from next(iter(failures.values()))
        out = np.stack(
            [
                np.concatenate(
                    [prefix[c], np.asarray(chains[c].samples())]
                )[:n_samples]
                for c in ok
            ]
        )
        return EnsembleResult(
            chains=out,
            samplers=[self.samplers[c] for c in ok],
            failures=failures,
            restarts=restarts,
        )

    # -- auto-resume (snapshot / restart) -------------------------------------
    def _snapshot(
        self,
        c: int,
        theta: np.ndarray,
        samples: np.ndarray,
        rng: np.random.Generator,
    ) -> Dict[str, Any]:
        """One resume point: restart theta, secured samples, RNG state."""
        snap = {
            "theta": np.array(theta, dtype=float, copy=True),
            "samples": np.array(samples, copy=True),
            "rng_state": rng.bit_generator.state,
        }
        return snap

    def _take_snapshot(
        self, c: int, chain: ChainState, pre: np.ndarray, theta0: np.ndarray
    ) -> Dict[str, Any]:
        """Snapshot a live chain: everything secured so far.

        Taken while the chain may be parked on an in-flight solve — only
        *completed* fine samples and the RNG state are captured, so a
        restart replays from the last sample (the in-flight proposal is
        redrawn: a valid Markov-chain continuation, not a bit replay).
        """
        drawn = chain.samples_drawn
        secured = np.asarray(chain.samples())[:drawn]
        samples = np.concatenate([pre, secured]) if drawn else pre
        theta = samples[-1] if len(samples) else theta0
        return self._snapshot(c, theta, samples, chain.rng)

    def _resume(
        self,
        c: int,
        err: BaseException,
        chains: List[ChainState],
        inflight: List[Dict[int, Tuple[float, Any]]],
        prefix: List[np.ndarray],
        snapshots: List[Dict[str, Any]],
        last_snap: List[int],
        restarts: Dict[int, int],
        failures: Dict[int, BaseException],
        n_samples: int,
    ) -> bool:
        """Restart chain ``c`` from its latest snapshot, if budget allows.

        Returns True when the chain was revived (a fresh sampler from the
        factory picks up at the snapshot theta for the remaining draws);
        False when ``max_restarts`` is exhausted and the chain is failed.
        """
        chains[c].abort()
        used = restarts.get(c, 0)
        if used >= self.max_restarts:
            failures[c] = err
            return False
        restarts[c] = used + 1
        snap = snapshots[c]
        sampler = self._factory(c)
        self.samplers[c] = sampler
        rng = np.random.default_rng()
        rng.bit_generator.state = snap["rng_state"]
        self.rngs[c] = rng
        prefix[c] = np.asarray(snap["samples"])
        last_snap[c] = len(prefix[c])
        remaining = max(0, n_samples - len(prefix[c]))
        chains[c] = ChainState(sampler, snap["theta"], remaining, rng)
        inflight[c] = {}
        return True

    def _pump(
        self,
        c: int,
        chain: ChainState,
        inflight: Dict[int, Tuple[float, Any]],
    ) -> Optional[Tuple[PendingEval, float, Any]]:
        """Advance chain ``c`` until it must wait on a remote solve.

        Returns ``(pe, log_prior, request)`` when parked, ``None`` when the
        chain has finished.
        """
        while True:
            action = chain.step()
            if action is None:
                return None
            kind, pe = action
            density = chain.sampler.log_posteriors[pe.level]
            asynchronous = hasattr(density, "begin")
            if kind == "submit":
                if not asynchronous:
                    self._eval_inline(density, pe)
                    continue
                lp, req = density.begin(pe.theta)
                if req is None:
                    pe.resolve(lp)  # prior rejected: finished locally
                else:
                    inflight[id(pe)] = (lp, req)
                continue
            if kind == "await":
                entry = inflight.pop(id(pe), None)
                if entry is None:
                    if not pe.done:
                        raise RuntimeError(
                            "chain awaited an evaluation it never submitted"
                        )
                    continue  # resolved at submit time (local/instant)
                lp, req = entry
                if req.done.is_set():
                    self._finish(chain.sampler, pe, lp, req)
                    continue
                return pe, lp, req
            # kind == "eval": blocking semantics — park until resolved.
            if not asynchronous:
                self._eval_inline(density, pe)
                continue
            lp, req = density.begin(pe.theta)
            if req is None:
                pe.resolve(lp)
                continue
            if req.done.is_set():
                self._finish(chain.sampler, pe, lp, req)
                continue
            return pe, lp, req

    @staticmethod
    def _eval_inline(density: Callable, pe: PendingEval) -> None:
        t0 = time.monotonic()
        v = float(density(pe.theta))
        pe.resolve(v, seconds=time.monotonic() - t0)

    @staticmethod
    def _finish(sampler: MLDASampler, pe: PendingEval, lp: float, req: Any) -> None:
        density = sampler.log_posteriors[pe.level]
        v = density.finish(lp, req)  # raises if the request errored
        pe.resolve(v, seconds=req.service_time)


class DeviceChainStats:
    """Per-chain stats facade shaped like :class:`MLDASampler`.

    Device-resident chains have no step machine, but
    :class:`EnsembleResult` reports through the sampler interface
    (``levels`` / ``n_levels`` / ``speculation_summary``); this adapter
    carries the :class:`~repro_torch.core.mlda.LevelRecord` totals decoded
    from the ensemble's on-device counters.  Speculation does not exist on
    the device path (the ensemble runs the true branch, never a guess), so
    its telemetry is identically zero.
    """

    def __init__(self, levels: List[LevelRecord]) -> None:
        self.levels = levels
        self.balancer: Optional[LoadBalancer] = None

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def speculation_summary(self) -> Dict[str, Any]:
        return {
            "n_speculated": 0,
            "n_spec_hits": 0,
            "hit_rate": 0.0,
            "discarded_evals_per_level": [0] * len(self.levels),
        }


class DeviceEnsembleRunner:
    """Drive a :class:`repro_torch.core.mlda_device.DeviceEnsemble` to an
    :class:`EnsembleResult` (the ``device_resident=True`` ensemble mode).

    Two shapes, matching the ensemble's own modes:

    * **fully fused**: every density is device-resident; the run is a
      chunked loop of :meth:`~repro_torch.core.mlda_device.DeviceEnsemble.advance`
      calls (``chunk`` top-level steps per host sync, all chains in one
      graph replay a step).  The balancer is never consulted.
    * **coupled**: the finest level lives behind the balancer
      (``fine_density``: a :class:`~repro_torch.core.mlda.BalancedDensity`
      or plain callable).  Each step runs every chain's whole coarse
      subchain recursion in ONE graph replay (:meth:`propose`), surfaces
      only the moved chains' fine proposals to the balancer (submitted
      together, so same-level solves coalesce into stacked batches), and
      folds the results back in on the device (:meth:`accept`).

    Chains advance in lockstep, so failure semantics differ from
    :class:`EnsembleRunner`'s per-chain isolation: a fine-solve error past
    the balancer's retries aborts the whole run (the ensemble state is one
    fused tensor; there is no per-chain machine to park).  RNG: chain keys
    from :func:`repro_torch.core.counter_rng.chain_keys` ``(seed, C)``;
    chains equal per-chain :class:`MLDASampler` machines driven by
    :class:`~repro_torch.core.counter_rng.CounterStream` and
    :class:`~repro_torch.core.mlda_device.DeviceMatchedRandomWalk` bit for
    bit.  ``device_seconds`` is the wall time inside the device programs,
    each ended by its host copy.
    """

    def __init__(
        self,
        ensemble,  # repro_torch.core.mlda_device.DeviceEnsemble
        *,
        fine_density: Optional[Callable] = None,
        seed: int = 0,
        chunk: int = 16,
        balancer: Optional[LoadBalancer] = None,
    ) -> None:
        if ensemble.remote_top and fine_density is None:
            raise ValueError("coupled (remote-top) ensembles need fine_density")
        self.ensemble = ensemble
        self.fine_density = fine_density
        self.seed = int(seed)
        self.chunk = max(int(chunk), 1)
        self.balancer = balancer or getattr(fine_density, "balancer", None)
        self.device_seconds = 0.0  # wall-clock inside the device programs
        self.state = None  # EnsembleState after run()

    # -- driver ---------------------------------------------------------------
    def run(
        self,
        theta0: Theta0,
        n_samples: int,
        *,
        progress_every: int = 0,
    ) -> EnsembleResult:
        """Advance every chain ``n_samples`` top-level steps.

        ``theta0`` is ``(C, d)``: the chain count is its leading axis (the
        fused state is one stacked tensor, so over-dispersed starts are
        passed as rows, not as a per-chain callable).
        """
        if callable(theta0):
            raise TypeError(
                "device-resident ensembles take theta0 as a (C, d) array "
                "(one row per chain), not a per-chain callable"
            )
        theta0 = np.atleast_2d(np.asarray(theta0, dtype=np.float32))
        n_chains = theta0.shape[0]
        n_samples = int(n_samples)
        ens = self.ensemble
        top_seconds = np.zeros(n_chains)
        if ens.remote_top:
            chains = self._run_coupled(theta0, n_samples, top_seconds, progress_every)
        else:
            chains = self._run_fused(theta0, n_samples, progress_every)
        counts = self.state.counts.cpu().numpy()
        samplers = []
        for c in range(n_chains):
            levels = []
            for lvl in range(ens.n_levels):
                rec = LevelRecord()
                rec.n_accepted = int(counts[c, lvl, 0])
                rec.n_proposed = int(counts[c, lvl, 1])
                rec.n_evals = int(counts[c, lvl, 2])
                levels.append(rec)
            if ens.remote_top:
                levels[-1].eval_seconds = float(top_seconds[c])
            samplers.append(DeviceChainStats(levels))
        return EnsembleResult(chains=chains, samplers=samplers, failures={})

    def _progress(self, total: int, printed: int, every: int, of: int, what: str) -> int:
        while every and total >= printed + every:
            printed += every
            print(f"[ensemble/device] {printed}/{of} {what}", flush=True)
        return printed

    def _run_fused(
        self, theta0: np.ndarray, n_samples: int, progress_every: int
    ) -> np.ndarray:
        ens = self.ensemble
        n_chains = theta0.shape[0]
        state = ens.init(theta0, seed=self.seed)
        out: List[np.ndarray] = []
        drawn = printed = 0
        while drawn < n_samples:
            k = min(self.chunk, n_samples - drawn)
            t0 = time.monotonic()
            state, thetas, _logps = ens.advance(state, k)
            out.append(thetas.cpu().numpy())  # host sync: the replays really finished
            self.device_seconds += time.monotonic() - t0
            drawn += k
            printed = self._progress(drawn * n_chains, printed, progress_every,
                                     n_samples * n_chains, "fused chain steps")
        self.state = state
        return np.concatenate(out, axis=1)  # (C, n_samples, d)

    def _run_coupled(
        self,
        theta0: np.ndarray,
        n_samples: int,
        top_seconds: np.ndarray,
        progress_every: int,
    ) -> np.ndarray:
        ens = self.ensemble
        density = self.fine_density
        n_chains, dim = theta0.shape
        # Initial top density per chain: the one start-state evaluation the
        # Python machine books per level (counts[..., 2] starts at 1).
        logp0 = np.array([float(density(theta0[c])) for c in range(n_chains)])
        state = ens.init(theta0, seed=self.seed, logp0=logp0)
        samples = np.empty((n_chains, n_samples, dim), np.float32)
        printed = 0
        asynchronous = hasattr(density, "begin_many")
        for i in range(n_samples):
            t0 = time.monotonic()
            state, pending = ens.propose(state)
            moved = np.nonzero(pending.moved.cpu().numpy())[0]
            psi = pending.psi.cpu().numpy()
            self.device_seconds += time.monotonic() - t0
            logp_psi = np.zeros(n_chains, np.float64)
            if not asynchronous:
                for c in moved:
                    t1 = time.monotonic()
                    logp_psi[c] = float(density(psi[c]))
                    top_seconds[c] += time.monotonic() - t1
            else:
                # Submitted together: the balancer queues the moved chains'
                # solves at once and coalesces them into stacked batches;
                # finishing in order just collects the results.
                for c, (lp, req) in zip(moved, density.begin_many(list(psi[moved]))):
                    if req is None:  # prior rejected locally: no solve needed
                        logp_psi[c] = lp
                        continue
                    logp_psi[c] = density.finish(lp, req)
                    top_seconds[c] += req.service_time
            t2 = time.monotonic()
            state, _accepted = ens.accept(state, pending, logp_psi)
            samples[:, i] = state.theta.cpu().numpy()
            self.device_seconds += time.monotonic() - t2
            printed = self._progress((i + 1) * n_chains, printed, progress_every,
                                     n_samples * n_chains,
                                     f"fine samples across {n_chains} chains")
        self.state = state
        return samples
