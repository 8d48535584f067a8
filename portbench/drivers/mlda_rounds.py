"""MLDA rounds: the paper's Tōhoku inversion through the port's load
balancer, driven in rounds until the window is over.

Set-up builds the level hierarchy (96² and 288² shallow-water solves), fits
the level-0 GP on its LHS design, builds the level pools and the balancer
(``repro_torch.core.balanced_mlda``) and captures the solves' CUDA graphs:
bursts of 1, 2, 4 and 8 requests a level until a run of them captures
nothing new, then a round of the real chains.

The mix's ``mode`` picks the sampler.  ``step_machines``: the chains are
step machines multiplexed by ``EnsembleRunner``; every level's request goes
through the balancer.  ``device``: ``DeviceEnsembleRunner`` advances the
chains' coarse levels as fused graphs on the card, and only fine solves
reach the balancer.  A round continues every chain from its last sample
(``round_fine_samples`` fine samples a chain); the step machines keep their
own random streams across rounds, and the device ensemble takes a key a
round from the seed and the round's index (its graphs read the keys as
inputs, so nothing is captured again).  A traced run profiles one whole
round.

``fine_latency_p50_ms`` is the median, over every level-2 (fine) request
the chains send in the window, of the time from the chains' submit to the
reply, stamped on the harness's own clock around the balancer's client
calls (:class:`ReplyClock`).

Every stacked reply the pools give in the window is recorded as it leaves
the pool's handler.  After the window a sample of them, whole batches drawn
from the seed, is recomputed by the float64 reference
(``portbench.reference.tohoku``).  In device mode so are the ensemble's
level-1 log densities at the chains' last states, and the program's level-0
density (``device_densities``, the GP mean the fused graphs call) there.
"""
from __future__ import annotations

import math
import statistics
import time
from dataclasses import fields
from typing import Any, Dict, List

import numpy as np

from portbench.harness.bench import BenchBase
from portbench.harness.report import Check
from portbench.harness.trace import Tracer
from portbench.reference import tohoku as ref_tohoku

BUCKETS = (1, 2, 4, 8)
WARM_THETA = (12.5, -7.5)
# Graph warm-up: bursts until this many passes in a row capture nothing
# new, or this many seconds have gone.
WARM_QUIET_PASSES = 8
WARM_BUDGET_S = 6.0


def workload_config(c: Dict[str, Any]):
    """The program's ``MLDAWorkloadConfig`` from the configuration file."""
    from repro_torch.configs.tohoku_mlda import MLDAWorkloadConfig

    names = {f.name for f in fields(MLDAWorkloadConfig)}
    kw = {k: v for k, v in c.items() if k in names}
    for k in ("coarse_grid", "fine_grid", "subchain_lengths"):
        kw[k] = tuple(kw[k])
    kw["servers_per_level"] = {int(k): int(v) for k, v in kw["servers_per_level"].items()}
    kw["name"] = c["name"]
    return MLDAWorkloadConfig(**kw)


class Recorder:
    """Keeps every stacked (thetas, replies) a pool's handler returns while
    ``on``; the handler's result is passed on untouched."""

    def __init__(self) -> None:
        self.on = False
        self.batches: List = []

    def wrap(self, fn):
        def handler(stacked):
            out = fn(stacked)
            if self.on:
                self.batches.append((stacked, out))
            return out

        return handler


class ReplyClock:
    """Stamps, while ``on``, the submit and the reply of every request of
    ``tag`` that goes through ``lb``'s client calls (``submit_async``,
    ``submit_many``), on the harness's clock; ``ms`` holds the latencies."""

    def __init__(self, lb, tag: str) -> None:
        self.tag = tag
        self.on = False
        self.ms: List[float] = []
        one, many = lb.submit_async, lb.submit_many

        def submit_async(theta, *a, **k):
            t = time.monotonic()
            req = one(theta, *a, **k)
            self._watch(req, t)
            return req

        def submit_many(thetas, *a, **k):
            t = time.monotonic()
            reqs = many(thetas, *a, **k)
            for req in reqs:
                self._watch(req, t)
            return reqs

        lb.submit_async, lb.submit_many = submit_async, submit_many

    def _watch(self, req, t: float) -> None:
        if self.on and req.tag == self.tag:
            req.add_done_callback(lambda _r: self.ms.append((time.monotonic() - t) * 1e3))


def _snapshot(lb) -> Dict[str, Any]:
    s = lb.summary()
    return {"idle_sum": s["mean_idle_s"] * s["n_requests"], "idle_n": s["n_requests"],
            "uptime": dict(s["per_server_uptime"]), "failures": s["failures"]}


class Bench(BenchBase):
    def __init__(self, ctx) -> None:
        super().__init__()
        import torch

        from repro_torch.core import GaussianRandomWalk, balanced_mlda
        from repro_torch.swe import (
            build_hierarchy,
            device_densities,
            local_level_servers,
            train_level0_gp,
        )

        self.ctx = ctx
        self.mix = ctx.mix
        self.cfg = ctx.config
        self.mode = self.mix["mode"]
        w = self.w = workload_config(self.cfg)
        dev = torch.device(ctx.device)
        t0 = time.perf_counter()
        h = build_hierarchy(w, dev)
        prob = self.prob = h["problem"]
        gp = train_level0_gp(h["forward_coarse_batch"], prob, n_train=w.gp_train_points,
                             steps=w.gp_opt_steps)
        ctx.log(f"hierarchy and GP {time.perf_counter() - t0:.2f} s")
        servers = local_level_servers(w, gp, h)
        self.recorders = {lvl: Recorder() for lvl in range(3)}
        self.level_servers: Dict[int, List[str]] = {0: [], 1: [], 2: []}
        for s in servers:
            lvl = int(next(iter(s.capacity_tags))[len("level"):])
            self.level_servers[lvl].append(s.name)
            s.batch_fn = self.recorders[lvl].wrap(s.batch_fn)
        common = dict(policy=w.balancer_policy, batchable_levels=w.batchable_levels,
                      ensemble_seed=ctx.seed, **w.balancer_kwargs())
        proposal = GaussianRandomWalk(w.rw_step_km)
        if self.mode == "device":
            self.densities = device_densities(prob, gp, h["forward_coarse_batch"])
            self.runner, self.lb = balanced_mlda(
                servers, prob.log_likelihood, prob.log_prior, proposal, list(w.subchain_lengths),
                device_resident=True, device=ctx.device, device_chunk=w.device_chunk,
                device_densities=self.densities, **common)
            rng = np.random.default_rng(ctx.seed)
            self.last = np.stack([prob.sample_prior(rng)[0] * 0.5 for _ in range(w.n_chains)])
        else:
            self.runner, self.lb = balanced_mlda(
                servers, prob.log_likelihood, prob.log_prior, proposal, list(w.subchain_lengths),
                n_chains=w.n_chains, speculative=w.speculative_prefetch, as_runner=True,
                **common, **w.runner_kwargs())
            self.last = None
        self.fine_clock = ReplyClock(self.lb, "level2")
        self.forwards = {1: h["forward_coarse_batch"], 2: h["forward_fine_batch"]}
        self.rounds = 0
        self.chain_failures = 0
        self._warm_graphs()
        self._round(int(self.mix["warm_fine_samples"]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.attempted = self.failed = 0

    # -- set-up ----------------------------------------------------------------
    def _n_graphs(self, lvl: int) -> int:
        return sum(len(v) for v in self.forwards[lvl].executables.values())

    def _warm_graphs(self) -> None:
        """Capture the levels' padded batch sizes on the worker threads:
        bursts of 1, 2, 4 and 8 requests through the balancer, both levels
        at once, until a run of passes captures nothing new (which worker
        takes a burst is the dispatcher's choice, so a rare (size, thread)
        pair may be left for the window; the window counts those)."""
        if self.ctx.device != "cuda":
            return
        levels = [1, 2] if self.mode != "device" else [2]
        buckets = [b for b in BUCKETS if b <= self.w.max_batch]
        t_end = time.monotonic() + WARM_BUDGET_S
        passes = quiet = 0
        while time.monotonic() < t_end and quiet < WARM_QUIET_PASSES:
            n0 = self._graphs()
            for k in buckets:
                reqs = []
                for lvl in levels:
                    reqs += self.lb.submit_many([np.array(WARM_THETA)] * k, tag=f"level{lvl}",
                                                batchable=True)
                for r in reqs:
                    self.lb.result(r)
            passes += 1
            quiet = quiet + 1 if self._graphs() == n0 else 0
        self.ctx.log(f"{self._graphs()} graphs after {passes} warm-up passes")

    def _graphs(self) -> int:
        return sum(self._n_graphs(lvl) for lvl in self.forwards)

    # -- rounds ------------------------------------------------------------------
    def _round(self, n: int) -> int:
        """One round of ``n`` fine samples a chain; returns the samples."""
        if self.mode == "device":
            self.runner.seed = (int(self.ctx.seed) * 1_000_003 + self.rounds) & ((1 << 63) - 1)
            res = self.runner.run(self.last, n)
        else:
            last = self.last
            start = ((lambda c, rng: last[c]) if last is not None
                     else (lambda c, rng: self.prob.sample_prior(rng)[0] * 0.5))
            res = self.runner.run(start, n)
            self.chain_failures += len(res.failures)
        self.rounds += 1
        self.last = res.chains[:, -1, :].copy()
        return int(res.chains.shape[0] * res.chains.shape[1])

    def window(self) -> None:
        n_round = int(self.mix["round_fine_samples"])
        before = _snapshot(self.lb)
        for r in self.recorders.values():
            r.on = True
        self.fine_clock.on = True
        t0 = time.monotonic()
        deadline = t0 + float(self.ctx.seconds)
        n_fine = rounds = 0
        graphs = self._graphs()
        tracer = Tracer(self.ctx.out_dir) if self.ctx.trace else None
        trace_after = float(self.mix.get("trace_offset_s", min(0.25 * self.ctx.seconds, 8.0)))
        paused = 0.0
        while time.monotonic() < deadline:
            # A traced run profiles one whole round, the first that starts
            # ``trace_offset_s`` into the window: between rounds every
            # chain has its replies and the pools are idle.  The profiler's
            # start, stop and the reading of its trace (tens of seconds)
            # are left out of the window, which is lengthened by them.
            traced = (tracer is not None and self.trace is None
                      and time.monotonic() - t0 >= trace_after)
            if traced:
                p0 = time.monotonic()
                tracer.start()
                paused += time.monotonic() - p0
            n_fine += self._round(n_round)
            rounds += 1
            if traced:
                p0 = time.monotonic()
                self.trace = tracer.stop()
                paused += time.monotonic() - p0
                deadline += paused
        t1 = time.monotonic()
        self.fine_clock.on = False
        for r in self.recorders.values():
            r.on = False
        after = _snapshot(self.lb)
        self.n_fine = n_fine
        self.window_s = t1 - t0 - paused
        self.attempted = sum(len(np.asarray(o)) for r in self.recorders.values()
                             for _, o in r.batches)
        self.failed = int(after["failures"] - before["failures"]) + self.chain_failures
        fine = self.level_servers[2]
        grids = {}
        for g in (self.w.coarse_grid, self.w.fine_grid):
            grids[str(math.ceil(g[0] / 32))] = [int(g[1]), int(g[0])]  # x tiles -> (ny, nx)
        self.facts = {
            "window_s": self.window_s,
            "rounds": rounds,
            "fine_samples": n_fine,
            "trace_pause_s": paused,
            "idle_sum_s": after["idle_sum"] - before["idle_sum"],
            "idle_n": after["idle_n"] - before["idle_n"],
            "fine_busy_s": sum(after["uptime"][n] - before["uptime"][n] for n in fine),
            "n_fine_servers": len(fine),
            "grids": grids,
            "n_probes": 2,
            "graphs_captured_in_window": self._graphs() - graphs,
        }
        if self.mode == "device":
            st = self.runner.state
            self.final_theta = st.theta.detach().cpu().numpy().astype(np.float64)
            self.final_logp_low = st.logp_low.detach().cpu().numpy().astype(np.float64)
            self.final_logp_gp = self.densities[0](st.theta).double().cpu().numpy()

    def end_to_end(self) -> Dict[str, float]:
        out = {"fine_samples_per_s": self.n_fine / self.window_s}
        if self.fine_clock.ms:
            out["fine_latency_p50_ms"] = statistics.median(self.fine_clock.ms)
        return out

    def release(self) -> None:
        import torch

        self.lb.shutdown()
        self.runner = self.lb = self.forwards = self.densities = None
        if self.ctx.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------------------
    def _samples(self) -> Dict[int, tuple]:
        """The replies judged: whole batches a level, drawn from the seed
        (:func:`portbench.reference.tohoku.sample_batches`)."""
        rng = np.random.default_rng(self.ctx.seed)
        out = {}
        for lvl in (2, 1, 0):
            batches = self.recorders[lvl].batches
            if batches:
                k = int(self.mix["check_samples"][str(lvl)])
                out[lvl] = ref_tohoku.sample_batches(batches, k, rng)
        return out

    def readings(self, control: bool = False) -> Dict[str, float]:
        """The numbers compared: the program's (or, with ``control``, the
        bfloat16 reference's in its place) distance from the float64
        reference."""
        import torch

        ref = ref_tohoku.Tohoku(self.cfg, dtype=torch.float64, device=self.ctx.device)
        ctl = ref_tohoku.Tohoku(self.cfg, dtype=torch.bfloat16, device=self.ctx.device) \
            if control else None
        out: Dict[str, float] = {}
        for lvl, (th, ob) in self._samples().items():
            truth = ref.level(lvl, th)
            if ctl is not None:
                if lvl == 0:  # the surrogate's mean in bfloat16, its fit the reference's
                    ob = ref.level(0, th, gp_dtype=torch.bfloat16)
                else:
                    ob = ctl.level(lvl, th)
            out[f"l{lvl}_obs_err_sigma"] = ref_tohoku.obs_error_sigma(ob, truth)
        if self.mode == "device":
            for lvl, prog in ((1, self.final_logp_low), (0, self.final_logp_gp)):
                truth = ref.log_density(lvl, self.final_theta)
                if ctl is None:
                    got = prog
                elif lvl == 0:
                    got = ref.log_density(0, self.final_theta, gp_dtype=torch.bfloat16)
                else:
                    got = ctl.log_density(1, self.final_theta)
                out[f"l{lvl}_logp_err"] = float(np.nan_to_num(np.abs(got - truth), nan=np.inf).max())
        return out

    def verify(self) -> List[Check]:
        limits = self.mix["limits"]
        return [Check(k, v, float(limits[k])) for k, v in self.readings().items()]

    def extra(self) -> Dict[str, Any]:
        return {"rounds": self.facts.get("rounds"), "fine_samples": self.n_fine,
                "fine_requests": len(self.fine_clock.ms),
                "graphs_captured_in_window": self.facts.get("graphs_captured_in_window"),
                "multi_row_batches": {lvl: sum(len(np.asarray(o)) > 1 for _, o in r.batches)
                                      for lvl, r in self.recorders.items()}}
