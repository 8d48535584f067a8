"""The paper's experiment (§6) on the port: Tōhoku MLDA end to end.

Stages, as in the reference's ``examples/tsunami_inversion.py``:

1. the synthetic Tōhoku scenario at a coarse and a fine grid, and the
   observations from the fine model at the true source (0, 0);
2. the level-0 GP surrogate, trained on Latin-hypercube coarse solves;
3. 3-level MLDA chains, multiplexed by the ensemble driver through the load
   balancer onto per-level ``BatchServer`` pools;
4. the report: posterior, per-level evaluations and acceptance, balancer
   idle times and realised batch sizes.

Run on the card (the default device)::

    PYTHONPATH=src python -m repro_torch.launch.tsunami --workload paper \\
        --chains 5 --fine-samples 40

``--device cpu`` runs the plain PyTorch versions instead (slow at the paper
preset; use ``--workload cpu`` there).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.balancer import available_policies
from repro_torch.configs.tohoku_mlda import CONFIGS, MLDAWorkloadConfig
from repro_torch.core import GaussianRandomWalk, balanced_mlda
from repro_torch.core.diagnostics import telescoping_estimate, variance_reduction_check
from repro_torch.device import resolve_device
from repro_torch.swe import (
    TohokuScenario,
    make_hierarchy,
    make_level_servers,
    train_level0_gp,
)


def _synchronize(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def run(
    w: MLDAWorkloadConfig,
    *,
    n_chains: Optional[int] = None,
    policy: Optional[str] = None,
    device: str = "cuda",
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Run stages 1-4 for workload ``w``; return what the report prints."""
    dev = resolve_device(device)
    n_chains = n_chains or w.n_chains
    policy = policy or w.balancer_policy
    walls: Dict[str, float] = {}

    log(f"[1/4] building {w.name} hierarchy "
        f"(coarse {w.coarse_grid}, fine {w.fine_grid}) on {dev}")
    t0 = time.perf_counter()
    fine = TohokuScenario(
        nx=w.fine_grid[0], ny=w.fine_grid[1], t_end=w.t_end_s, device=str(dev)
    )
    coarse = TohokuScenario(
        nx=w.coarse_grid[0], ny=w.coarse_grid[1], t_end=w.t_end_s, device=str(dev)
    )
    h = make_hierarchy(fine=fine, coarse=coarse)
    prob = h["problem"]
    _synchronize(dev)
    walls["hierarchy_s"] = time.perf_counter() - t0
    log(f"      y_obs = {np.round(prob.y_obs, 4)} (truth at {prob.theta_true}); "
        f"steps coarse {h['forward_coarse'].n_steps}, fine {h['forward_fine'].n_steps}")

    log(f"[2/4] training level-0 GP on {w.gp_train_points} LHS coarse solves "
        f"({w.gp_opt_steps} Adam steps)")
    t0 = time.perf_counter()
    gp = train_level0_gp(
        h["forward_coarse_batch"], prob, n_train=w.gp_train_points,
        steps=w.gp_opt_steps,
    )
    _synchronize(dev)
    walls["gp_train_s"] = time.perf_counter() - t0
    log(f"      {walls['gp_train_s']:.1f}s")
    servers = make_level_servers(
        w, gp, h["forward_coarse"], h["forward_fine"],
        batch_forwards=(
            None, h["forward_coarse_batch"], h["forward_fine_batch"]
        ) if w.batch_solves else None,
    )

    log(f"[3/4] MLDA x {n_chains} chains via the ensemble driver "
        f"(policy={policy}, speculative={w.speculative_prefetch}, "
        f"batch_solves={w.batch_solves}, {w.n_fine_samples} fine samples each)")
    runner, lb = balanced_mlda(
        servers,
        prob.log_likelihood,
        prob.log_prior,
        GaussianRandomWalk(w.rw_step_km),
        list(w.subchain_lengths),
        policy=policy,
        batchable_levels=w.batchable_levels,
        n_chains=n_chains,
        ensemble_seed=w.ensemble_seed,
        speculative=w.speculative_prefetch,
        as_runner=True,
        **w.balancer_kwargs(),
        **w.runner_kwargs(),
    )
    try:
        t0 = time.perf_counter()
        result = runner.run(
            lambda c, rng: prob.sample_prior(rng)[0] * 0.5, w.n_fine_samples
        )
        walls["sampling_s"] = time.perf_counter() - t0
        summary = lb.summary()
    finally:
        lb.shutdown()  # joins the dispatcher + worker pool; no leaked threads

    log(f"[4/4] results ({walls['sampling_s']:.1f}s sampling wall time)")
    burn = max(2, w.n_fine_samples // 5)
    allc = result.pooled(burn)
    post_mean = allc.mean(0)
    log(f"      fine posterior mean = {post_mean.round(1)} km "
        f"(reference (0, 0); paper Fig. 7)")
    log(f"      fine posterior std  = {allc.std(0).round(1)} km")
    log(f"      split-R-hat = {result.gelman_rubin().round(3)}  "
        f"ESS(total) = {np.round(result.ess().sum(0), 1)}")
    levels = result.level_totals()
    log("      level | evals | acc   | mean eval | spec-discard")
    for row in levels:
        log(f"        {row['level']}   | {row['n_evals']:5d} "
            f"| {row['acceptance_rate']:.3f} "
            f"| {row['mean_eval_s'] * 1e3:8.1f} ms "
            f"| {row['n_spec_discarded']:5d}")
    spec_total = result.summary()
    log(f"      speculative prefetch: {spec_total['n_spec_hits']}"
        f"/{spec_total['n_speculated']} guesses held")
    sample_sets = [
        np.concatenate([np.asarray(s.levels[lvl].samples) for s in result.samplers])
        for lvl in range(3)
    ]
    tele = telescoping_estimate(sample_sets)
    log(f"      telescoped mean (Eq. 7) = {tele['telescoped_mean'].round(1)}")
    log(f"      variance reduction up the hierarchy: "
        f"{variance_reduction_check(sample_sets)}")
    log(f"      balancer idle (Fig. 9, policy={policy}): "
        f"mean={summary['mean_idle_s'] * 1e3:.2f}ms "
        f"p99={summary['p99_idle_s'] * 1e3:.1f}ms "
        f"max={summary['max_idle_s'] * 1e3:.1f}ms")
    if summary["batch_histogram"]:
        log(f"      realised batch sizes {{level: {{size: count}}}}: "
            f"{summary['batch_histogram']}")
    return {
        "y_obs": prob.y_obs,
        "posterior_mean": post_mean,
        "chains": result.chains,
        "levels": levels,
        "failures": result.failures,
        "balancer": summary,
        "walls": walls,
        "gp": gp,
        "hierarchy": h,
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="cpu", choices=list(CONFIGS))
    ap.add_argument("--chains", type=int, default=0, help="override chain count")
    ap.add_argument("--fine-samples", type=int, default=0,
                    help="override fine samples per chain")
    ap.add_argument("--policy", default="", choices=[""] + available_policies(),
                    help="scheduling policy (default: the workload's)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    w = CONFIGS[args.workload]
    if args.fine_samples:
        w = replace(w, n_fine_samples=args.fine_samples)
    return run(w, n_chains=args.chains or None, policy=args.policy or None,
               device=args.device)


if __name__ == "__main__":
    main()
