"""The paper's experiment (§6) on the port: Tōhoku MLDA end to end.

Stages, as in the reference's ``examples/tsunami_inversion.py``:

1. the synthetic Tōhoku scenario at a coarse and a fine grid, and the
   observations from the fine model at the true source (0, 0);
2. the level-0 GP surrogate, trained on Latin-hypercube coarse solves;
3. 3-level MLDA chains, multiplexed by the ensemble driver through the load
   balancer onto per-level ``BatchServer`` pools;
4. the report: posterior, per-level evaluations and acceptance, balancer
   idle times, realised batch sizes and, for remote pools, the wire/service
   split per level; then the Fig. 6 time-series GP: 32 LHS coarse solves of
   the probe-0 series, a GP over them, its prediction at the posterior mean.

Run on the card (the default device)::

    PYTHONPATH=src python -m repro_torch.launch.tsunami --workload paper \\
        --chains 5 --fine-samples 40

``--device cpu`` runs the plain PyTorch versions instead (slow at the paper
preset; use ``--workload cpu`` there).

Remote serving (``--remote host:port[,host:port]``, DESIGN.md §11): the
level pools live in other processes, each running
``python -m repro_torch.launch.export``, and this process dials them
(binary framing, or UM-Bridge HTTP/JSON with ``--remote-json``) instead of
training a GP and building pools of its own::

    PYTHONPATH=src python -m repro_torch.launch.export --workload cpu \\
        --host 127.0.0.1 --port 4242 &
    PYTHONPATH=src python -m repro_torch.launch.tsunami --workload cpu \\
        --remote 127.0.0.1:4242
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.balancer import available_policies
from repro_torch.configs.tohoku_mlda import CONFIGS, MLDAWorkloadConfig
from repro_torch.core import GaussianRandomWalk, balanced_mlda
from repro_torch.core.diagnostics import telescoping_estimate, variance_reduction_check
from repro_torch.device import resolve_device
from repro_torch.swe import (
    TohokuScenario,
    build_hierarchy,
    close_transports,
    local_level_servers,
    make_remote_level_servers,
    train_level0_gp,
)

# The Fig. 6 series GP, as the reference's example fits it: LHS design size
# and seed, solves per batched call, Adam steps.
SERIES_GP_POINTS = 32
SERIES_GP_SEED = 7
SERIES_GP_BATCH = 8
SERIES_GP_STEPS = 60


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def series_gp(coarse: TohokuScenario, prob, theta, *, device) -> Tuple[Any, Any]:
    """The Fig. 6 time-series GP: ``SERIES_GP_POINTS`` LHS draws of the
    coarse probe-0 SSHA series, solved ``SERIES_GP_BATCH`` at a time, a GP
    over them, and its prediction at ``theta``: ``(gp, series)``."""
    from repro_torch.core.gp import fit_gp
    from repro_torch.core.lhs import latin_hypercube, scale_to_bounds

    series_fwd = coarse.build_batch_series_forward()
    lo, hi = prob.prior_bounds()
    u = latin_hypercube(torch.Generator().manual_seed(SERIES_GP_SEED), SERIES_GP_POINTS, 2)
    xs = scale_to_bounds(u, lo, hi).to(device)
    ys = torch.cat([series_fwd(xs[i : i + SERIES_GP_BATCH])
                    for i in range(0, SERIES_GP_POINTS, SERIES_GP_BATCH)])
    gp = fit_gp(xs, ys, steps=SERIES_GP_STEPS, device=device)
    return gp, gp(torch.as_tensor(np.asarray(theta), dtype=torch.float32))


def run(
    w: MLDAWorkloadConfig,
    *,
    n_chains: Optional[int] = None,
    policy: Optional[str] = None,
    device: str = "cuda",
    remote: Sequence[str] = (),
    remote_binary: bool = True,
    checkpoint_dir: Optional[str] = None,
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Run stages 1-4 and the series GP for workload ``w``; return what the
    report prints.  ``remote`` names ``host:port`` endpoints of
    ``launch.export`` processes to evaluate on (binary framing, or
    UM-Bridge JSON without ``remote_binary``) instead of in-process pools;
    then ``gp`` is None.  ``w.mesh_devices`` makes each in-process level
    one sharded pool over that many cards; ``checkpoint_dir`` writes each
    chain's snapshots there (``chain_<c>.npz``, every ``w.checkpoint_every``
    fine samples) and needs ``w.max_restarts`` > 0: without a restart a
    snapshot is never read."""
    if checkpoint_dir is not None and w.max_restarts <= 0:
        raise ValueError(
            f"checkpoint_dir needs a workload with max_restarts > 0 "
            f"({w.name} has {w.max_restarts})"
        )
    dev = resolve_device(device)
    n_chains = n_chains or w.n_chains
    policy = policy or w.balancer_policy
    walls: Dict[str, float] = {}

    log(f"[1/4] building {w.name} hierarchy "
        f"(coarse {w.coarse_grid}, fine {w.fine_grid}) on {dev}")
    t0 = time.perf_counter()
    h = build_hierarchy(w, dev)
    prob = h["problem"]
    _synchronize(dev)
    walls["hierarchy_s"] = time.perf_counter() - t0
    log(f"      y_obs = {np.round(prob.y_obs, 4)} (truth at {prob.theta_true}); "
        f"steps coarse {h['forward_coarse'].n_steps}, fine {h['forward_fine'].n_steps}")

    gp = None
    t0 = time.perf_counter()
    if remote:
        # The exporting processes own the level pools (GP included): no
        # local surrogate training, just transports + remote replicas.
        log(f"[2/4] remote serving: dialing {list(remote)} "
            f"({'binary' if remote_binary else 'UM-Bridge JSON'} mode)")
        servers = make_remote_level_servers(w, remote, binary=remote_binary)
        walls["connect_s"] = time.perf_counter() - t0
        log(f"      {len(servers)} remote servers: "
            f"{sorted(t for s in servers for t in s.capacity_tags)}")
    else:
        log(f"[2/4] training level-0 GP on {w.gp_train_points} LHS coarse solves "
            f"({w.gp_opt_steps} Adam steps)")
        gp = train_level0_gp(
            h["forward_coarse_batch"], prob, n_train=w.gp_train_points,
            steps=w.gp_opt_steps,
        )
        _synchronize(dev)
        walls["gp_train_s"] = time.perf_counter() - t0
        log(f"      {walls['gp_train_s']:.1f}s")
        servers = local_level_servers(w, gp, h)

    log(f"[3/4] MLDA x {n_chains} chains via the ensemble driver "
        f"(policy={policy}, speculative={w.speculative_prefetch}, "
        f"batch_solves={w.batch_solves}, {w.n_fine_samples} fine samples each)")
    try:
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
            checkpoint_dir=checkpoint_dir,
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
    finally:
        if remote:  # one shared transport per endpoint: close each once
            close_transports(servers)

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
    if summary.get("wire_split"):
        log("      wire vs remote service (EWMA ms per call):")
        for key, wsp in sorted(summary["wire_split"].items()):
            log(f"        {key}: wire={wsp['wire_ewma_s'] * 1e3:.2f}ms "
                f"service={wsp['service_ewma_s'] * 1e3:.2f}ms "
                f"({wsp['calls']} calls)")

    # Fig. 6 analogue: GP over the full probe-0 time series.
    log("      fitting Fig. 6 time-series GP (probe 21418 analogue)")
    t0 = time.perf_counter()
    ts_gp, post_series = series_gp(h["coarse"], prob, post_mean, device=dev)
    _synchronize(dev)
    walls["series_gp_s"] = time.perf_counter() - t0
    log(f"      reconstructed series: len={post_series.shape[0]}, "
        f"max SSHA={float(post_series.max()):.3f} m ({walls['series_gp_s']:.1f}s)")
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
        "series_gp": ts_gp,
        "posterior_series": post_series,
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
    ap.add_argument("--remote", default="",
                    help="comma-separated host:port endpoints (repro_torch.launch.export "
                    "processes) to evaluate on instead of in-process pools")
    ap.add_argument("--remote-json", action="store_true",
                    help="use the UM-Bridge HTTP/JSON interop mode instead of binary framing")
    args = ap.parse_args(argv)
    w = CONFIGS[args.workload]
    if args.fine_samples:
        w = replace(w, n_fine_samples=args.fine_samples)
    remote = tuple(a.strip() for a in args.remote.split(",") if a.strip())
    return run(w, n_chains=args.chains or None, policy=args.policy or None,
               device=args.device, remote=remote, remote_binary=not args.remote_json)


if __name__ == "__main__":
    main()
