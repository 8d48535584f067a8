"""Quickstart on the port: the paper's pieces on a toy problem in seconds.

The counterpart of the reference's ``examples/quickstart.py``:

1. a 'forward model' hierarchy (cheap biased coarse / exact fine) as
   TorchModels (:class:`~repro_torch.core.model.TorchModel`) on one device;
2. the load balancer dispatching heterogeneous evaluations (Algorithm 1);
3. MLDA sampling through the balancer, then the vectorised lockstep
   variant (:func:`~repro_torch.core.mlda_device.run_chains`, 8 chains x
   200 steps).

Run on the card (the default)::

    PYTHONPATH=src python -m repro_torch.launch.quickstart

or on the CPU with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.balancer import Server, available_policies
from repro_torch.core import GaussianRandomWalk, TorchModel, balanced_mlda, run_chains
from repro_torch.core.diagnostics import summarize_chain
from repro_torch.device import resolve_device

Y_OBS = np.array([1.0, -1.0])
N_VECTOR_CHAINS = 8
N_VECTOR_STEPS = 200


def _on_host(obs) -> np.ndarray:
    return torch.as_tensor(obs).detach().cpu().numpy()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}")

    # --- forward models: F(theta) = theta (identity), observed y = (1, -1) --
    fine = TorchModel(lambda t: t, name="fine", input_dim=2, output_dim=2,
                      cost_s=0.01, device=dev)
    coarse = TorchModel(lambda t: t + 0.25, name="coarse", input_dim=2, output_dim=2,
                        cost_s=0.0005, device=dev)

    # --- persistent server pool + balancer (paper Section 2) ----------------
    # Scheduling is pluggable (DESIGN.md §3): 'fifo' is the paper-faithful
    # Algorithm 1; swap the string to explore the rest of the registry.
    print("scheduling policies available:", ", ".join(available_policies()))
    servers = [
        Server(coarse, name="coarse-0", capacity_tags=("level0",)),
        Server(fine, name="fine-0", capacity_tags=("level1",)),
        Server(fine, name="fine-1", capacity_tags=("level1",)),
    ]

    def log_like(obs) -> float:
        return -0.5 * float(np.sum((_on_host(obs) - Y_OBS) ** 2)) / 0.1

    def log_prior(t) -> float:
        return 0.0 if np.all(np.abs(t) < 10) else float("-inf")

    # --- MLDA through the balancer (paper Section 5) -------------------------
    t0 = time.time()
    sampler, lb = balanced_mlda(
        servers, log_like, log_prior, GaussianRandomWalk(0.4), [5],
        policy="fifo", batchable_levels=(),
    )
    try:
        chain = sampler.sample(np.zeros(2), 100, np.random.default_rng(0))
        print(f"MLDA via balancer (policy={lb.policy.name}): {time.time() - t0:.1f}s")
        print("posterior summary:", summarize_chain(chain[20:]))
        for row in sampler.stats_table():
            print(
                f"  level {row['level']}: {row['n_evals']} evals, "
                f"acc={row['acceptance_rate']:.2f}, "
                f"mean_eval={row['mean_eval_s'] * 1e3:.1f}ms"
            )
        s = lb.summary()
        print(f"balancer idle: mean={s['mean_idle_s'] * 1e3:.2f}ms "
              f"p99={s['p99_idle_s'] * 1e3:.2f}ms")
    finally:
        lb.shutdown()  # joins dispatcher + workers; thread count back to baseline

    # --- vectorised lockstep MLDA (beyond paper, DESIGN.md §2) ---------------
    t0 = time.time()
    y = torch.as_tensor(Y_OBS, dtype=torch.float32, device=dev)

    def lp0(t: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum((t + 0.25 - y) ** 2, dim=-1) / 0.1

    def lp1(t: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum((t - y) ** 2, dim=-1) / 0.1

    res = run_chains([lp0, lp1], [5], 0.4, 0, np.zeros((N_VECTOR_CHAINS, 2)),
                     N_VECTOR_STEPS, device=dev)
    x = res.chain[:, 50:, :].reshape(-1, 2).cpu().numpy()
    print(f"vectorised MLDA ({N_VECTOR_CHAINS} chains x {N_VECTOR_STEPS}): "
          f"{time.time() - t0:.1f}s")
    print("  mean:", x.mean(0).round(3), " (truth posterior mean ~ (1, -1))")
    return {"mlda_chain": chain, "sampler": sampler, "vectorised": res}


if __name__ == "__main__":
    main()
