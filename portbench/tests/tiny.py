"""Small sizes at which the cells run on the CPU in the tests, with the
port's plain kernel versions."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

MLDA = {
    "config": {"coarse_grid": [16, 16], "fine_grid": [24, 24], "t_end_s": 3600.0,
               "gp_train_points": 16, "gp_opt_steps": 5, "subchain_lengths": [3, 2]},
    "mix": {"round_fine_samples": 2, "warm_fine_samples": 1,
            "check_samples": {"0": 8, "1": 2, "2": 2}, "trace_offset_s": 0.0},
}
LM = {
    "config": {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
               "num_key_value_heads": 2, "intermediate_size": 32, "num_local_experts": 4,
               "num_experts_per_tok": 2, "vocab_size": 256, "torch_dtype": "float32",
               "capacity_factor": 2.0},
    "mix": {"engine": {"slots": 4, "cache_len": 64, "block_size": 16, "prefill_chunk": 16},
            "prompt": {"dist": "uniform", "min": 4, "max": 40},
            "output": {"dist": "lognormal", "median": 6, "sigma": 0.5, "min": 2, "max": 20},
            "rate_rps": 8.0, "clients": 6, "check_tokens": 40,
            "drain_s": 30.0},
}
# Limits at these sizes, from their readings: a sound tiny run reads at
# most 0.15 sigma on the observables (fp32 against float64; the soft
# arrival time magnifies one ulp of h), the bfloat16 control 50-75 sigma;
# the fp32 served tokens sit on the fp32 reference's best (gap 0).
TINY_LIMITS = {"l0_obs_err_sigma": 1.0, "l1_obs_err_sigma": 1.0, "l2_obs_err_sigma": 1.0,
               "l1_logp_err": 5.0, "l0_logp_err": 3.0, "mean_token_gap": 1e-3}


def overrides(cell_name: str, limits: bool = True):
    base = MLDA if cell_name.startswith("mlda") else LM
    over = {"config": dict(base["config"]), "mix": dict(base["mix"])}
    if cell_name.startswith("granite") and "batch" in cell_name:
        over["mix"]["n_requests"] = 64
    if limits:
        over["mix"]["limits"] = dict(TINY_LIMITS)
    return over


def context(cell_name: str, *, seed: int = 2**31 + 77, seconds: float = 1.5, trace: bool = False,
            limits: bool = True):
    from portbench.harness import cells
    from portbench.harness.context import Context

    cell = cells.resolve(cell_name)
    return Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device="cpu",
                   overrides=overrides(cell_name, limits))
