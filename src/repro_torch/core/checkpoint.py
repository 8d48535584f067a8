"""Checkpoint/restart for UQ workflows (the paper's §7 future work,
implemented).  Captures sampler chains, proposal adaptation state, RNG state
and the balancer's pending queue, so a lengthy MLDA run survives node loss.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.balancer import LoadBalancer
from .mlda import MLDASampler


def _atomic_write(path: str, payload: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        os.replace(tmp, path)  # atomic on POSIX — crash-safe
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_sampler(
    path: str,
    sampler: MLDASampler,
    rng: np.random.Generator,
    *,
    theta: np.ndarray,
    step: int,
    balancer: Optional[LoadBalancer] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    state = {
        "step": int(step),
        "theta": np.asarray(theta).tolist(),
        "rng_state": rng.bit_generator.state,
        "proposal_state": sampler.proposal.state(),
        "subchain_lengths": sampler.subchain_lengths,
        "n_speculated": sampler.n_speculated,
        "n_spec_hits": sampler.n_spec_hits,
        "levels": [
            {
                "n_evals": rec.n_evals,
                "n_accepted": rec.n_accepted,
                "n_proposed": rec.n_proposed,
                "eval_seconds": rec.eval_seconds,
                "n_spec_discarded": rec.n_spec_discarded,
                "samples": [s.tolist() for s in rec.samples[-10000:]],
            }
            for rec in sampler.levels
        ],
        "pending_queue": balancer.checkpoint_queue() if balancer is not None else [],
        "extra": extra or {},
    }

    def _default(o):
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(f"unserialisable {type(o)}")

    _atomic_write(path, json.dumps(state, default=_default))


def load_sampler(path: str, sampler: MLDASampler) -> Dict[str, Any]:
    """Restore sampler bookkeeping + proposal + RNG; returns restart info.

    The caller resumes with ``sampler.sample(theta, remaining, rng)``.
    """
    with open(path) as f:
        state = json.load(f)
    sampler.proposal.restore(state["proposal_state"])
    sampler.n_speculated = state.get("n_speculated", 0)
    sampler.n_spec_hits = state.get("n_spec_hits", 0)
    for rec, saved in zip(sampler.levels, state["levels"]):
        rec.n_evals = saved["n_evals"]
        rec.n_accepted = saved["n_accepted"]
        rec.n_proposed = saved["n_proposed"]
        rec.eval_seconds = saved["eval_seconds"]
        rec.n_spec_discarded = saved.get("n_spec_discarded", 0)
        rec.samples = [np.asarray(s) for s in saved["samples"]]
    rng = np.random.default_rng()
    rng.bit_generator.state = state["rng_state"]
    return {
        "step": state["step"],
        "theta": np.asarray(state["theta"]),
        "rng": rng,
        "pending_queue": state["pending_queue"],
        "extra": state["extra"],
    }
