"""Faults planted in the program's timed path, which the check that decides
``correct`` has to catch: a step that returns its state unchanged, half of
a batch left out (answered with the mean of the rest), an answer or token
altered where it is produced.  ``plant(name)`` patches the program's module
in this process before a cell is set up; the tests pass pytest's
``monkeypatch.setattr`` so that the patch is undone after them.

    python3 portbench/tools/readings.py --workload mlda-paper --fault half_batch ...

reads a fault at a cell's own size on the card.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

MLDA = ("step_unchanged", "half_batch", "answer_altered")
SERVING = ("step_unchanged", "half_batch", "token_altered")


# -- MLDA: faults of the level pools ----------------------------------------------
def _stuck_step(state, b, dt, *, cfg, out=None, series=None, t=0, probes=None):
    """A fused step that returns its state unchanged."""
    new = state
    if out is not None:
        for dst, src in zip(out, state):
            dst.copy_(src)
        new = out
    if series is not None:
        series[:, t] = new.h[:, probes[0], probes[1]] + b[probes[0], probes[1]]
    return new


def _half_batch(on_host):
    """A pool handler that computes the first half of a batch and answers
    the rest with the mean of those rows."""

    def wrap(fn, device):
        call = on_host(fn, device)

        def half(thetas):
            thetas = np.asarray(thetas)
            k = (len(thetas) + 1) // 2
            out = call(thetas[:k])
            rest = np.repeat(out.mean(0, keepdims=True), len(thetas) - k, axis=0)
            return np.concatenate([out, rest.astype(out.dtype)])

        return half

    return wrap


def _altered(on_host):
    """A pool handler whose every answer has its first observable moved by
    two likelihood sigmas (0.08 m)."""

    def wrap(fn, device):
        call = on_host(fn, device)

        def altered(thetas):
            out = np.array(call(thetas))
            out[:, 0] += 0.08
            return out

        return altered

    return wrap


def plant_mlda(fault: str, patch: Callable = setattr) -> None:
    from repro_torch.kernels.swe_flux import ops
    from repro_torch.swe import servers

    if fault == "step_unchanged":
        patch(ops, "swe_step_batched", _stuck_step)
    elif fault == "half_batch":
        patch(servers, "_on_host", _half_batch(servers._on_host))
    elif fault == "answer_altered":
        patch(servers, "_on_host", _altered(servers._on_host))
    else:
        raise ValueError(f"no MLDA fault '{fault}' (have {MLDA})")


# -- serving: faults of the paged step ----------------------------------------------
def _pool_fault(patch, edit) -> None:
    from repro_torch.runtime import serve_loop

    make = serve_loop.make_paged_decode_pool

    def made(*a, **kw):
        pool = make(*a, **kw)
        step = pool.step_fn

        def faulty(state, tokens, active):
            state, ids = step(state, tokens, active)
            return state, edit(np.array(ids), np.asarray(active))

        pool.step_fn = faulty
        return pool

    patch(serve_loop, "make_paged_decode_pool", made)


def _token_altered():
    """Every fourth step, each live slot's token moved to the next id."""
    n = [0]

    def edit(ids, active):
        n[0] += 1
        if n[0] % 4 == 0:
            live = np.nonzero(active)[0]
            ids[live] = (ids[live] + 1) % 256
        return ids

    return edit


def _half_batch_ids(ids, active):
    live = np.nonzero(active)[0]
    half = live[len(live) // 2:]
    if len(live) > 1:
        ids[half] = ids[live[0]]
    return ids


def plant_serving(fault: str, patch: Callable = setattr) -> None:
    from repro_torch.runtime import serve_loop

    if fault == "step_unchanged":
        step = serve_loop.paged_decode_step

        def unchanged(params, cfg, state, tokens, active, cache_len):
            _, ids, logits = step(params, cfg, state, tokens, active, cache_len)
            return state, ids, logits  # positions never advance

        patch(serve_loop, "paged_decode_step", unchanged)
    elif fault == "half_batch":
        _pool_fault(patch, _half_batch_ids)
    elif fault == "token_altered":
        _pool_fault(patch, _token_altered())
    else:
        raise ValueError(f"no serving fault '{fault}' (have {SERVING})")


def plant(driver: str, fault: str, patch: Callable = setattr) -> None:
    """Plant ``fault`` under a cell whose mix names ``driver``."""
    (plant_mlda if driver == "mlda_rounds" else plant_serving)(fault, patch)
