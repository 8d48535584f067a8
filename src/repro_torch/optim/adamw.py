"""AdamW with dtype-configurable state: the reference's arithmetic.

What ``torch.optim.AdamW`` does not have, and the reference does:

  * ``m_dtype`` / ``v_dtype``: bf16 moments;
  * ``master_dtype``: an optional fp32 master copy of bf16 params (without
    it a bf16 parameter takes the update rounded to bf16);
  * the global-norm clip in fp32, ``scale = min(1, clip / (norm + 1e-9))``;
  * the decay inside the lr product, ``p - lr (m_hat / (sqrt(v_hat) + eps)
    + wd p)``;
  * the linear-warmup cosine schedule with its 0.1 floor, in fp32 tensors.

Functional, as the reference: ``init(params) -> AdamWState`` and
``update(grads, state, params) -> (params, state, metrics)`` over the
port's parameter trees, new tensors out and the inputs untouched.  The
update runs as ``torch._foreach_*`` operations over every leaf at once, in
the reference's order of operations; over DTensor leaves (the sharded
train step) the same operations run on each rank's shards, and the global
norm is one reduction over the whole mesh (:func:`_sum_of_squares`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from .tree import divide, tree_leaves, tree_map, tree_unflatten

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, None: None}


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32: updates taken
    m: Any
    v: Any
    master: Optional[Any]  # fp32 master params (None = params are master)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    m_dtype: Optional[str] = None  # None = same as param
    v_dtype: Optional[str] = None
    master_dtype: Optional[str] = None  # e.g. "float32"
    # The reference's knob for scanning its stacked layers' update; off by
    # default there.  The port's layers are separate leaves already, so it
    # is carried for the configs' sake and reads nothing.
    scan_layers_min: int = 1_000_000


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to 0.1 ``lr`` at
    ``total_steps``; ``step`` an fp32 tensor."""
    warm = torch.clamp(divide(step, max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp(
        divide(step - cfg.warmup_steps, max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _fp32_copies(tensors):
    return [t.to(torch.float32, copy=True) for t in tensors]


def _sum_of_squares(squares) -> torch.Tensor:
    """The sum of every element of ``squares``, leaf after leaf.

    For DTensor leaves (a sharded train step), each rank sums the local
    shards it owns (a shard replicated over a mesh axis is owned by that
    axis' coordinate 0) in the same order, and one all-reduce over the
    whole mesh adds the ranks' sums.  So every rank clips by the same
    scale, bit for bit, where DTensor would reduce each leaf's partial sums
    axis by axis; on a one-rank mesh it is the plain sum."""
    from torch.distributed.tensor import DTensor

    if not squares or not isinstance(squares[0], DTensor):
        return sum(torch.sum(sq) for sq in squares)
    import torch.distributed._functional_collectives as funcol

    mesh = squares[0].device_mesh
    coord = mesh.get_coordinate()
    total = None
    for sq in squares:
        if any(p.is_replicate() and c != 0 for p, c in zip(sq.placements, coord)):
            continue
        term = torch.sum(sq.to_local())
        total = term if total is None else total + term
    if total is None:
        total = torch.zeros((), dtype=squares[0].dtype, device=squares[0].to_local().device)
    if mesh.size() == 1:
        return total
    return funcol.wait_tensor(funcol.all_reduce(total, "sum", _whole_mesh(mesh)))


def _whole_mesh(mesh):
    """``mesh`` as one dim (its process group spans every rank of it).
    Made outside any dispatch mode: the mesh's rank table is a tensor, and
    a fake one (a dry-run) cannot be indexed."""
    if mesh.ndim == 1:
        return mesh
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return mesh._flatten()


def make_adamw(cfg: AdamWConfig):
    m_dt, v_dt, master_dt = DTYPES[cfg.m_dtype], DTYPES[cfg.v_dtype], DTYPES[cfg.master_dtype]

    def init(params) -> AdamWState:
        m = tree_map(lambda p: torch.zeros_like(p, dtype=m_dt or p.dtype), params)
        v = tree_map(lambda p: torch.zeros_like(p, dtype=v_dt or p.dtype), params)
        master = (tree_map(lambda p: p.to(master_dt, copy=True), params)
                  if master_dt is not None else None)
        device = tree_leaves(params)[0].device
        step = torch.zeros((), dtype=torch.int32, device=device)
        return AdamWState(step=step, m=m, v=v, master=master)

    def update(grads, state: AdamWState, params):
        step = state.step + 1
        t = step.to(torch.float32)
        lr = lr_schedule(cfg, t)

        # Global-norm clip in fp32.
        g32 = _fp32_copies(tree_leaves(grads))
        gnorm = torch.sqrt(_sum_of_squares(torch._foreach_mul(g32, g32)))
        scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm) / (gnorm + 1e-9), max=1.0)
        torch._foreach_mul_(g32, scale)

        ms, vs = tree_leaves(state.m), tree_leaves(state.v)
        m32 = _fp32_copies(ms)
        torch._foreach_mul_(m32, cfg.b1)
        torch._foreach_add_(m32, torch._foreach_mul(g32, 1 - cfg.b1))
        v32 = _fp32_copies(vs)
        torch._foreach_mul_(v32, cfg.b2)
        gg = torch._foreach_mul(g32, 1 - cfg.b2)
        torch._foreach_mul_(gg, g32)
        torch._foreach_add_(v32, gg)
        del g32, gg

        upd = torch._foreach_div(m32, 1 - torch.pow(cfg.b1, t))  # m_hat
        denom = torch._foreach_div(v32, 1 - torch.pow(cfg.b2, t))  # v_hat
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        torch._foreach_div_(upd, denom)
        del denom
        base = state.master if state.master is not None else params
        p32 = _fp32_copies(tree_leaves(base))
        torch._foreach_add_(upd, torch._foreach_mul(p32, cfg.weight_decay))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(p32, upd)
        del upd

        new_m = tree_unflatten(state.m, [x.to(r.dtype) for x, r in zip(m32, ms)])
        new_v = tree_unflatten(state.v, [x.to(r.dtype) for x, r in zip(v32, vs)])
        new_master = None
        if state.master is not None:
            new_master = tree_unflatten(state.master, [
                x.to(r.dtype) for x, r in zip(p32, tree_leaves(state.master))])
        new_params = tree_unflatten(params, [
            x.to(r.dtype) for x, r in zip(p32, tree_leaves(params))])
        metrics = {"lr": lr, "grad_norm": gnorm}
        return new_params, AdamWState(step=step, m=new_m, v=new_v, master=new_master), metrics

    return init, update
