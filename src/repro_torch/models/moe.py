"""Mixture-of-Experts FFN: capacity-based sparse dispatch (default) and the
dense all-experts oracle.

The reference's ``models/moe.py`` for one card.  Routing is per sequence,
as the reference ``vmap``s it over the batch: a row's drops never depend on
its neighbours.  Where that capacity cannot drop a pair (a token takes an
expert at most once, so a capacity of at least the sequence's length keeps
every pair), the whole batch is routed as one group instead, at a capacity
of its token count: the same pairs, weights and sums, over far fewer expert
rows (a decode step of 32 one-token sequences: 32 rows an expert, not
32 x 8).  A pair (token, expert) is ranked within its expert's group
by a stable sort of the expert ids; the first ``cap`` pairs of each expert
fill its ``cap`` rows, the rest are dropped.  Where the reference
scatter-adds dropped pairs as zeros into slot 0, dropped pairs here go to a
scratch row at ``E * cap`` that is sliced off, and the combine sums each
token's k contributions in one fixed order with no atomics, so a call is
deterministic and a CUDA graph of it equals the eager call bit for bit.
Nothing here has a dynamic shape or reads a value on the host, so a decode
step or chunk through it can be captured.  The training path adds the
Switch-style load-balancing loss (:func:`aux_load_balance_loss`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.kernels import build
from repro_torch.runtime.sharding import _is_dtensor, maybe_constrain_moe

from .layers import Params, dense_init, normal_init


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    """The router in fp32 whatever ``dtype`` (as the reference), the experts'
    SwiGLU weights (E, d, f), (E, d, f), (E, f, d) in ``dtype``."""
    moe = cfg.moe
    e, d, f = moe.n_experts, cfg.d_model, moe.d_ff
    return {
        "router": dense_init(gen, d, e, torch.float32, device),
        "w_gate": normal_init(gen, (e, d, f), d**-0.5, dtype, device),
        "w_up": normal_init(gen, (e, d, f), d**-0.5, dtype, device),
        "w_down": normal_init(gen, (e, f, d), f**-0.5, dtype, device),
    }


def _router_topk(params: Params, x2: torch.Tensor, moe: MoEConfig):
    """x2 (..., d) -> (weights (..., k) fp32, experts (..., k)): a softmax
    over the top-k router logits (Mixtral-style renormalisation)."""
    logits = x2.float() @ params["router"]
    top_vals, top_idx = torch.topk(logits, moe.top_k, dim=-1)
    return torch.softmax(top_vals, dim=-1), top_idx


def _round8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def _capacity(moe: MoEConfig, n: int) -> int:
    """Rows an expert takes from one sequence of ``n`` tokens: 1.25 n k / E
    rounded up to a multiple of 8, at least 8 (so a decode step, n = 1,
    never drops)."""
    return _round8(int(moe.capacity_factor * n * moe.top_k / moe.n_experts))


def _groups(x: torch.Tensor, moe: MoEConfig):
    """The routing groups of x (B, S, d) and their capacity -> (x as (G, N,
    d), cap).  Each sequence is a group of its own at ``_capacity``, unless
    that capacity is at least S (no pair can drop) and there is more than
    one sequence of plain tensors: then the batch is one group of B * S
    tokens at capacity B * S rounded up to 8, which no expert can overflow
    either.  A sharded batch keeps its groups (its dispatch is constrained
    per sequence)."""
    b, s, d = x.shape
    cap = _capacity(moe, s)
    if b == 1 or cap < s or _is_dtensor(x):
        return x, cap
    return x.reshape(1, b * s, d), _round8(b * s)


def _dispatch(params: Params, x: torch.Tensor, moe: MoEConfig, cap: int):
    """Route each sequence of ``x`` (B, S, d) on its own -> (xs (B, E * cap,
    d) the expert rows, info, dropped (B,) pairs past capacity).

    ``info`` is (slot, weight) in the pairs' own order (token-major, top-k
    rank minor), each (B, S * k): the row of ``xs`` the pair went to
    (``E * cap``, the scratch row, if dropped) and its router weight in
    ``x``'s dtype (0 if dropped)."""
    b, s, d = x.shape
    k, e = moe.top_k, moe.n_experts
    nk = s * k
    weights, experts = _router_topk(params, x, moe)  # (B, S, k)
    flat_expert = experts.reshape(b, nk)
    # A stable sort groups the pairs by expert id; a pair's rank in its
    # group is its sorted index less the group's start.
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    se = torch.gather(flat_expert, 1, order).contiguous()
    start = torch.searchsorted(se, se, side="left")
    rank = torch.arange(nk, device=x.device) - start
    keep = rank < cap
    slot_sorted = torch.where(keep, se * cap + rank, e * cap)
    # Back to the pairs' own order: the sort's inverse permutation.
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    kept = torch.empty_like(keep).scatter_(1, order, keep)
    weight = (weights.reshape(b, nk) * kept).to(x.dtype)
    # Live slots are unique; dropped pairs all land on the scratch row,
    # whatever wins there is sliced off.
    src = x[:, :, None].expand(b, s, k, d).reshape(b, nk, d)  # pair p is token p // k
    xs = x.new_zeros((b, e * cap + 1, d)).scatter_(1, slot[..., None].expand(b, nk, d), src)
    return xs[:, : e * cap], (slot, weight), (~keep).sum(-1)


def _combine(ys: torch.Tensor, info, s: int, k: int) -> torch.Tensor:
    """ys (B, E * cap, d) -> (B, S, d): each token's k contributions, each its
    expert row times its weight, summed in top-k rank order (rank 0 first,
    one add after another).  A dropped pair reads a zero row with weight
    0."""
    slot, weight = info
    b, _, d = ys.shape
    ys = torch.cat([ys, ys.new_zeros((b, 1, d))], dim=1)  # the scratch row reads 0
    contrib = torch.gather(ys, 1, slot[..., None].expand(b, s * k, d)) * weight[..., None]
    contrib = contrib.reshape(b, s, k, d)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    return out


def moe_ffn_sparse(params: Params, x: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) with per-sequence capacity dropping, routed
    in the groups of :func:`_groups`: the experts run as grouped matmuls
    over (E, G * cap, d).

    Tallies (``kernels.build.tally``: counters that graph replays add their
    captured tally to, kept out of the launch counts): ``moe_dispatch
    pooled`` / ``moe_dispatch per_sequence``, the calls on each route;
    ``moe_rows computed`` and ``moe_pairs routed``, the expert rows and the
    (token, expert) pairs of each call."""
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    xg, cap = _groups(x, moe)
    g, n = xg.shape[:2]
    build.tally("moe_dispatch per_sequence" if g == b else "moe_dispatch pooled").add()
    build.tally("moe_rows computed").add(e * g * cap)
    build.tally("moe_pairs routed").add(b * s * k)
    xs, info, _ = _dispatch(params, xg, moe, cap)
    xs4 = maybe_constrain_moe(xs.reshape(g, e, cap, d))
    xe = xs4.transpose(0, 1).reshape(e, g * cap, d)
    h = F.silu(torch.bmm(xe, params["w_gate"])) * torch.bmm(xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"])  # (E, G * cap, d)
    ys = maybe_constrain_moe(ye.reshape(e, g, cap, d).transpose(0, 1)).reshape(g, e * cap, d)
    return _combine(ys, info, n, k).reshape(b, s, d)


def moe_ffn_dense(params: Params, x: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
    """Every expert for every token, router-weighted (the oracle: no
    capacity drops)."""
    b, s, d = x.shape
    n = b * s
    x2 = x.reshape(n, d)
    weights, experts = _router_topk(params, x2, moe)  # (N, k)
    dense_w = torch.zeros((n, moe.n_experts), dtype=torch.float32, device=x.device)
    dense_w.scatter_(1, experts, weights)
    g = torch.einsum("nd,edf->nef", x2, params["w_gate"])
    u = torch.einsum("nd,edf->nef", x2, params["w_up"])
    y = torch.einsum("nef,efd->ned", F.silu(g) * u, params["w_down"])
    out = torch.einsum("ned,ne->nd", y.float(), dense_w)
    return out.to(x.dtype).reshape(b, s, d)


def moe_ffn(params: Params, x: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
    if moe.impl == "dense":
        return moe_ffn_dense(params, x, moe)
    return moe_ffn_sparse(params, x, moe)


def aux_load_balance_loss(params: Params, x: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
    """Switch-style load-balancing loss of the router on x (B, S, d):
    ``E * sum_e frac_e * mean_prob_e``, where ``frac_e`` is expert e's share
    of the top-k picks (no gradient) and ``mean_prob_e`` its mean softmax
    probability over every expert."""
    x2 = x.reshape(-1, x.shape[-1])
    logits = x2.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    _, top_idx = torch.topk(logits, moe.top_k, dim=-1)
    # Counted by comparison with every expert id (not ``bincount``, whose
    # output shape depends on the values: DTensor and fake tensors cannot
    # propagate it).  The counts are exact integers either way.
    ids = torch.arange(moe.n_experts, device=top_idx.device)
    counts = (top_idx.reshape(-1, 1) == ids).sum(0).float()
    frac = counts / counts.sum()
    return moe.n_experts * torch.sum(frac * probs.mean(0))
