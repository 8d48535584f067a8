"""Sharding strategies that DTensor lacks for operations the port runs.

* ``aten.mm.dtype`` / ``aten.bmm.dtype``: the ``out_dtype`` overloads that
  :func:`repro_torch.models.layers.matmul_f32` calls on the card (bf16
  operands, fp32 result).  DTensor registers strategies for ``aten.mm`` and
  ``aten.bmm`` only, so the tied head and the decode reads would raise
  under a policy.  They get the plain products' strategies: either operand
  sharded on a free dim, or both on the contracted dim with a ``Partial``
  (summed) result.
* ``aten.searchsorted.Tensor``: the MoE dispatch ranks each sequence's
  (token, expert) pairs with it, row by row, so both inputs sharded on the
  same batch dim give that dim of the result.

:func:`register` installs them once, before the first sharded step runs;
importing this module registers nothing.
"""
from __future__ import annotations

_DONE = False


def _mm_strategies(a, b, out_dtype):
    from torch.distributed.tensor import Partial, Replicate, Shard

    r = Replicate()
    return [
        ([r], [r, r, None]),
        ([Shard(0)], [Shard(0), r, None]),
        ([Shard(1)], [r, Shard(1), None]),
        ([Partial()], [Shard(1), Shard(0), None]),
    ]


def _bmm_strategies(a, b, out_dtype):
    from torch.distributed.tensor import Partial, Replicate, Shard

    r = Replicate()
    return [
        ([r], [r, r, None]),
        ([Shard(0)], [Shard(0), Shard(0), None]),
        ([Shard(1)], [Shard(1), r, None]),
        ([Shard(2)], [r, Shard(2), None]),
        ([Partial()], [Shard(2), Shard(1), None]),
    ]


def _searchsorted_strategies(sorted_sequence, values, *, out_int32=False, right=False,
                             side=None, sorter=None):
    from torch.distributed.tensor import Replicate, Shard

    r = Replicate()
    extra = [None] if sorter is None else [r]
    out = [([r], [r, r, *extra])]
    for dim in range(len(values.shape) - 1):  # every dim but the searched one
        extra_d = [None] if sorter is None else [Shard(dim)]
        out.append(([Shard(dim)], [Shard(dim), Shard(dim), *extra_d]))
    return out


def register() -> None:
    """Register the strategies with DTensor (once a process)."""
    global _DONE
    if _DONE:
        return
    import torch
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten
    register_sharding(aten.mm.dtype)(_mm_strategies)
    register_sharding(aten.bmm.dtype)(_bmm_strategies)
    register_sharding(aten.searchsorted.Tensor)(_searchsorted_strategies)
    _DONE = True
