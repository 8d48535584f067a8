"""Error-feedback int8 gradient compression for data-parallel reduction.

The reference's ``optim/grad_compression.py`` over a
:class:`~repro_torch.runtime.sharding.DataMesh`: each mesh position holds
one shard of the batch and a replica of the parameters.  Per gradient
leaf, every shard (1) adds the error buffer, (2) quantises to int8 with
a scale all shards share (the largest of their ``amax``), (3) the int8
payloads are summed in int32 across the shards (the compressed
collective) and (4) dequantised and divided by the shard count; the
residual becomes the next error buffer (Karimireddy et al., 2019).  There
is no ``shard_map`` and no collective library: the shards run one after
another on their own devices, and the payloads meet on the first
position's device.  A mesh may list one card twice.

As in the reference, the gradient function takes one error buffer for
every shard and returns the first shard's residual: the reference's
replicated out-spec returns mesh position 0's value.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

from .tree import divide, tree_leaves, tree_map, tree_unflatten, value_and_grad


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation -> (q int8, scale fp32 0-d)."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, divide(amax, 127.0), torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def ef_compress_leaf(gs: Sequence[torch.Tensor],
                     errs: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One error-feedback compressed reduction of a gradient leaf over the
    shards: ``gs[i]`` and ``errs[i]`` (fp32) on shard i's device ->
    (``g_hat`` on each shard's device, each shard's new error).

    All shards quantise with the same scale, or the int8 sum would mean
    nothing: the scale comes from the largest of the shards' ``amax``."""
    home = gs[0].device
    targets = [g.float() + e for g, e in zip(gs, errs)]
    amax = torch.stack([t.abs().max().to(home) for t in targets]).max()
    scale = torch.where(amax > 0, divide(amax, 127.0), torch.ones_like(amax))
    q_sum, new_errs = None, []
    for t in targets:
        s = scale.to(t.device)
        q = torch.clamp(torch.round(t / s), -127, 127).to(torch.int8)
        new_errs.append(t - q.float() * s)
        q32 = q.to(home).to(torch.int32)  # the int8 payload crosses, summed in int32
        q_sum = q32 if q_sum is None else q_sum + q32
    g_hat = (divide(q_sum.float() * scale, float(len(gs)))).to(gs[0].dtype)
    return [g_hat.to(g.device) for g in gs], new_errs


def _shard(batch, n: int, i: int):
    """Shard ``i`` of ``n`` of every leaf's leading axis."""

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not split over {n} shards")
        size = x.shape[0] // n
        return x[i * size : (i + 1) * size]

    return tree_map(take, batch)


def make_compressed_dp_grad_fn(loss_fn: Callable, mesh, axis_name: str = "data"):
    """``grad_fn(params, err, batch) -> (loss, g_hat, new_err)`` with the
    gradient reduced across ``mesh``'s positions in int8 with error
    feedback.

    ``loss_fn(params, batch) -> scalar``; ``params`` and ``err`` are
    replicated onto every position, ``batch``'s leaves split along their
    leading axis.  The loss is the mean of the shards' losses; ``g_hat``
    and ``new_err`` are trees on the first position's device."""
    if tuple(mesh.axis_names) != (axis_name,):
        raise ValueError(f"mesh axes {mesh.axis_names} are not ({axis_name!r},)")
    devices = mesh.devices

    def grad_fn(params, err, batch) -> Tuple[torch.Tensor, Any, Any]:
        n = len(devices)
        losses, grads = [], []
        for i, dev in enumerate(devices):
            on = lambda x, dev=dev: x.to(dev)  # noqa: E731
            loss, g = value_and_grad(loss_fn, tree_map(on, params),
                                     tree_map(on, _shard(batch, n, i)))
            losses.append(loss.to(devices[0]))
            grads.append(tree_leaves(g))
        errs = [tree_leaves(tree_map(lambda e, dev=dev: e.to(dev), err)) for dev in devices]
        g_hat, new_err = [], []
        for j in range(len(grads[0])):
            hats, residuals = ef_compress_leaf([g[j] for g in grads], [e[j] for e in errs])
            g_hat.append(hats[0])
            new_err.append(residuals[0])
        loss = divide(sum(losses), float(n))
        return loss, tree_unflatten(params, g_hat), tree_unflatten(err, new_err)

    return grad_fn


def init_error_buffers(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
