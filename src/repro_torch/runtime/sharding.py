"""Sharding policy for the batch pools: a data mesh over torch devices.

The port of the JAX package's ``runtime/sharding.py`` as far as the UQ
stack uses it.  :class:`ShardingPolicy` keeps the reference's pure
arithmetic (``dp_size``, ``tp_size``, ``shard_if``, ``batch_axes``), which
reads only ``mesh.shape`` and ``mesh.axis_names``.  The mesh is a
:class:`DataMesh`: an ordered tuple of ``torch.device``s on one
``("data",)`` axis, which :class:`repro_torch.balancer.ShardedBatchServer`
splits a coalesced batch over (a mesh may list one device twice; each
position is a shard of its own).

The tensor-parallel LM layout (``choose_policy``, ``param_spec``,
``activation_sharding``) is not ported yet (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import NOT_SHARDED
from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any  # DataMesh, or anything with .shape and .axis_names
    dp_axes: Tuple[str, ...]  # ("pod", "data") — or incl. "model" (pure DP)
    model_axis: Optional[str] = "model"  # None = pure DP / ZeRO-3 layout
    fsdp: bool = True  # shard big param dims over dp axes too
    seq_parallel: bool = False  # shard residual-stream seq dim on model axis

    @property
    def dp_size(self) -> int:
        size = 1
        for a in self.dp_axes:
            size *= self.mesh.shape[a]
        return size

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.model_axis] if self.model_axis else 1

    # -- divisibility-aware axis assignment ---------------------------------
    def shard_if(self, dim: int, axis) -> Optional[Any]:
        """Return axis (str or tuple) if ``dim`` divides evenly, else None."""
        if axis is None:
            return None
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        size = 1
        for a in axes:
            size *= self.mesh.shape[a]
        return axis if dim % size == 0 else None

    def batch_axes(self, batch: int) -> Optional[Tuple[str, ...]]:
        """Longest dp-axis prefix-with-suffix-drop that divides the batch."""
        axes = list(self.dp_axes)
        while axes:
            size = 1
            for a in axes:
                size *= self.mesh.shape[a]
            if batch % size == 0:
                return tuple(axes)
            axes.pop()  # drop the innermost axis and retry
        return None


def make_policy(
    mesh,
    *,
    fsdp: bool = True,
    seq_parallel: bool = False,
    pure_dp: bool = False,
) -> ShardingPolicy:
    base = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if pure_dp:
        return ShardingPolicy(
            mesh=mesh, dp_axes=base + ("model",), model_axis=None, fsdp=fsdp
        )
    return ShardingPolicy(mesh=mesh, dp_axes=base, fsdp=fsdp, seq_parallel=seq_parallel)


@dataclass(frozen=True)
class DataMesh:
    """A 1-D ``("data",)`` mesh: an ordered tuple of torch devices.

    Position ``i`` holds shard ``i`` of a batch.  The same device may
    appear at several positions (two shards on one card)."""

    devices: Tuple[torch.device, ...]

    axis_names = ("data",)

    def __init__(self, devices: Sequence[DeviceLike]) -> None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}


def data_mesh(n_devices: Optional[int] = None, *, device: DeviceLike = "cuda") -> DataMesh:
    """1-D ``("data",)`` mesh over the host's CUDA cards ``cuda:0..n-1``
    (default: all of them); raises when asked for more cards than exist,
    and without a card.  ``device="cpu"`` gives ``n_devices`` (default 1)
    entries of the CPU instead."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return DataMesh([dev] * (n_devices or 1))
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return DataMesh([torch.device("cuda", i) for i in range(n)])


def data_policy(mesh: Optional[DataMesh] = None) -> ShardingPolicy:
    """Pure-DP :class:`ShardingPolicy` for batch pools: every mesh axis is
    a data axis, no model axis.  ``batch_axes`` then gives the standard
    divisibility fallback (an indivisible batch stays unsharded)."""
    mesh = mesh if mesh is not None else data_mesh()
    return ShardingPolicy(
        mesh=mesh, dp_axes=tuple(mesh.axis_names), model_axis=None, fsdp=False
    )


def choose_policy(*_args, **_kwargs):
    raise NotImplementedError(f"sharding.choose_policy: {NOT_SHARDED}")


def param_spec(*_args, **_kwargs):
    raise NotImplementedError(f"sharding.param_spec: {NOT_SHARDED}")


def activation_sharding(*_args, **_kwargs):
    raise NotImplementedError(f"sharding.activation_sharding: {NOT_SHARDED}")
