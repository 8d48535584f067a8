"""Sharding policy: logical rules + divisibility fallback, on a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`.

The reference's ``runtime/sharding.py``.  Mesh axes: ``("pod",) data,
model``.  ``pod``+``data`` are the DP/FSDP axes, ``model`` is TP/SP.  A
tensor dim is sharded on an axis only when divisible by that axis size, so
the 14/15/24-head archs on a 16-way model axis keep that dim replicated
and DTensor inserts the collectives.

A layout is a :class:`PartitionSpec` (a tuple of per-dim entries: None, a
mesh axis name, or a tuple of names, as JAX's), turned into DTensor
placements on a mesh by :func:`placements`.  A :class:`NamedSharding` pairs
the two.  The policy's ``mesh`` is a ``DeviceMesh`` with named dims, a
:class:`DataMesh` (the UQ stack's batch pools), or anything with ``.shape``
(a dict) and ``.axis_names``; :func:`mesh_shape` reads either.

The port keeps one parameter leaf per layer where the reference stacks
layers on a lead axis, so :func:`param_spec` runs the reference's rules on
the *stacked* shape ((L, ...), or (G, every, ...) for the hybrid's groups)
and drops the lead entries (:func:`layer_param_spec`).

Activation constraints are injected through a contextvar
(:func:`activation_sharding`) so model code stays mesh-agnostic: the
``maybe_constrain*`` hooks ``redistribute`` a DTensor to the policy's
layout and leave plain tensors, and everything outside a policy, as they
are.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# Specs, meshes and placements
# ---------------------------------------------------------------------------
class PartitionSpec(tuple):
    """Per-dim layout of a tensor: each entry None (replicated), a mesh axis
    name, or a tuple of axis names (the dim split over those axes, the
    first one major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names")


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in mesh order."""
    if _is_device_mesh(mesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a :class:`DataMesh` or a
    duck-typed mesh whose ``.shape`` is such a dict."""
    if _is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that the spec names at tensor dim ``d``, ``Replicate()`` on the
    rest.  A tensor dim split over several axes must name them in mesh
    order (the order DTensor splits in).  An axis of size 1 replicates:
    a split into one piece is the whole tensor, and DTensor refuses views
    that move a dim "sharded" that way (a one-card mesh would refuse the
    GQA head views)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    out: list = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are not in mesh order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} is used twice")
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t``, a full tensor on every rank, as a DTensor with ``sharding``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh, sharding.placements)


def _is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:  # the unsharded path: no import, no lookup
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``target``, and its gradient too: the
    backward first lays the incoming gradient out by ``target`` (summing
    any partial values), then hands it back in ``x``'s layout, as the
    transpose of JAX's ``with_sharding_constraint`` constrains the
    cotangent.  So the gradients that reach each block are whole, never
    partial sums that DTensor would scatter unevenly on its own."""

    @staticmethod
    def forward(ctx, x, mesh, target):
        ctx.mesh, ctx.target, ctx.source = mesh, target, tuple(x.placements)
        if tuple(x.placements) == target:
            return x.view_as(x)
        return x.redistribute(mesh, target)

    @staticmethod
    def backward(ctx, grad):
        g = grad.redistribute(ctx.mesh, ctx.target)
        if not any(p.is_partial() for p in ctx.source):
            g = g.redistribute(ctx.mesh, ctx.source)
        return g, None, None


def constrain(x, spec: Sequence, mesh):
    """Redistribute a DTensor ``x`` to ``spec`` on ``mesh`` (the reference's
    ``with_sharding_constraint``, its gradient constrained alike); a plain
    tensor is returned as it is."""
    if not _is_dtensor(x):
        return x
    target = placements(spec, mesh)
    if not x.requires_grad:
        return x if tuple(x.placements) == target else x.redistribute(mesh, target)
    return _Constrain.apply(x, mesh, target)


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any  # DeviceMesh, DataMesh, or anything mesh_shape() reads
    dp_axes: Tuple[str, ...]  # ("pod", "data") — or incl. "model" (pure DP)
    model_axis: Optional[str] = "model"  # None = pure DP / ZeRO-3 layout
    fsdp: bool = True  # shard big param dims over dp axes too
    seq_parallel: bool = False  # shard residual-stream seq dim on model axis

    def axis_size(self, axis) -> int:
        """Product of the sizes of ``axis`` (a name or a tuple of names)."""
        shape = mesh_shape(self.mesh)
        size = 1
        for a in _axes(axis):
            size *= shape[a]
        return size

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.model_axis) if self.model_axis else 1

    # -- divisibility-aware axis assignment ---------------------------------
    def shard_if(self, dim: int, axis) -> Optional[Any]:
        """Return axis (str or tuple) if ``dim`` divides evenly, else None."""
        if axis is None:
            return None
        return axis if dim % self.axis_size(axis) == 0 else None

    def batch_axes(self, batch: int) -> Optional[Tuple[str, ...]]:
        """Longest dp-axis prefix-with-suffix-drop that divides the batch."""
        axes = list(self.dp_axes)
        while axes:
            if batch % self.axis_size(tuple(axes)) == 0:
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
    base = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
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


def choose_policy(cfg, shape, mesh, *, seq_parallel: bool = False) -> ShardingPolicy:
    """Per-(arch, shape) layout selection, the reference's rule.

    * train, small model or TP-unfriendly head count -> pure DP (ZeRO-3):
      batch over every mesh axis, params FSDP-sharded over all axes; no
      redundant attention compute, no TP collectives.
    * otherwise -> TP on 'model' (heads/ffn/vocab with divisibility
      fallback; q-sequence context parallelism when heads don't divide)
      + DP/FSDP on 'pod'x'data'.  Decode always lands here.
    """
    sizes = mesh_shape(mesh)
    tp = sizes["model"]
    if cfg.ssm is not None and cfg.n_heads == 0:
        heads = cfg.ssm.n_heads(cfg.d_model)
    else:
        heads = cfg.n_heads
    heads_ok = heads % tp == 0
    # rough param count (embeddings + blocks) without tracing
    n_params = cfg.vocab * cfg.d_model
    per_layer = 4 * cfg.d_model * cfg.n_heads * cfg.hd if cfg.n_heads else 0
    if cfg.moe is not None:
        per_layer += 3 * cfg.d_model * cfg.moe.d_ff * cfg.moe.n_experts
    elif cfg.d_ff:
        per_layer += 3 * cfg.d_model * cfg.d_ff
    if cfg.ssm is not None:
        di = cfg.ssm.d_inner(cfg.d_model)
        per_layer += cfg.d_model * (2 * di + 2 * cfg.ssm.d_state) + di * cfg.d_model
    n_params += cfg.n_layers * per_layer
    big = n_params >= 8e9

    moe_tp_ok = cfg.moe is None or cfg.moe.n_experts % tp == 0
    mesh_size = 1
    for size in sizes.values():
        mesh_size *= size
    # Pure DP requires the global batch to cover the whole mesh.
    pure_dp_viable = shape.global_batch % mesh_size == 0
    if (
        shape.kind == "train"
        and pure_dp_viable
        and not (big and heads_ok and moe_tp_ok)
    ):
        return make_policy(mesh, pure_dp=True)
    return make_policy(mesh, seq_parallel=seq_parallel or (big and shape.kind == "train"))


# ---------------------------------------------------------------------------
# Parameter specs by path pattern
# ---------------------------------------------------------------------------
def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def param_spec(policy: ShardingPolicy, path, leaf) -> PartitionSpec:
    """PartitionSpec for one parameter leaf of the reference's layout.

    Shape convention: stacked layer dims lead; the last two dims are the
    matmul dims.  TP shards the 'feature' dim (heads*hd / d_ff / vocab /
    experts' hidden), FSDP shards the d_model dim.  ``path`` is a sequence
    of keys (strings, or objects with ``.key``)."""
    name = _path_str(path)
    shape = tuple(leaf.shape)
    m = policy.model_axis
    dp = policy.dp_axes if policy.fsdp else None
    nd = len(shape)

    if nd == 0:
        return P()
    # Biases / norms / small vectors / depthwise convs / routers: replicate.
    if nd == 1 or any(
        k in name
        for k in ("ln", "norm", "bias", "dt_bias", "A_log", "/D", "conv", "pos", "router")
    ):
        return P(*([None] * nd))

    if m is None:
        # Pure DP (ZeRO-3): shard the largest divisible dim over all axes.
        s: list = [None] * nd
        for idx in sorted(range(nd), key=lambda i: -shape[i]):
            if policy.shard_if(shape[idx], dp):
                s[idx] = dp
                break
        return P(*s)

    def spec_2d(d_in_idx: int, d_out_idx: int, out_axis, in_axis):
        s: list = [None] * nd
        s[d_out_idx] = policy.shard_if(shape[d_out_idx], out_axis)
        s[d_in_idx] = policy.shard_if(shape[d_in_idx], in_axis)
        return P(*s)

    if "embed" in name or "unembed" in name:
        # (V, d) or (d, V): shard vocab on model, d on dp.
        v_idx = int(shape[-2] < shape[-1]) - 2  # bigger dim is vocab
        d_idx = -1 if v_idx == -2 else -2
        s = [None] * nd
        s[nd + v_idx] = policy.shard_if(shape[v_idx], m)
        s[nd + d_idx] = policy.shard_if(shape[d_idx], dp)
        return P(*s)
    if re.search(r"w_down|out_proj|wo", name):
        # (.., ff/heads, d_model): contract dim on model, d_model on dp.
        return spec_2d(-2, -1, dp, m)
    # Default matmul weight (.., d_model, features): features on model, d on dp.
    return spec_2d(-2, -1, m, dp)


def reference_leaf(cfg, path, shape) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Where a leaf of the port's parameter tree sits in the reference's:
    ``path`` its keys in the port's tree (list positions as ints) ->
    (the reference's keys, the reference's stacked shape).  Layer ``i`` of
    ``blocks`` is row ``i`` of the reference's (L, ...) stack, or for the
    hybrid row (i // every, i % every) of its (G, every, ...) groups, or a
    row of ``blocks_tail``; ``enc_blocks`` / ``dec_blocks`` stack likewise.
    Other leaves map to themselves."""
    keys = [getattr(k, "key", getattr(k, "idx", k)) for k in path]
    shape = tuple(shape)
    if len(keys) < 2 or not isinstance(keys[1], int):
        return tuple(str(k) for k in keys), shape
    group, i, rest = str(keys[0]), keys[1], tuple(str(k) for k in keys[2:])
    if group == "blocks" and cfg.shared_attn_every:
        every = cfg.shared_attn_every
        n_groups = cfg.n_layers // every
        if i < n_groups * every:
            return (group, *rest), (n_groups, every, *shape)
        return ("blocks_tail", *rest), (cfg.n_layers - n_groups * every, *shape)
    n = {"enc_blocks": cfg.n_encoder_layers}.get(group, cfg.n_layers)
    return (group, *rest), (n, *shape)


def layer_param_spec(policy: ShardingPolicy, cfg, path, leaf) -> PartitionSpec:
    """:func:`param_spec` of a leaf of the port's parameter tree: the
    reference's spec of the stacked leaf with the stacked entries dropped.

    A stacked dim that the reference would shard (only where the layer
    count divides a data axis: small meshes, reduced configs) cannot be
    split over a per-layer leaf; that axis then replicates the leaf.  No
    leaf of any arch at full size on the production meshes has one."""
    ref_path, ref_shape = reference_leaf(cfg, path, leaf.shape)
    spec = param_spec(policy, ref_path, _Shape(ref_shape))
    return P(*spec[len(ref_shape) - len(leaf.shape):])


class _Shape:
    def __init__(self, shape) -> None:
        self.shape = tuple(shape)


def _map_with_path(fn, tree, path=()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, (*path, f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, (*path, i)) for i, v in enumerate(tree))
    return fn(path, tree)


def params_shardings(policy: ShardingPolicy, params_tree, cfg):
    return _map_with_path(
        lambda path, leaf: NamedSharding(policy.mesh, layer_param_spec(policy, cfg, path, leaf)),
        params_tree,
    )


# ---------------------------------------------------------------------------
# Batch / state specs
# ---------------------------------------------------------------------------
def batch_spec(policy: ShardingPolicy, leaf, *, microbatched: bool) -> PartitionSpec:
    nd = len(leaf.shape)
    b_dim = 1 if microbatched else 0
    dp = policy.batch_axes(leaf.shape[b_dim])
    lead = [None, dp] if microbatched else [dp]
    rest = [None] * (nd - len(lead))
    return P(*lead, *rest)


def batch_shardings(policy: ShardingPolicy, batch_tree, *, microbatched: bool = False):
    return _map_with_path(
        lambda _, leaf: NamedSharding(policy.mesh,
                                      batch_spec(policy, leaf, microbatched=microbatched)),
        batch_tree,
    )


def decode_state_spec(policy: ShardingPolicy, path, leaf) -> PartitionSpec:
    """KV caches (L,B,H,W,hd), ssm states (L,B,H,P,N): B on dp, H on model."""
    shape = leaf.shape
    nd = len(shape)
    if nd >= 4:
        s = [None] * nd
        s[1] = policy.batch_axes(shape[1])
        if policy.model_axis is not None:
            s[2] = policy.shard_if(shape[2], policy.model_axis)
            if s[2] is None and nd >= 5:
                # kv heads don't divide the model axis: shard the cache's
                # SEQUENCE dim instead.
                s[3] = policy.shard_if(shape[3], policy.model_axis)
        return P(*s)
    return P(*([None] * nd))


def decode_state_shardings(policy: ShardingPolicy, state_tree):
    return _map_with_path(
        lambda path, leaf: NamedSharding(policy.mesh, decode_state_spec(policy, path, leaf)),
        state_tree,
    )


def place_tree(tree, shardings):
    """``tree`` with every plain leaf distributed by the sharding at its
    place in ``shardings`` (a tree of the same structure); a leaf that is a
    DTensor already is kept as it is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.optim.tree import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [t if isinstance(t, DTensor) else distribute(t, s)
                                 for t, s in zip(tree_leaves(tree), tree_leaves(shardings))])


@contextlib.contextmanager
def sharded_region():
    """Where a sharded step runs: DTensor's strategies for the operations it
    lacks registered (:mod:`~repro_torch.runtime.dtensor_ops`), and plain
    tensors that meet DTensors (positions, masks, constants the model
    makes) taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    from . import dtensor_ops

    dtensor_ops.register()
    with implicit_replication():
        yield


# ---------------------------------------------------------------------------
# Activation constraint injection
#
# The train/serve factories install the policy in a contextvar; model code
# calls the maybe_* hooks, which pin batch -> dp, heads -> model (when
# divisible), and seq -> model under sequence parallelism.  No-ops outside
# a policy context and on plain tensors.
# ---------------------------------------------------------------------------
_POLICY: contextvars.ContextVar = contextvars.ContextVar("act_policy", default=None)
# Layout changes the port makes where DTensor's own view rules would not
# (the dry-run reports them): "whole_heads" counts head views whose
# feature shards were not whole heads.
LAYOUT_EVENTS: Counter = Counter()


@contextlib.contextmanager
def activation_sharding(policy: Optional[ShardingPolicy]):
    token = _POLICY.set(policy)
    try:
        yield
    finally:
        _POLICY.reset(token)


def _active(x) -> Optional[ShardingPolicy]:
    policy = _POLICY.get()
    return policy if policy is not None and _is_dtensor(x) else None


def maybe_reduce(x):
    """A DTensor that holds partial values (a gather or a sum over a
    sharded dim) reduced to a replicated one; a plain tensor as it is.
    Only the values in ``x`` travel: the cross entropy's gold logits
    (B, S, 1) rather than the vocab-sharded logits they come from."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def maybe_whole_heads(x, n_heads: int):
    """Projected features (B, S, n_heads * hd) about to be viewed as heads:
    a DTensor whose feature dim is split into shards that are not whole
    heads (qwen2's 896 = 14 x 64 features on a 16-way axis) is replicated
    on that dim first, explicitly, rather than left to the view's rules.
    Plain tensors, and shards of whole heads, pass as they are."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    sizes = x.device_mesh.shape
    split = 1
    target = list(x.placements)
    for i, p in enumerate(x.placements):
        if p.is_shard(x.ndim - 1):
            split *= sizes[i]
    if split == 1 or n_heads % split == 0:
        return x
    target = [Replicate() if p.is_shard(x.ndim - 1) else p for p in target]
    LAYOUT_EVENTS["whole_heads"] += 1
    return x.redistribute(x.device_mesh, target)


def rowwise(fn, *args, batched: Sequence[bool]):
    """``fn(*args)`` for a function whose rows are independent (a recurrence
    over each sequence of a batch).  With DTensor arguments it runs through
    ``local_map`` on each rank's rows, split as the first ``batched``
    argument's batch dim (dim 0) is; DTensor's own rules would instead
    follow the function's reshapes and transposes operation by operation,
    through layouts its backward cannot take.  Each tensor argument that is
    not ``batched`` (a parameter) enters expanded along a batch dim and is
    read at row 0 of each rank's rows, so its gradient is the sum over
    every rank's rows, as it must be."""
    first = next((a for a, b in zip(args, batched) if b and _is_dtensor(a)), None)
    if first is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = first.device_mesh
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in first.placements]
    n = first.shape[0]
    shared = [isinstance(a, torch.Tensor) and not b for a, b in zip(args, batched)]
    ins = []
    for a, s_ in zip(args, shared):
        if isinstance(a, torch.Tensor) and not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        ins.append(a.expand(n, *a.shape) if s_ else a)

    def local(*xs):
        return fn(*(x[0] if s_ else x for x, s_ in zip(xs, shared)))

    in_pl = tuple(rows if isinstance(a, torch.Tensor) else None for a in ins)
    return local_map(local, out_placements=rows, in_placements=in_pl, redistribute_inputs=True,
                     device_mesh=mesh)(*ins)


def _shard_range(size: int, mesh, placements, dim: int) -> Tuple[int, int]:
    """``(start, length)`` of this rank's part of tensor dim ``dim`` (of
    ``size``) under ``placements`` on ``mesh``: the mesh dims that shard it
    split it in mesh order, each into ``torch.chunk``'s pieces (in plain
    integers; a fake mesh's rank table cannot be read)."""
    coord = mesh.get_coordinate()
    start = 0
    for n, c, p in zip(mesh.shape, coord, placements):
        if p.is_shard(dim):
            piece = -(-size // n)
            start += min(c * piece, size)
            size = max(0, min(piece, size - c * piece))
    return start, size


def local_part(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's part of the whole tensor ``x`` laid out by
    ``placements`` on ``mesh``, as ``distribute_tensor`` would give it (a
    view of ``x``; every rank passes the same ``x``)."""
    for dim in range(x.ndim):
        start, n = _shard_range(x.shape[dim], mesh, placements, dim)
        if n != x.shape[dim]:
            x = x.narrow(dim, start, n)
    return x


def local_attention(fn, q, k, v):
    """``fn(q, k, v, q_start=...)``, a plain attention over (B, H, S, D)
    tensors (K/V with q's heads); DTensors on each rank's shards through
    ``local_map``: q as it is laid out (batch, heads or, for context
    parallelism, query rows split; ``q_start`` is where this rank's rows
    start, for the causal mask), K and V split like q's batch and heads and
    whole along the sequence.  Their gradients from a rank's query rows are
    partial sums over the rows' split.  DTensor's own rules would flatten
    a batch split and a head split into one dim of the 4-D products, a
    layout its products cannot take."""
    if not _is_dtensor(q):
        return fn(q, k, v, q_start=0)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh

    def keep(p):
        for d in (0, 1, 2):
            if p.is_shard(d):
                return Shard(d)
        return Replicate()

    q_pl = [keep(p) for p in q.placements]
    kv_pl = [Replicate() if p.is_shard(2) else p for p in q_pl]
    kv_grad = [Partial() if p.is_shard(2) else p for p in q_pl]
    start = _shard_range(q.shape[2], mesh, q_pl, 2)[0]

    def local(ql, kl, vl):
        return fn(ql, kl, vl, q_start=start)

    return local_map(local, out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad), redistribute_inputs=True,
                     device_mesh=mesh)(q, k, v)


def local_heads(fn, q, k, v, valid):
    """``fn(q, k, v, valid)``, a decode read of q (B, H, C, hd) against a
    cache view (B, Hkv, W, hd) under ``valid`` (B, C, W) -> (B, C, H * hd),
    on each rank's rows and KV heads through ``local_map`` where the view
    is split by batch or heads only (q's heads follow their KV head's
    split; whole GQA groups, as H = G * Hkv).  A view whose W is split
    (KV heads that do not divide the model axis) goes through DTensor's
    rules: its softmax needs every position.  DTensor's own rules would
    flatten a batch split and a head split into one dim, a layout its
    products cannot take."""
    if not _is_dtensor(k) or any(p.is_shard(2) or p.is_shard(3) for p in k.placements):
        return fn(q, k, v, valid)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = k.device_mesh
    if not isinstance(valid, DTensor):
        valid = DTensor.from_local(valid, mesh, [Replicate()] * mesh.ndim, run_check=False)
    kv_pl = [Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(1) else Replicate()
             for p in k.placements]
    valid_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in kv_pl]
    out_pl = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(1) else Replicate()
              for p in kv_pl]
    return local_map(fn, out_placements=out_pl, in_placements=(kv_pl, kv_pl, kv_pl, valid_pl),
                     redistribute_inputs=True, device_mesh=mesh)(q, k, v, valid)


def lookup(table, ids):
    """``table[ids]``, an embedding lookup.  A replicated DTensor table (a
    block's gathered embedding) is read on each rank at its own ids
    through ``local_map``: the rows come out split as the ids are, and the
    table's gradient is a partial sum over the ids' split.  DTensor's own
    rule for the lookup takes one split of the ids' batch dim, not a batch
    split over two mesh dims (the pure-DP layout).  A table split over the
    vocabulary, and plain tensors, go as they are."""
    if not _is_dtensor(table) or not _is_dtensor(ids) or not all(
            p.is_replicate() for p in table.placements):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    whole = [Replicate()] * table.device_mesh.ndim
    ids_pl = list(ids.placements)
    grad_pl = [Partial() if p.is_shard() else Replicate() for p in ids_pl]
    return local_map(lambda t, i: t[i], out_placements=ids_pl, in_placements=(whole, ids_pl),
                     in_grad_placements=(grad_pl, ids_pl), redistribute_inputs=False,
                     device_mesh=table.device_mesh)(table, ids)


def write_cache_slot(cache, slot, value, rows=None) -> None:
    """``cache[b, :, slot[b]] = value[b]`` for every row b, in place: cache
    (B, Hkv, W, hd), slot (B,), value (B, Hkv, hd); or, for a (B, W) cache
    (the positions' ``pos_buf``), ``cache[b, slot[b]] = value[b]``.
    ``rows`` is ``arange(B)`` on the cache's device, if the caller has it.

    A DTensor cache is written shard by shard: the value and the slots are
    laid out like the cache's rows and heads, and each rank writes the
    rows whose slot falls inside its part of W (the cache's W is sharded
    on the model axis where the KV heads do not divide it).  Nothing moves
    but the new entries."""
    if not _is_dtensor(cache):
        if rows is None:
            rows = torch.arange(cache.shape[0], device=cache.device)
        if cache.ndim == 2:
            cache[rows, slot] = value
        else:
            cache[rows, :, slot] = value
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = cache.device_mesh
    row_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in cache.placements]
    val_pl = [p if (p.is_shard(0) or p.is_shard(1)) else Replicate() for p in cache.placements]
    if not isinstance(slot, DTensor):
        slot = DTensor.from_local(slot, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim, run_check=False)
    ls = slot.redistribute(mesh, row_pl).to_local()
    lv = value.redistribute(mesh, val_pl).to_local()
    lk = cache.to_local()
    rows = torch.arange(lk.shape[0], device=lk.device)
    if cache.ndim == 2:
        if any(p.is_shard(1) for p in cache.placements):
            raise ValueError("write_cache_slot: a (B, W) cache with W split")
        lk[rows, ls] = lv
        return
    if not any(p.is_shard(2) for p in cache.placements):
        lk[rows, :, ls] = lv
        return
    start = _shard_range(cache.shape[2], mesh, cache.placements, 2)[0]
    w_local = lk.shape[2]
    inside = (ls >= start) & (ls < start + w_local)
    li = torch.clamp(ls - start, 0, max(w_local - 1, 0))
    if w_local:
        lk[rows, :, li] = torch.where(inside[:, None, None], lv, lk[rows, :, li])


def gather_params(tree):
    """A block's parameters gathered for its compute (FSDP): under a
    policy, each DTensor leaf replicated over the data axes that its
    d_model dim is split on, its model-axis split kept.  Called inside a
    block (and so inside its recomputation under remat), the gathered
    copy lives for the block only, and the backward of the gather reduces
    each gradient back onto the shards.  Left to itself, DTensor would
    rather contract over the split dim and move activations.  A tree of
    plain tensors, or no policy, passes as it is."""
    policy = _POLICY.get()
    if policy is None:
        return tree
    from torch.distributed.tensor import Replicate

    from repro_torch.optim.tree import tree_leaves, tree_unflatten

    leaves = tree_leaves(tree)
    if not leaves or not _is_dtensor(leaves[0]):
        return tree
    names = axis_names(policy.mesh)
    dp = {names.index(a) for a in policy.dp_axes}

    def gather(t):
        if not _is_dtensor(t):
            return t
        target = [Replicate() if i in dp else p for i, p in enumerate(t.placements)]
        return t if list(t.placements) == target else t.redistribute(t.device_mesh, target)

    return tree_unflatten(tree, [gather(t) for t in leaves])


def maybe_constrain(x):
    """Residual stream (B, S, d): batch->dp, seq->model iff seq_parallel."""
    policy = _active(x)
    if policy is None or x.ndim != 3 or x.shape[1] == 1:
        return x
    seq_axis = policy.model_axis if (
        policy.model_axis is not None
        and policy.seq_parallel
        and x.shape[1] % policy.tp_size == 0
    ) else None
    return constrain(x, P(policy.batch_axes(x.shape[0]), seq_axis, None), policy.mesh)


def maybe_constrain_heads(x, role: str = "q"):
    """(B, H, S, D) q/k/v: batch->dp, heads->model when divisible.

    When the head count does NOT divide the model axis (qwen2 14H, smollm
    15H, phi4 24H, whisper 20H on a 16-way axis), context parallelism: the
    query SEQUENCE dim on the model axis (q rows are independent in online
    softmax; K/V stay replicated so no collectives enter the inner loop)."""
    policy = _active(x)
    if policy is None or x.ndim != 4:
        return x
    b_axes = policy.batch_axes(x.shape[0])
    if policy.model_axis is None:
        return constrain(x, P(b_axes, None, None, None), policy.mesh)
    h_axis = policy.shard_if(x.shape[1], policy.model_axis)
    s_axis = None
    if h_axis is None and role == "q" and x.shape[2] > 1:
        s_axis = policy.shard_if(x.shape[2], policy.model_axis)
    return constrain(x, P(b_axes, h_axis, s_axis, None), policy.mesh)


def maybe_constrain_moe(x):
    """Dispatched MoE tensors (B, E, C, d): batch->dp; experts->model when
    divisible (EP), else replicated over model."""
    policy = _active(x)
    if policy is None or x.ndim != 4:
        return x
    b_axes = policy.batch_axes(x.shape[0])
    e_axis = policy.shard_if(x.shape[1], policy.model_axis) if policy.model_axis else None
    return constrain(x, P(b_axes, e_axis, None, None), policy.mesh)


def maybe_constrain_ffn(h):
    """The MLP hidden (B, S, ff): ff->model (the reference's
    ``layers._constrain_ffn``)."""
    policy = _active(h)
    if policy is None or h.ndim != 3 or policy.model_axis is None:
        return h
    f_axis = policy.shard_if(h.shape[-1], policy.model_axis)
    return constrain(h, P(policy.batch_axes(h.shape[0]), None, f_axis), policy.mesh)


def maybe_constrain_logits(x):
    """(B, S, V) logits: batch->dp, vocab->model when divisible."""
    policy = _active(x)
    if policy is None or x.ndim != 3:
        return x
    v_axis = (
        policy.shard_if(x.shape[-1], policy.model_axis) if policy.model_axis else None
    )
    return constrain(x, P(policy.batch_axes(x.shape[0]), None, v_axis), policy.mesh)
