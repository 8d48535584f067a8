"""Train-step factory: the loss and gradients by autograd, AdamW, and
microbatched gradient accumulation; remat lives in the model
(``ArchConfig.remat``).

The reference's ``runtime/train_loop.py`` for one card.  Training takes the
reference's training attention, the plain blocked online-softmax loop
(``attn_impl="chunked"``), whatever attention a config serves with: the
flash kernel has no backward (nor had the Pallas kernel it replaces) and
refuses autograd.

:class:`GraphTrainStep` is the port's ``jax.jit(train_step,
donate_argnums=(0, 1))``: the whole step captured as one CUDA graph that
updates the parameter and optimizer leaves in place.

:func:`shard_train_step` runs the same step over DTensors on a
``DeviceMesh``: parameters, AdamW state and batch laid out by the policy's
specs, activations constrained by the model's hooks, and the parameter and
optimizer leaves updated in place (the reference donates them).
:class:`GraphShardedStep` replays such a step as one CUDA graph over the
placed, donated state (:func:`graph_train_step`; the prefill and decode
steps in ``serve_loop``), the port's pjit'd per-cell entry points: DTensor
dispatches only while the graph is captured.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import StaticGraph
from repro_torch.models import abstract_inputs, abstract_params, build_model
from repro_torch.optim.adamw import DTYPES, AdamWConfig, AdamWState, make_adamw
from repro_torch.optim.tree import (
    divide,
    tree_leaves,
    tree_map,
    tree_unflatten,
    value_and_grad,
)

from .sharding import (
    NamedSharding,
    P,
    ShardingPolicy,
    activation_sharding,
    batch_shardings,
    local_part,
    params_shardings,
    place_tree,
    sharded_region,
)

# The attention every training step takes (the reference's default).
TRAIN_ATTN_IMPL = "chunked"


@dataclass(frozen=True)
class TrainRuntime:
    """Per-arch runtime knobs (memory-fit strategy)."""

    microbatches: int = 1
    grad_dtype: Optional[str] = None  # accumulation dtype (None = param dtype)
    adamw: AdamWConfig = AdamWConfig()


# The reference's per-arch overrides.
TRAIN_RUNTIMES: Dict[str, TrainRuntime] = {
    "nemotron-4-340b": TrainRuntime(
        microbatches=4,
        grad_dtype="bfloat16",
        adamw=AdamWConfig(m_dtype="bfloat16", v_dtype="bfloat16", master_dtype=None),
    ),
    "mixtral-8x22b": TrainRuntime(
        microbatches=4,
        grad_dtype="bfloat16",
        adamw=AdamWConfig(m_dtype="bfloat16", v_dtype="bfloat16", master_dtype=None),
    ),
    "llava-next-mistral-7b": TrainRuntime(
        microbatches=2, adamw=AdamWConfig(master_dtype="float32")
    ),
    "whisper-large-v3": TrainRuntime(adamw=AdamWConfig(master_dtype="float32")),
}


def get_runtime(arch_id: str) -> TrainRuntime:
    return TRAIN_RUNTIMES.get(arch_id, TrainRuntime())


def training_config(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` with the attention training takes."""
    return replace(cfg, attn_impl=TRAIN_ATTN_IMPL)


def make_grad_fn(cfg: ArchConfig, rt: TrainRuntime):
    """-> ``grad_fn(params, batch) -> (loss, grads)``, the loss and gradients
    of one train step by autograd.  With ``rt.microbatches = k > 1`` the
    batch's leaves are (k, B/k, ...): the gradients accumulate ``g / k`` in
    ``rt.grad_dtype`` and the loss ``loss / k``, one microbatch after
    another."""
    loss_fn = build_model(training_config(cfg)).loss
    k = rt.microbatches
    gdt = DTYPES[rt.grad_dtype]

    def grad_fn(params, batch):
        if k == 1:
            return value_and_grad(loss_fn, params, batch)
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=gdt or p.dtype), params)
        loss = None
        for i in range(k):
            mb_loss, g = value_and_grad(loss_fn, params, {name: x[i] for name, x in batch.items()})
            grads = tree_map(lambda a, b: a + divide(b.to(a.dtype), k), grads, g)
            term = divide(mb_loss, k)
            loss = term if loss is None else loss + term
        return loss, grads

    return grad_fn


def make_train_fns(cfg: ArchConfig, rt: TrainRuntime):
    """-> ``(init_fn, train_step)``.

    ``init_fn(generator, device="cuda") -> (params, opt_state)``;
    ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    :func:`make_grad_fn`'s loss and gradients, then AdamW; ``metrics``
    holds the 0-d tensors ``loss``, ``lr`` and ``grad_norm``."""
    init = build_model(training_config(cfg)).init
    grad_fn = make_grad_fn(cfg, rt)
    opt_init, opt_update = make_adamw(rt.adamw)

    def init_fn(gen: torch.Generator, device: DeviceLike = "cuda"):
        params = init(gen, resolve_device(device))
        return params, opt_init(params)

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = grad_fn(params, batch)
        new_params, new_opt, metrics = opt_update(grads, opt_state, params)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return init_fn, train_step


class GraphTrainStep:
    """The train step over donated state: the port's counterpart of
    ``jax.jit(train_step, donate_argnums=(0, 1))``.

    It owns ``params`` and ``opt_state`` (an :class:`AdamWState`), whose
    leaves never move.  A call ``step(batch) -> metrics`` copies the batch
    into static input buffers and runs one
    :class:`~repro_torch.graphs.StaticGraph` of :func:`make_grad_fn`'s loss
    and gradients and the AdamW update, which writes the new parameters,
    moments, master copy and step count into the same leaves (the
    donation).  It returns clones of the 0-d ``loss``, ``lr`` and
    ``grad_norm``, and no copy of the state: a caller who keeps a leaf
    across a call must clone it.

    The graph is captured at the first call, on that call's batch: the
    capture's eager warm-up is that step's update (the capture itself runs
    nothing), and every later call is one replay.  On the CPU the same
    function runs eagerly on the same static buffers, so the in-place
    contract is the same on both devices.  A failed capture or replay
    raises, and a batch whose keys, shapes or dtypes differ from the first
    call's is refused; nothing runs the step eagerly instead on the card.
    The step equals the functional ``train_step`` of :func:`make_train_fns`
    bit for bit on the same state and batches where the operations are
    deterministic (``torch.use_deterministic_algorithms``, which must then
    be on at the first call too: the mode picks the kernels the graph
    records).
    """

    def __init__(self, cfg: ArchConfig, rt: TrainRuntime, params, opt_state: AdamWState, *,
                 name: str = "train step") -> None:
        self.params, self.opt_state = params, opt_state
        self.name = name
        self.graph: Optional[StaticGraph] = None
        self._grad_fn = make_grad_fn(cfg, rt)
        self._update = make_adamw(rt.adamw)[1]
        self._leaves = tree_leaves((params, opt_state))
        self._specs: Dict[str, tuple] = {}  # the batch's layout, fixed by the first call
        # The metrics' own buffers, made by the first (eager) run: the
        # capture records the copies into them without running them, so
        # after the capture they hold the warm-up step's values.
        self._out: Dict[str, torch.Tensor] = {}

    def _step_fn(self, names):
        """The step over the batch's leaves in ``names``' order (a closure
        of locals, so that the graph holds no reference to ``self``)."""
        grad_fn, update, leaves, out = self._grad_fn, self._update, self._leaves, self._out
        params, opt_state = self.params, self.opt_state

        def step(*batch: torch.Tensor) -> Dict[str, torch.Tensor]:
            loss, grads = grad_fn(params, dict(zip(names, batch)))
            new_params, new_opt, metrics = update(grads, opt_state, params)
            metrics["loss"] = loss
            torch._foreach_copy_(leaves, tree_leaves((new_params, new_opt)))
            if not out:
                out.update({k: torch.empty_like(v) for k, v in metrics.items()})
            for k, v in metrics.items():
                out[k].copy_(v)
            return out

        return step

    @property
    def captured(self) -> bool:
        """Whether a CUDA graph was captured (never on the CPU)."""
        return self.graph is not None and self.graph.graph is not None

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        specs = _batch_layout(batch)
        names = sorted(batch)
        if self.graph is None:
            self._specs = specs
            inputs = [batch[n] for n in names]
            self.graph = StaticGraph(self._step_fn(names), inputs, name=self.name)
            if self.captured:  # the capture's warm-up took this batch's update
                return {k: v.clone() for k, v in self._out.items()}
            return self.graph(*inputs)
        _check_layout(self.name, specs, self._specs)
        return self.graph(*(batch[n] for n in names))

    def load(self, params, opt_state: AdamWState) -> None:
        """Copy ``(params, opt_state)``, a tree of the same structure (a
        restored checkpoint), into the step's leaves: the graph reads those
        buffers, so they are written, never rebound."""
        torch._foreach_copy_(self._leaves, tree_leaves((params, opt_state)))


def _batch_layout(batch: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    return {n: (tuple(x.shape), x.dtype) for n, x in batch.items()}


def _check_layout(name: str, specs: Dict[str, tuple], want: Dict[str, tuple]) -> None:
    """Refuse a batch whose leaves differ from the captured one's, naming
    the first leaf that differs."""
    if specs != want:
        bad = min(n for n in set(specs) | set(want) if specs.get(n) != want.get(n))
        raise ValueError(f"{name}: batch leaf {bad!r} is {specs.get(bad)}; the step "
                         f"was captured for {want.get(bad)}")


def microbatched_runtime(rt: TrainRuntime, shape: ShapeConfig, policy: ShardingPolicy):
    """``rt`` with its microbatch count halved until each microbatch's batch
    divides the DP extent (the reference's rule: otherwise the surplus mesh
    axes idle and compute replicates)."""
    mb = rt.microbatches
    while mb > 1 and (shape.global_batch // mb) % policy.dp_size != 0:
        mb //= 2
    return rt if mb == rt.microbatches else replace(rt, microbatches=mb)


class ShardedStep:
    """A step over DTensors: ``in_shardings`` is a tuple of sharding trees,
    one a positional argument.  A call places each plain leaf by its
    sharding (a DTensor leaf is taken as it is) and runs ``fn`` under
    ``activation_sharding(policy)``."""

    def __init__(self, fn, policy: ShardingPolicy, in_shardings: Tuple, *,
                 constrain: bool = True) -> None:
        self.fn = fn
        self.policy = policy
        self.in_shardings = in_shardings
        self.constrain = constrain

    def place(self, *args):
        """The arguments with every plain leaf distributed by its sharding."""
        return tuple(place_tree(a, sh) for a, sh in zip(args, self.in_shardings))

    def __call__(self, *args):
        args = self.place(*args)
        with sharded_region(), activation_sharding(self.policy if self.constrain else None):
            return self.fn(*args)


class GraphShardedStep:
    """A :class:`ShardedStep` over placed, donated state: the port's
    counterpart of the reference's pjit'd per-cell entry points
    (``jax.jit`` with ``in_shardings``, ``out_shardings`` and
    ``donate_argnums``).

    ``args`` are the step's leading arguments (parameters and AdamW state;
    parameters and decode state; parameters), placed once by the step's
    shardings; the step owns them and never rebinds them.  A call
    ``step(batch)`` takes the last argument, a dict of whole tensors (every
    rank passes the same), copies each rank's part of each leaf (the rows
    its placement gives it, as ``distribute_tensor`` would) into static
    placed buffers, and runs ``fn`` under ``sharded_region()`` and the
    policy's ``activation_sharding`` as one
    :class:`~repro_torch.graphs.StaticGraph`.  ``donate`` maps an
    argument's index to the index in ``fn``'s result of its new value: each
    of its leaves is written into the argument's leaf in place (a leaf that
    ``fn`` wrote itself, and returns, is left as it is).  The call returns
    ``fn``'s result at ``output`` (all of it if None) as clones of the
    step's own output buffers: plain tensors as they are, DTensors with
    their placements.

    The graph is captured at the first call, on that call's batch: the
    capture's eager warm-up is that call's step (the capture itself runs
    nothing; the warm-up's collectives create the process groups'
    communicators, and the clip's flattened group is made at
    construction), and every later call is one replay.  On the CPU (gloo groups)
    the same function runs eagerly on the same static buffers, so the
    in-place contract is the same on both devices.  A failed capture or
    replay raises, and a batch whose keys, shapes or dtypes differ from the
    first call's is refused; nothing runs the sharded step eagerly instead
    on the card.  As with :class:`GraphTrainStep`, deterministic
    algorithms must be on at the first call if they are wanted at all.
    """

    def __init__(self, step: ShardedStep, *args, name: str,
                 donate: Optional[Dict[int, int]] = None, output: Optional[int] = None) -> None:
        from torch.distributed.tensor import DTensor

        from repro_torch.optim.adamw import _whole_mesh

        self.step = step
        self.args = step.place(*args)
        self.name = name
        self.donate = dict(donate or {})
        self.output = output
        self.graph: Optional[StaticGraph] = None
        self._shardings = step.in_shardings[len(args)]
        self._specs: Dict[str, tuple] = {}
        self._out: list = []  # the output buffers, made by the first (eager) run
        self._out_meta: list = []  # per output leaf: None, or its DTensor layout
        self._out_tree: list = []  # the output's structure, leaves 0
        meshes = {t.device_mesh for t in tree_leaves(self.args) if isinstance(t, DTensor)}
        for mesh in meshes:
            if mesh.size() > 1:  # the clip's group, made before any capture
                _whole_mesh(mesh)

    def _layout(self, name: str):
        sh = self._shardings[name]
        return sh.mesh, sh.placements

    def _local(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return local_part(x, *self._layout(name))

    def _step_fn(self, names, specs):
        """The step over the batch's local parts in ``names``' order (a
        closure of locals, so that the graph holds no reference to
        ``self``)."""
        from torch.distributed.tensor import DTensor

        fn, args, donate, output = self.step.fn, self.args, self.donate, self.output
        policy = self.step.policy if self.step.constrain else None
        layouts = [(*self._layout(n), torch.Size(specs[n][0]), _contiguous_strides(specs[n][0]))
                   for n in names]
        out, meta, tree = self._out, self._out_meta, self._out_tree

        def run(*parts: torch.Tensor):
            batch = {n: DTensor.from_local(x, mesh, pl, run_check=False, shape=shape,
                                           stride=stride)
                     for n, x, (mesh, pl, shape, stride) in zip(names, parts, layouts)}
            with sharded_region(), activation_sharding(policy):
                result = fn(*args, batch)
            for a, r in donate.items():
                _write_in_place(tree_leaves(args[a]), tree_leaves(result[r]))
            res = result if output is None else result[output]
            leaves = tree_leaves(res)
            local = [_local(x) for x in leaves]
            if not out:
                tree.append(tree_unflatten(res, [0] * len(leaves)))
                out.extend(torch.empty_like(x) for x in local)
                meta.extend((x.device_mesh, x.placements, x.shape, x.stride())
                            if isinstance(x, DTensor) else None for x in leaves)
            torch._foreach_copy_(out, local)
            return out

        return run

    @property
    def captured(self) -> bool:
        """Whether a CUDA graph was captured (never on the CPU)."""
        return self.graph is not None and self.graph.graph is not None

    def __call__(self, batch: Dict[str, torch.Tensor]):
        specs = _batch_layout(batch)
        names = sorted(batch)
        if self.graph is None:
            missing = set(names) ^ set(self._shardings)
            if missing:
                raise ValueError(f"{self.name}: batch leaf {min(missing)!r} has no sharding "
                                 f"(the step takes {sorted(self._shardings)})")
            self._specs = specs
            parts = [self._local(n, batch[n]) for n in names]
            self.graph = StaticGraph(self._step_fn(names, specs), parts, name=self.name)
            if self.captured:  # the capture's warm-up took this batch's step
                return self._result([x.clone() for x in self._out])
            return self._result(self.graph(*parts))
        _check_layout(self.name, specs, self._specs)
        return self._result(self.graph(*(self._local(n, batch[n]) for n in names)))

    def _result(self, tensors):
        from torch.distributed.tensor import DTensor

        leaves = [t if m is None else DTensor.from_local(t, m[0], m[1], run_check=False,
                                                         shape=m[2], stride=m[3])
                  for t, m in zip(tensors, self._out_meta)]
        return tree_unflatten(self._out_tree[0], leaves)

    def load(self, *trees) -> None:
        """Copy whole trees of the placed arguments' structure (a restored
        checkpoint) into the step's leaves, each rank its own part: the
        graph reads those buffers, so they are written, never rebound."""
        from torch.distributed.tensor import DTensor

        dst, src = [], []
        for held, tree in zip(self.args, trees):
            for t, x in zip(tree_leaves(held), tree_leaves(tree)):
                if isinstance(t, DTensor):
                    t, x = t.to_local(), local_part(x, t.device_mesh, t.placements)
                dst.append(t)
                src.append(x)
        torch._foreach_copy_(dst, src)


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, n = [], 1
    for size in reversed(shape):
        strides.append(n)
        n *= size
    return tuple(reversed(strides))


def _write_in_place(olds, news) -> None:
    """Write each new leaf into its old one, shard by shard (the donation);
    a new leaf that is its old one is skipped."""
    dst, src = [], []
    for old, new in zip(olds, news):
        if new is old:
            continue
        if getattr(old, "placements", None) != getattr(new, "placements", None):
            raise ValueError(f"a donated leaf {tuple(old.shape)} came back laid out as "
                             f"{getattr(new, 'placements', None)}, not as "
                             f"{getattr(old, 'placements', None)}")
        dst.append(_local(old))
        src.append(_local(new))
    if dst:
        torch._foreach_copy_(dst, src)


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if hasattr(x, "to_local") else x


def shard_train_step(
    cfg: ArchConfig,
    shape: ShapeConfig,
    policy: ShardingPolicy,
    rt: Optional[TrainRuntime] = None,
):
    """The train step over a ``DeviceMesh`` and the abstract inputs.

    Returns ``(fn, (params_abs, opt_abs, batch_abs))``: the abstract values
    are ``meta`` tensors (nothing allocated), and ``fn(params, opt_state,
    batch) -> (params, opt_state, metrics)`` is a :class:`ShardedStep`.
    Parameters, AdamW state and batch are laid out by ``params_shardings``
    and ``batch_shardings`` (the batch microbatched as (k, B/k, ...) where
    ``rt.microbatches`` k > 1); the step trains with
    :data:`TRAIN_ATTN_IMPL`, reduces each gradient to its parameter's
    layout, and updates the parameter and optimizer leaves in place, so the
    returned trees are the DTensors it was given (the reference donates
    them).  ``metrics`` holds replicated plain tensors."""
    from torch.distributed.tensor import DTensor

    rt = microbatched_runtime(rt or get_runtime(cfg.arch_id), shape, policy)
    cfg = training_config(cfg)
    grad_fn = make_grad_fn(cfg, rt)
    opt_init, opt_update = make_adamw(rt.adamw)

    params_abs = abstract_params(cfg)
    opt_abs = opt_init(params_abs)
    batch_abs = abstract_inputs(cfg, shape)
    k = rt.microbatches
    if k > 1:
        batch_abs = {name: torch.empty((k, t.shape[0] // k, *t.shape[1:]), dtype=t.dtype,
                                       device="meta") for name, t in batch_abs.items()}

    p_sh = params_shardings(policy, params_abs, cfg)
    o_sh = AdamWState(
        step=NamedSharding(policy.mesh, P()),
        m=params_shardings(policy, opt_abs.m, cfg),
        v=params_shardings(policy, opt_abs.v, cfg),
        master=params_shardings(policy, opt_abs.master, cfg)
        if opt_abs.master is not None else None,
    )
    b_sh = batch_shardings(policy, batch_abs, microbatched=k > 1)

    def step(params, opt_state: AdamWState, batch):
        loss, grads = grad_fn(params, batch)
        leaves = tree_leaves(params)
        grads = tree_unflatten(params, [
            g.redistribute(p.device_mesh, p.placements) if isinstance(g, DTensor) else g
            for g, p in zip(tree_leaves(grads), leaves)])
        new_params, new_opt, metrics = opt_update(grads, opt_state, params)
        # In place: the inputs' buffers take the outputs (donation).
        for old, new in zip(leaves + tree_leaves(opt_state),
                            tree_leaves(new_params) + tree_leaves(new_opt)):
            old.copy_(new)
        metrics["loss"] = loss
        metrics = {name: _replicated(v) for name, v in metrics.items()}
        return params, opt_state, metrics

    return ShardedStep(step, policy, (p_sh, o_sh, b_sh)), (params_abs, opt_abs, batch_abs)


def graph_train_step(fn: ShardedStep, params, opt_state: AdamWState, *,
                     name: str) -> GraphShardedStep:
    """:func:`shard_train_step`'s step as one graph over donated parameters
    and AdamW state (``donate_argnums=(0, 1)``): ``step(batch) -> metrics``,
    the replicated 0-d ``loss``, ``lr`` and ``grad_norm``; ``step.args``
    holds the placed ``(params, opt_state)``."""
    return GraphShardedStep(fn, params, opt_state, donate={0: 0, 1: 1}, output=2, name=name)


def _replicated(x: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor of its full (reduced) value."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x
