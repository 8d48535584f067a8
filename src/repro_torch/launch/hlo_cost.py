"""Per-device cost of one step: flops, bytes, collectives and live memory.

The counterpart of the reference's ``launch/hlo_cost.py``, which parses a
compiled XLA module.  Eager PyTorch has no module to parse: :func:`analyze`
runs the step under a dispatch mode and counts what it dispatches, on one
rank's share (rank 0's).  Used under ``FakeTensorMode`` with the ``"fake"``
process-group backend (the dry-run), nothing is computed or allocated.

* **flops**: ``2 x numel(out) x K`` for every product (``mm``, ``bmm``,
  ``addmm``, ``baddbmm`` and their ``out_dtype`` overloads), where
  ``numel(out)`` is the output's *local* shard and K the contracted size,
  divided by the sizes of the mesh dims on which the output is ``Partial``
  (each rank then contracts 1/n of K).  A dispatch mode sees a DTensor
  operation before DTensor lays its operands out, so the operands' local
  shapes are not the local product's; the output's are.  Compute that is
  replicated counts in full on every rank, as it runs there.
* **bytes**: the local operands plus the local result of each dispatched
  operation, views excluded.  Eager PyTorch does not fuse, so this is not
  the reference's post-fusion count: an elementwise chain is counted once an
  operation here and once a fusion there.  The two are not compared.
* **collectives**: the functional collectives that DTensor (and the port's
  own all-reduces) issue, each counted by its output's bytes, by kind.
* **attention**: the flops and bytes of operations dispatched inside the
  plain blocked attention (``attention_chunked``), the reference's
  ``jit(attention)`` scope, forward and recomputation alike.
* **peak_bytes**: the most bytes of local storage alive at once: the
  arguments, every result, and what the collectives gather.

The reference's HLO parser (``parse_hlo``, ``_trip_count``) has no
counterpart: eager code has no while-loops whose bodies count once; every
layer, microbatch and key block is dispatched, and counted, as it runs.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")

# Functional-collective entry points -> the reference's kind names.
_FUNCOL = {
    "all_gather_tensor": "all-gather",
    "all_gather_single": "all-gather",
    "all_gather_tensor_autograd": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_single": "reduce-scatter",
    "reduce_scatter_tensor_autograd": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "all_to_all_single_autograd": "all-to-all",
    "permute_tensor": "collective-permute",
}

_aten = torch.ops.aten
# Products: op -> (index of the left operand, index of the right operand).
_PRODUCTS = {
    _aten.mm.default: (0, 1),
    _aten.bmm.default: (0, 1),
    _aten.addmm.default: (1, 2),
    _aten.baddbmm.default: (1, 2),
}
for _name in ("mm", "bmm"):
    _op = getattr(_aten, _name)
    if "dtype" in _op.overloads():
        _PRODUCTS[_op.dtype] = (0, 1)
_CONVS = {_aten.convolution.default}
_VIEWS = {
    "view", "_unsafe_view", "reshape", "transpose", "t", "permute", "expand", "select",
    "slice", "as_strided", "detach", "alias", "unsqueeze", "squeeze", "split",
    "split_with_sizes", "unbind", "view_as", "_reshape_alias", "lift_fresh",
}
_SKIP_NAMESPACES = ("_c10d_functional", "_dtensor", "c10d")


@dataclass
class CostSummary:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    collective_count: int = 0
    unknown_flop_ops: int = 0
    # Flops and bytes of the operations dispatched inside the chunked
    # attention call (the reference's jit(attention) scope).  The flash
    # kernel keeps these tiles on chip.
    attention_bytes: float = 0.0
    attention_flops: float = 0.0
    peak_bytes: float = 0.0
    ops: int = 0


def _local(t):
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _partial_split(t) -> int:
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return 1
    n = 1
    for size, p in zip(t.device_mesh.shape, t.placements):
        if p.is_partial():
            n *= size
    return n


class _Live:
    """Bytes of local storage alive, by storage, and their peak."""

    def __init__(self) -> None:
        self.seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.live = 0
        self.peak = 0

    def add(self, t) -> None:
        if not isinstance(t, torch.Tensor):
            return
        t = _local(t)
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        if st in self.seen:
            return
        n = st.nbytes()
        self.seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n


class CostCounter(TorchDispatchMode):
    """The dispatch mode of :func:`analyze` (usable on its own: enter it,
    run, read ``.summary``)."""

    def __init__(self) -> None:
        super().__init__()
        self.summary = CostSummary()
        self.live = _Live()
        self.in_attention = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _SKIP_NAMESPACES:
            return out
        s = self.summary
        s.ops += 1
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            self.live.add(o)
        flops = 0.0
        if func in _PRODUCTS:
            i, _ = _PRODUCTS[func]
            k = args[i].shape[-1]
            o = outs[0]
            flops = 2.0 * _local(o).numel() * k / _partial_split(o)
        elif func in _CONVS:
            s.unknown_flop_ops += 1
        name = func.overloadpacket.__name__
        nbytes = 0
        if name not in _VIEWS:
            for a in list(args) + list(kwargs.values()):
                if isinstance(a, torch.Tensor):
                    nbytes += _nbytes(a)
                elif isinstance(a, (list, tuple)):
                    nbytes += sum(_nbytes(x) for x in a if isinstance(x, torch.Tensor))
            nbytes += sum(_nbytes(o) for o in outs if isinstance(o, torch.Tensor))
        s.flops += flops
        s.bytes += nbytes
        if self.in_attention:
            s.attention_flops += flops
            s.attention_bytes += nbytes
        return out

    def collective(self, kind: str, result) -> None:
        s = self.summary
        b = _nbytes(result)
        s.collectives[kind] += b
        s.collective_bytes += b
        s.collective_count += 1
        self.live.add(result)


@contextlib.contextmanager
def _patched(counter: CostCounter):
    """Count the functional collectives (DTensor issues them inside its own
    dispatch, where no dispatch mode sees them) and mark the chunked
    attention's scope, for the block's duration."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.models import chunked_attention

    saved = []

    def wrap_collective(name, kind):
        real = getattr(funcol, name)

        def counted(*a, **kw):
            result = real(*a, **kw)
            counter.collective(kind, result)
            return result

        saved.append((funcol, name, real))
        setattr(funcol, name, counted)

    for name, kind in _FUNCOL.items():
        if hasattr(funcol, name):
            wrap_collective(name, kind)
    real_attn = chunked_attention.attention_chunked

    def scoped(*a, **kw):
        counter.in_attention += 1
        try:
            return real_attn(*a, **kw)
        finally:
            counter.in_attention -= 1

    saved.append((chunked_attention, "attention_chunked", real_attn))
    chunked_attention.attention_chunked = scoped
    try:
        yield
    finally:
        for mod, name, real in reversed(saved):
            setattr(mod, name, real)


def analyze(fn, *args, **kwargs) -> CostSummary:
    """Run ``fn(*args, **kwargs)`` once and return what one rank did: a
    :class:`CostSummary`.  The arguments' local storage counts as live from
    the start (``peak_bytes`` holds the step's arguments and temporaries,
    the reference's argument + temp)."""
    from repro_torch.optim.tree import tree_leaves

    counter = CostCounter()
    for a in tree_leaves(list(args) + list(kwargs.values())):
        counter.live.add(a)
    with _patched(counter), counter:
        fn(*args, **kwargs)
    s = counter.summary
    s.peak_bytes = float(counter.live.peak)
    s.collectives = {k: float(s.collectives.get(k, 0.0)) for k in COLLECTIVE_KINDS}
    return s
