"""CUDA-graph capture and replay over static buffers.

The port's counterpart of an XLA executable.  A function whose launches
Python would otherwise issue one by one on every call (a 1557-step SWE
solve, a 24-layer decode step) is recorded once into a CUDA graph and then
replayed with one launch call.  A :class:`StaticGraph` owns the graph's
static input buffers.  A call copies the caller's tensors into them,
replays the graph on the caller's current stream and returns clones of the
static outputs, so a result never aliases a buffer that the next replay
overwrites, and the caller's tensors are never written.

On the CPU (which a caller has to ask for) no graph exists: the function
runs eagerly on the same static buffers and its results are copied into
static outputs, so the copy-in and clone-out contract is the same on both
devices and the CPU tests hold it.

A failed capture or replay raises; nothing runs the function eagerly
instead on the card.
"""
from __future__ import annotations

import gc
import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.kernels import build

# Per thread and device: the stream this thread captures on.  Streams come
# from PyTorch's pools, one pool per priority, handed out round-robin; the
# capture streams take the high-priority pool, so a capture never records
# into a server's stream (those come from the default-priority pool).
_SIDE = threading.local()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    streams = _SIDE.__dict__.setdefault("streams", {})
    stream = streams.get(device.index)
    if stream is None:
        stream = streams[device.index] = torch.cuda.Stream(device, priority=-1)
    return stream


class _CollectorPause:
    """Python's cyclic garbage collector held off while any thread captures.

    A collection may free an object that owns another CUDA graph (a graph
    cache in a reference cycle); destroying a graph is an operation that
    CUDA refuses on a capturing thread, and the refusal invalidates that
    thread's capture.  The collector is one per process, so the pause is
    counted across threads; garbage waits for the first moment no capture
    runs."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._depth = 0
        self._was_enabled = False

    def __enter__(self) -> None:
        with self._lock:
            if self._depth == 0:
                self._was_enabled = gc.isenabled()
                gc.disable()
            self._depth += 1

    def __exit__(self, *exc) -> None:
        with self._lock:
            self._depth -= 1
            if self._depth == 0 and self._was_enabled:
                gc.enable()


_COLLECTOR_PAUSE = _CollectorPause()


class StaticGraph:
    """``fn`` over static copies of ``inputs``: captured once as one CUDA
    graph on the card, run eagerly on the CPU.

    ``fn`` takes tensors shaped like ``inputs`` and returns a tensor or a
    tuple (named or nested) of tensors.  It may also read and write tensors
    of its own: a graph records their addresses, so they stay in place.

    On the card the constructor runs ``fn`` once eagerly on a side stream
    (which builds kernel libraries and sets up cuBLAS before the capture),
    then captures it on that stream with ``capture_error_mode=
    "thread_local"``: another thread's ``cudaMalloc`` during the capture
    does not invalidate it.  ``CUDAGraph.capture_begin`` is used directly
    because ``torch.cuda.graph`` also synchronises the whole device, which
    would stall every other server on the card.  One instance serves one
    caller at a time.

    ``launches`` holds the port's kernel launches recorded in the graph, by
    counter name; each replay adds them to the launch counters and one to
    the counter ``graph_replays <name>``.
    """

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], *, name: str) -> None:
        self.fn = fn
        self.inputs: List[torch.Tensor] = [x.detach().clone() for x in inputs]
        self.replays = build.counter(f"graph_replays {name}")
        self.launches: Dict[str, int] = {}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._outputs: List[torch.Tensor] = []
        self._spec = None
        self._stream: Optional[torch.cuda.Stream] = None
        if self.inputs[0].device.type == "cuda":
            self._capture()

    def _capture(self) -> None:
        side = _side_stream(self.inputs[0].device)
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self.fn(*self.inputs)
            with build.recording() as tally, _COLLECTOR_PAUSE:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self.fn(*self.inputs)
                except BaseException:
                    _abandon(graph)
                    raise
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        self._stream = side
        self.graph = graph
        self.launches = dict(tally)
        self._outputs, self._spec = tree_flatten(out)

    def __call__(self, *inputs: torch.Tensor):
        """Copy ``inputs`` into the static buffers, run, and return clones
        of the outputs."""
        if self.graph is not None:
            self._order_after_last_replay()
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        if self.graph is None:
            self._run_eagerly()
        else:
            self.graph.replay()
            for name, n in self.launches.items():
                build.counter(name).add(n, replayed=True)
            self.replays.add()
        return tree_unflatten([x.clone() for x in self._outputs], self._spec)

    def _order_after_last_replay(self) -> None:
        # A caller may move to another stream between calls; the static
        # buffers must not be rewritten while the last replay still runs.
        stream = torch.cuda.current_stream()
        if stream != self._stream:
            stream.wait_stream(self._stream)
            self._stream = stream

    def _run_eagerly(self) -> None:
        leaves, spec = tree_flatten(self.fn(*self.inputs))
        if self._spec is None:
            self._outputs, self._spec = leaves, spec
            return
        for dst, src in zip(self._outputs, leaves):
            dst.copy_(src)


def _abandon(graph: torch.cuda.CUDAGraph) -> None:
    """End a capture that ``fn`` broke off with an exception.  Ending it may
    raise too; the exception to report is the one that broke it off."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
