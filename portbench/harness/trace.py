"""The device trace of a traced run: ``torch.profiler`` over a slice of the
measured window, reduced to what the per-layer metrics and the result line
read.

The profiler records the card's kernels, copies and memsets and every
thread's calls into the CUDA runtime (the balancer's workers run the device
work); host operations only on the thread that starts it.  The trace is
written as Chrome JSON under the checkout's ``build/portbench/`` and read back: the
kernels' launch grids are only in that export.  The window is the span of
a ``portbench.window`` marker recorded on the thread that starts and stops
the profiler, so device times and the window share one clock.
"""
from __future__ import annotations

import json
import os
from bisect import bisect_left
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "portbench.window"


@dataclass
class DeviceOp:
    name: str
    ts: float  # us
    dur: float  # us
    cat: str
    args: Dict


@dataclass
class HostSpan:
    name: str
    ts: float
    dur: float
    tid: int


@dataclass
class Trace:
    """A parsed slice: device operations and the host spans that the
    readers use, clipped to the window ``[t0, t1]`` (us)."""

    t0: float
    t1: float
    device: List[DeviceOp]
    host: List[HostSpan]
    launches: Dict[int, HostSpan] = field(default_factory=dict)  # correlation -> runtime call

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals inside the window."""
        spans = sorted((max(op.ts, self.t0), min(op.ts + op.dur, self.t1)) for op in self.device)
        merged: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernels(self, name: str) -> List[DeviceOp]:
        """The kernels whose (possibly templated or mangled) name holds
        ``name``."""
        return [op for op in self.device if op.cat == "kernel" and name in op.name]

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for op in self.device:
            d = min(op.ts + op.dur, self.t1) - max(op.ts, self.t0)
            if d > 0:
                key = op.name[:120]
                tot[key] = tot.get(key, 0.0) + d * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest stretches of the window with nothing on the
        card, each named by what the host was doing then: the innermost
        harness span or runtime call that covers the gap's middle, or else
        the device operation the gap follows."""
        busy = self.busy_intervals()
        gaps = []
        edge = self.t0
        prev = "window start"
        ends = {}
        for op in self.device:
            ends.setdefault(min(op.ts + op.dur, self.t1), op.name)
        for a, b in busy:
            if a > edge:
                gaps.append((a - edge, edge, a, prev))
            edge = b
            prev = ends.get(b, prev)
        if self.t1 > edge:
            gaps.append((self.t1 - edge, edge, self.t1, prev))
        gaps.sort(key=lambda g: -g[0])
        out = []
        starts = [h.ts for h in self.host]
        for length, a, b, after in gaps[:n]:
            mid = 0.5 * (a + b)
            cover = [h for h in self.host[: bisect_left(starts, mid)]
                     if h.ts + h.dur >= mid and h.name != WINDOW_MARK]
            if cover:
                inner = min(cover, key=lambda h: h.dur)
                label = f"host: {inner.name[:80]}"
            else:
                label = f"after {after[:80]}"
            out.append([label, length * 1e-6])
        return out


def _tid(e: Dict) -> int:
    tid = e.get("tid", 0)
    return int(tid) if str(tid).lstrip("-").isdigit() else 0


def parse(path: Path, host_names: Sequence[str] = ()) -> Trace:
    """Read a Chrome trace written by ``torch.profiler``; keep the device
    operations, the window marker, runtime launch calls and host spans whose
    names start with one of ``host_names``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    t0 = t1 = None
    device: List[DeviceOp] = []
    host: List[HostSpan] = []
    launches: Dict[int, HostSpan] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        name = e.get("name", "")
        if cat in DEVICE_CATS:
            device.append(DeviceOp(name, float(e["ts"]), float(e.get("dur", 0.0)), cat,
                                   e.get("args", {})))
            continue
        if name == WINDOW_MARK:
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            continue
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            span = HostSpan(name, float(e["ts"]), float(e.get("dur", 0.0)), _tid(e))
            if corr is not None:
                launches[int(corr)] = span
            host.append(span)
            continue
        if any(name.startswith(p) for p in host_names):
            host.append(HostSpan(name, float(e["ts"]), float(e.get("dur", 0.0)), _tid(e)))
    if t0 is None:
        raise RuntimeError(f"no '{WINDOW_MARK}' span in {path}")
    host.sort(key=lambda h: h.ts)
    return Trace(t0=t0, t1=t1, device=device, host=host, launches=launches)


class Tracer:
    """Start and stop the profiler from the thread that drives the window,
    at points where no other thread has work on the card or is in a call
    to the CUDA runtime (between two rounds of the MLDA driver); ``stop``
    writes and parses the trace.  Started from another thread while the
    balancer's workers launched graphs, the profiler hung a traced run in
    its start or stop now and then."""

    def __init__(self, out_dir: Path, host_names: Sequence[str] = ("portbench.",)) -> None:
        self.out_dir = Path(out_dir)
        self.host_names = tuple(host_names)
        self._prof = None
        self._mark = None
        self.trace: Optional[Trace] = None

    def start(self) -> None:
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        # Host operations are recorded on this thread only; the runtime's
        # launch calls on every thread.  Recording every thread's operations
        # slowed the host-bound program far more than the device trace does.
        try:  # trace_only (skip building events in Python) is newer than torch 2.11
            config = _ExperimentalConfig(trace_only=True)
        except TypeError:
            config = _ExperimentalConfig()
        self._prof = profile(activities=acts, experimental_config=config)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.start()
        self._mark = record_function(WINDOW_MARK)
        self._mark.__enter__()

    def stop(self) -> Trace:
        """Stop the profiler, write the trace and read it.  (Writing it only
        after the window has ended hung a traced serving run on the card:
        the export follows the stop at once.)"""
        import torch

        self._mark.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / "trace.json"
        self._prof.export_chrome_trace(str(path))
        self._prof = None
        self.trace = parse(path, self.host_names)
        os.remove(path)
        return self.trace
