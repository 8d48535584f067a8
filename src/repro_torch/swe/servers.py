"""Server-pool wiring for the Tōhoku MLDA workload (DESIGN.md §8).

With ``MLDAWorkloadConfig.batch_solves`` (the default) every server is a
:class:`repro_torch.balancer.types.BatchServer`: its handler takes a stacked
``(B, ...)`` parameter array, so the dispatcher's coalescing path runs a
whole same-level batch as ONE batched solve (on the card, one fused-kernel
launch per time step) instead of B back-to-back solves.

Handlers take numpy in and give numpy out, as the balancer's servers do in
the reference: the thetas go to the forward's device as float32, and the
result comes back to the host on the worker thread, so a server's busy
interval covers the real device work.  On the card each server issues its
work on a CUDA stream of its own: on one shared stream a GP evaluation's
copy to the host would wait behind every fine-level step queued before it.

With a :class:`repro_torch.runtime.sharding.ShardingPolicy` (``policy=``,
or ``MLDAWorkloadConfig.mesh_devices`` alone) a level whose per-device
stacked forward is available (``stacked_forwards=``: factories
``device -> forward``, :func:`stacked_factory` of a scenario) becomes ONE
:class:`repro_torch.balancer.types.ShardedBatchServer` pool instead of
``servers_per_level`` thread replicas: the coalesced batch is split over
the devices of the mesh, so the balancer schedules across mesh shards,
not threads (DESIGN.md §9).
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import replace
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.balancer import BatchServer, Server, ShardedBatchServer
from repro_torch.spans import SPANS


def _on_host(fn: Callable, device: torch.device) -> Callable:
    """``fn`` with numpy in and out, on a stream of its own on the card.
    While the span recorder records, a call is a ``pool.call`` span (tag
    the returned function's ``tag``, which the caller sets to the level;
    ``n`` the rows) whose child ``pool.sync`` is the read of the result to
    the host; the rest is host work: the copy in, padding and the graph's
    launch."""
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def call(thetas) -> np.ndarray:
        x = np.asarray(thetas, dtype=np.float32)
        t0 = time.monotonic() if SPANS.on else None
        with torch.cuda.stream(stream) if stream is not None else nullcontext():
            out = fn(torch.as_tensor(x, device=device))
            if t0 is None:
                return out.cpu().numpy()
            t1 = time.monotonic()
            host = out.cpu().numpy()
        t2 = time.monotonic()
        sid = SPANS.new_id()
        SPANS.add("pool.sync", t1, t2, parent=sid, tag=call.tag, n=len(x))
        SPANS.add("pool.call", t0, t2, id=sid, tag=call.tag, n=len(x))
        return host

    call.tag = ""
    return call


def stacked_factory(scenario) -> Callable:
    """``device -> forward``: ``scenario``'s stacked forward
    (:meth:`~repro_torch.swe.scenario.TohokuScenario.build_stacked_forward`)
    built on ``device``, the per-device factory of a sharded pool."""
    return lambda device: replace(scenario, device=str(device)).build_stacked_forward()


def make_level_servers(
    w,
    gp,
    f_coarse: Callable,
    f_fine: Callable,
    *,
    batch_forwards: Optional[Sequence[Optional[Callable]]] = None,
    stacked_forwards: Optional[Sequence[Optional[Callable]]] = None,
    policy=None,
) -> List[Server]:
    """One GP server + the config's per-level coarse/fine SWE servers.

    When ``w.batch_solves`` is set, a level whose batched forward is
    available becomes a :class:`BatchServer` capped at ``w.max_batch``;
    levels without one get per-request servers.  ``batch_forwards`` is
    ``(level0, level1, level2)`` stacked handlers (``None`` entries fall
    back); the GP's own ``batch_call`` fills level 0 when none is given.
    Every forward carries its ``device`` (the scenario's, or the GP's).

    When ``policy`` (a :class:`~repro_torch.runtime.sharding.ShardingPolicy`
    over a :class:`~repro_torch.runtime.sharding.DataMesh`) is also given,
    or ``w.mesh_devices`` derives one (``data_policy(data_mesh(n))``),
    levels with a per-device stacked forward (``stacked_forwards``:
    factories ``device -> forward``; the GP's copy on each device fills
    level 0) become a single :class:`ShardedBatchServer` pool each, named
    ``gp-0`` / ``coarse-pool`` / ``fine-pool``; ``servers_per_level``
    replica counts are ignored for those levels, since the mesh shards
    replace the thread replicas.
    """
    batching = bool(getattr(w, "batch_solves", False))
    max_batch = int(getattr(w, "max_batch", 8)) or None
    if policy is None and batching and getattr(w, "mesh_devices", None):
        # The config asked for a device mesh without the caller building a
        # policy: derive it here, on the GP's device type, so setting the
        # knob alone shards the pools.
        from repro_torch.runtime.sharding import data_mesh, data_policy

        policy = data_policy(data_mesh(w.mesh_devices, device=gp.device.type))
    bf = list(batch_forwards or (None, None, None))
    while len(bf) < 3:
        bf.append(None)
    if batching and bf[0] is None:
        bf[0] = gp.batch_call
    sf = list(stacked_forwards or (None, None, None))
    while len(sf) < 3:
        sf.append(None)
    if policy is not None and sf[0] is None and hasattr(gp, "to"):
        sf[0] = lambda device: gp.to(device).batch_call
    devices = (gp.device, f_coarse.device, f_fine.device)

    def sharded(level: int) -> bool:
        return batching and policy is not None and sf[level] is not None

    def on_host(fn: Callable, level: int, tag: str) -> Callable:
        call = _on_host(fn, devices[level])
        call.tag = tag  # the level, in the pool.call spans
        return call

    def server(level: int, single: Callable, name: str, tag: str) -> Server:
        if sharded(level):
            return ShardedBatchServer(
                sf[level], policy, name=name, capacity_tags=(tag,),
                max_batch=max_batch, cache_key=("pool", tag),
            )
        if batching and bf[level] is not None:
            return BatchServer(
                on_host(bf[level], level, tag), name=name,
                capacity_tags=(tag,), max_batch=max_batch,
            )
        return Server(on_host(single, level, tag), name=name, capacity_tags=(tag,))

    servers = [server(0, gp, "gp-0", "level0")]
    for level, f, pool, replica in ((1, f_coarse, "coarse-pool", "coarse"),
                                    (2, f_fine, "fine-pool", "fine")):
        if sharded(level):
            servers.append(server(level, f, pool, f"level{level}"))
            continue
        for i in range(max(w.servers_per_level.get(level, 1), 1)):
            servers.append(server(level, f, f"{replica}-{i}", f"level{level}"))
    return servers


def local_level_servers(w, gp, h, *, policy=None) -> List[Server]:
    """:func:`make_level_servers` over the GP and a :func:`build_hierarchy`
    ``h``: the in-process level pools (batched forwards with
    ``w.batch_solves``; one sharded pool a level, over the scenarios'
    per-device forwards, with a ``policy`` or ``w.mesh_devices``)."""
    return make_level_servers(
        w, gp, h["forward_coarse"], h["forward_fine"],
        batch_forwards=(
            None, h["forward_coarse_batch"], h["forward_fine_batch"]
        ) if w.batch_solves else None,
        stacked_forwards=(
            None, stacked_factory(h["coarse"]), stacked_factory(h["fine"])
        ) if w.batch_solves else None,
        policy=policy,
    )


def make_remote_level_servers(
    w,
    addresses: Sequence[str],
    *,
    binary: Optional[bool] = None,
) -> List[Server]:
    """Remote replicas of the level pools: the client half of a
    two-process deployment (DESIGN.md §11).

    Each address is a ``host:port`` endpoint running
    ``python -m repro_torch.launch.export`` (a
    :class:`~repro_torch.net.server.ServerShell` over the pool
    :func:`make_level_servers` builds there).  One shared transport per
    endpoint (its pipelined connection pool multiplexes every level tag)
    and one :class:`~repro_torch.net.client.RemoteBatchServer` per exported
    tag, so the dispatcher's coalescing path ships a stacked ``(B, ...)``
    batch as ONE framed call.  Replicated tags across endpoints behave as
    replicated local servers: the policy balances across them, and a dead
    endpoint's in-flight members requeue onto the survivors.  An endpoint
    that cannot be reached raises :class:`~repro_torch.net.TransportError`;
    nothing falls back to an in-process pool.

    ``binary=None`` takes ``w.remote_binary``; transports must be closed
    by the caller (``server.transport.close()`` once per distinct
    transport) after the balancer shuts down.
    """
    from repro_torch.net import make_transport, remote_servers_for

    kwargs = dict(w.remote_kwargs())
    if binary is not None:
        kwargs["binary"] = binary
    timeout = kwargs.get("read_timeout")
    servers: List[Server] = []
    for addr in addresses:
        transport = make_transport(addr, **kwargs)
        servers.extend(
            remote_servers_for(
                transport,
                batch=bool(getattr(w, "batch_solves", True)),
                max_batch=int(getattr(w, "max_batch", 8)) or None,
                name_prefix=f"remote-{addr}",
                request_timeout=timeout,
            )
        )
    return servers


def close_transports(servers: Sequence[Server]) -> int:
    """Close each distinct transport of the remote ``servers`` once (an
    endpoint's replicas share one); return how many were closed."""
    transports = {id(s.transport): s.transport for s in servers if hasattr(s, "transport")}
    for tr in transports.values():
        tr.close()
    return len(transports)
