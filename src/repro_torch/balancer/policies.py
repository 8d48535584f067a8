"""Pluggable scheduling policies for the load balancer.

The seed hardwired one dispatch rule (Algorithm 1's FIFO over a shared
mutex-protected queue).  This module factors that rule out behind a
:class:`SchedulingPolicy` strategy interface, registered by name like
psim's ``create_load_balancer`` scheme families, so the design space the
related work explores (random / round-robin / least-loaded /
power-of-two-choices; Gmeiner et al.'s cost-aware multilevel scheduling)
is one string away:

    LoadBalancer(servers, policy="least_loaded")
    LoadBalancer(servers, policy=CostAwarePolicy())

Invariants shared by every policy (enforced by the base class):

* request scan order is FIFO over the arrival queue — a later request is
  considered only when no free server accepts an earlier one, which
  preserves the paper's FIFO fairness *and* the seed's head-of-line
  blocking avoidance for heterogeneous capacity tags (a free GP server
  never idles behind a queued PDE request);
* a policy only chooses *which* free compatible server executes a request,
  never reorders results or drops requests.

``fifo`` is the paper-faithful default and reproduces the seed's dispatch
order byte-for-byte (least-recently-freed server first; verified against a
recorded seed trace in ``tests/test_policies.py``).  See DESIGN.md §3.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

from .telemetry import Telemetry
from .types import Request, Server


@dataclass
class PolicyContext:
    """What a policy may look at when choosing a server.

    ``servers`` is the full pool (busy and free — load-aware policies need
    both); ``telemetry`` exposes the runtime cost model; ``now`` is the
    clock (monotonic in production, a fake in deterministic tests).
    """

    servers: Sequence[Server] = ()
    telemetry: Telemetry = field(default_factory=Telemetry)
    now: Callable[[], float] = time.monotonic


class SchedulingPolicy:
    """Strategy interface: pick the next (request, server) pair to dispatch.

    Subclasses normally override only :meth:`choose_server` — the policy
    author's contract is *choosing a server from ready candidates*, not
    scanning the queue.  On the dispatch hot path the engine maintains
    per-tag FIFO sub-queues and a free-server index
    (:mod:`repro_torch.balancer.queueing`) and calls :meth:`select_ready` with
    the already-derived ready pairs, so a decision costs O(queued tags),
    not O(queue x servers).

    :meth:`select` is the flat-scan *reference implementation* of the same
    semantics.  It remains the contract for simulators (the fake-clock
    test harness) and for legacy policies that override it to change
    request scan order — the dispatcher detects such an override and falls
    back to the flat path for them (none of the built-ins do: FIFO
    fairness is a shared invariant, enforced by the index).
    """

    name: str = "abstract"

    def select(
        self,
        queue: Sequence[Request],
        ctx: PolicyContext,
    ) -> Optional[Tuple[Request, Server]]:
        """Earliest queued request that a free server can serve.

        With a homogeneous pool this is exactly the paper's FIFO head; with
        heterogeneous capacity tags it additionally avoids head-of-line
        blocking (a free GP server never idles behind a queued PDE request).
        """
        free = [s for s in ctx.servers if not s.busy and not s.dead]
        if not free:
            return None
        for req in queue:
            candidates = [s for s in free if s.accepts(req.tag)]
            if candidates:
                return req, self.choose_server(req, candidates, ctx)
            # req stays queued; requests behind it may still match others.
        return None

    def select_ready(
        self,
        ready: Sequence[Tuple[Request, List[Server]]],
        ctx: PolicyContext,
    ) -> Tuple[Request, Server]:
        """Indexed hot path: pick from pre-derived ready pairs.

        ``ready`` holds one ``(head request, free compatible servers)``
        pair per dispatchable tag, ordered by arrival sequence — element 0
        is exactly the request the flat scan of :meth:`select` would have
        chosen, and the candidate list is in pool order like the flat
        scan's.  The default takes it and delegates to
        :meth:`choose_server`, which keeps every built-in policy
        decision-for-decision identical to the reference implementation.
        """
        req, candidates = ready[0]
        return req, self.choose_server(req, candidates, ctx)

    def choose_server(
        self, req: Request, candidates: Sequence[Server], ctx: PolicyContext
    ) -> Server:
        raise NotImplementedError

    def reset(self) -> None:
        """Clear any internal state (cursor, rng) between runs."""


def _least_recently_freed(candidates: Sequence[Server]) -> Server:
    # Stable min — ties broken by pool order, matching the seed's stable sort.
    return min(candidates, key=lambda s: s.last_free_at)


class FifoPolicy(SchedulingPolicy):
    """Paper-faithful Algorithm 1: FIFO queue, least-recently-freed server.

    Reproduces the seed ``LoadBalancer._next_dispatchable`` exactly.
    """

    name = "fifo"

    def choose_server(self, req, candidates, ctx):
        return _least_recently_freed(candidates)


class RoundRobinPolicy(SchedulingPolicy):
    """Cycle through the pool in server order, skipping busy/incompatible.

    The cursor is a server id, not an index into the (varying) free subset:
    the next dispatch goes to the first candidate at or after the cursor in
    cyclic id order, so every server gets its turn even as the free set
    changes between calls.
    """

    name = "round_robin"

    def __init__(self) -> None:
        self._cursor_id = 0

    def choose_server(self, req, candidates, ctx):
        ordered = sorted(candidates, key=lambda s: s.id)
        chosen = next(
            (s for s in ordered if s.id >= self._cursor_id), ordered[0]
        )
        self._cursor_id = chosen.id + 1
        return chosen

    def reset(self) -> None:
        self._cursor_id = 0


class LeastLoadedPolicy(SchedulingPolicy):
    """Send work to the server with the least cumulative busy time.

    With heterogeneous server speeds this self-balances: fast servers
    accumulate busy seconds slowly, so they keep winning the argmin and
    absorb more of the stream.
    """

    name = "least_loaded"

    def choose_server(self, req, candidates, ctx):
        t = ctx.telemetry
        return min(
            candidates, key=lambda s: (t.server_busy_seconds(s.name), s.last_free_at)
        )


class PowerOfTwoPolicy(SchedulingPolicy):
    """Power-of-two-choices: sample two candidates, keep the less loaded.

    The classic O(log log n) trick — near-least-loaded quality at O(1)
    sampling cost, without scanning the whole pool.  Deterministic under a
    seeded rng (important for the fake-clock tests).
    """

    name = "power_of_two"

    def __init__(self, seed: int = 0) -> None:
        self._seed = seed
        self._rng = random.Random(seed)

    def choose_server(self, req, candidates, ctx):
        if len(candidates) == 1:
            return candidates[0]
        a, b = self._rng.sample(list(candidates), 2)
        t = ctx.telemetry
        key = lambda s: (t.server_busy_seconds(s.name), s.last_free_at)  # noqa: E731
        return a if key(a) <= key(b) else b

    def reset(self) -> None:
        self._rng = random.Random(self._seed)


class CostAwarePolicy(SchedulingPolicy):
    """Gmeiner-style cost-aware routing over the per-tag runtime EWMA.

    The telemetry cost model tracks EWMA service time per tag and per
    (server, tag).  Requests whose tag is *expensive* (EWMA at or above the
    median across tags — e.g. fine-PDE levels in the paper's hierarchy) are
    routed to the fastest free server for that tag; *cheap* tags are routed
    to the slowest adequate server, deliberately keeping the fast servers
    free for the long solves that dominate makespan.  Before any runtime
    data exists it degrades to the paper's FIFO choice.
    """

    name = "cost_aware"

    def choose_server(self, req, candidates, ctx):
        t = ctx.telemetry
        tag_cost = t.tag_ewma(req.tag)
        if tag_cost is None:
            return _least_recently_freed(candidates)

        def expected(s: Server) -> float:
            per_server = t.server_tag_ewma(s.name, req.tag)
            return per_server if per_server is not None else tag_cost

        ewmas = sorted(t.tag_ewmas().values())
        median = ewmas[len(ewmas) // 2]
        if tag_cost >= median:
            # long tag -> fastest free server (min expected service time)
            return min(candidates, key=lambda s: (expected(s), s.last_free_at))
        # short tag -> slowest adequate server, keep fast ones free
        return max(candidates, key=lambda s: (expected(s), -s.last_free_at))


# --------------------------------------------------------------------------
# Registry (psim's create_load_balancer idiom)
# --------------------------------------------------------------------------
POLICIES: Dict[str, Type[SchedulingPolicy]] = {}


def register_policy(cls: Type[SchedulingPolicy]) -> Type[SchedulingPolicy]:
    """Class decorator / call: register a policy under ``cls.name``."""
    POLICIES[cls.name] = cls
    return cls


for _cls in (FifoPolicy, RoundRobinPolicy, LeastLoadedPolicy, PowerOfTwoPolicy,
             CostAwarePolicy):
    register_policy(_cls)


def available_policies() -> List[str]:
    return sorted(POLICIES)


def create_policy(policy: "str | SchedulingPolicy", **kwargs) -> SchedulingPolicy:
    """Resolve a policy by name (or pass an instance through).

    Mirrors psim's ``LoadBalancer::create_load_balancer(type, ...)``.
    """
    if isinstance(policy, SchedulingPolicy):
        return policy
    try:
        cls = POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy '{policy}'; "
            f"available: {', '.join(available_policies())}"
        ) from None
    return cls(**kwargs)
