"""Dynamic load balancer package (paper Section 2, Algorithm 1).

Layout (DESIGN.md §2-3):

* :mod:`repro_torch.balancer.types`      — ``Server`` / ``Request`` value types;
* :mod:`repro_torch.balancer.policies`   — pluggable :class:`SchedulingPolicy`
  strategies behind a name registry (``fifo`` is the paper-faithful
  default; ``round_robin`` / ``least_loaded`` / ``power_of_two`` /
  ``cost_aware`` explore the scheme families of psim and Gmeiner et al.);
* :mod:`repro_torch.balancer.dispatcher` — the event-driven core: one dispatch
  loop + an elastic worker pool (no thread-per-request; shrinks when
  servers retire or die);
* :mod:`repro_torch.balancer.queueing`   — the O(1) dispatch indexes: per-tag
  FIFO sub-queues under a global arrival sequence (``IndexedQueue``) and
  the incrementally-maintained free-server index (``FreeServerIndex``);
* :mod:`repro_torch.balancer.futures`    — client-side multi-request primitives
  (``wait_any`` / ``as_completed`` / ``gather``) so one thread can keep
  many requests outstanding (the ensemble driver's contract);
* :mod:`repro_torch.balancer.telemetry`  — idle-time/timeline bookkeeping and
  the runtime EWMA cost model, behind its own lock; it books the
  requests' spans while the span recorder (:mod:`repro_torch.spans`,
  re-exported here) is on;
* :mod:`repro_torch.balancer.health`     — self-healing pools: quarantine /
  probe / re-admission lifecycle and per-(server, tag) circuit breakers
  (opt-in via ``LoadBalancer(health=...)``);
* :mod:`repro_torch.balancer.faults`     — the deterministic chaos harness:
  seeded :class:`FaultPlan` injection of crashes, stragglers, NaN
  payloads and connection drops for fault-tolerance tests/benchmarks.

The reference's deprecated re-export shim ``repro.core.balancer`` has no
counterpart here: the port never had that import path.
"""
from .dispatcher import LoadBalancer
from .faults import FaultPlan, InjectedCrash, InjectedDrop, InjectedFault
from .futures import as_completed, gather, wait_any
from .health import HealthConfig, HealthMonitor
from .policies import (
    CostAwarePolicy,
    FifoPolicy,
    LeastLoadedPolicy,
    POLICIES,
    PolicyContext,
    PowerOfTwoPolicy,
    RoundRobinPolicy,
    SchedulingPolicy,
    available_policies,
    create_policy,
    register_policy,
)
from .queueing import FreeServerIndex, IndexedQueue
from repro_torch.spans import SPANS, Span, SpanLog, SpanRecorder

from .telemetry import P2Quantile, Telemetry
from .types import (
    BatchServer,
    DeadlineExceeded,
    DecodeHandoff,
    DecodePool,
    DecodeResult,
    DecodeSlot,
    PagedDecodePool,
    PagedSlot,
    PoisonRequestError,
    PromptTooLongError,
    QueueFull,
    Request,
    RequestCancelled,
    Server,
    ServerDiedError,
    ServerStats,
    ShardedBatchServer,
)

__all__ = [
    "BatchServer",
    "CostAwarePolicy",
    "DeadlineExceeded",
    "DecodeHandoff",
    "DecodePool",
    "DecodeResult",
    "DecodeSlot",
    "FaultPlan",
    "FifoPolicy",
    "FreeServerIndex",
    "HealthConfig",
    "HealthMonitor",
    "IndexedQueue",
    "InjectedCrash",
    "InjectedDrop",
    "InjectedFault",
    "LeastLoadedPolicy",
    "LoadBalancer",
    "P2Quantile",
    "POLICIES",
    "PagedDecodePool",
    "PagedSlot",
    "PoisonRequestError",
    "PromptTooLongError",
    "PolicyContext",
    "PowerOfTwoPolicy",
    "QueueFull",
    "Request",
    "RequestCancelled",
    "RoundRobinPolicy",
    "SPANS",
    "SchedulingPolicy",
    "Server",
    "ServerDiedError",
    "ServerStats",
    "ShardedBatchServer",
    "Span",
    "SpanLog",
    "SpanRecorder",
    "Telemetry",
    "as_completed",
    "available_policies",
    "create_policy",
    "gather",
    "register_policy",
    "wait_any",
]
