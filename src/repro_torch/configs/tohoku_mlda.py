"""The paper's own workload: 3-level MLDA Tōhoku tsunami inversion (§6).

Not an LM arch — this config wires the UQ pipeline: scenario resolutions
per level, GP training budget, sampler settings, and balancer pool layout.
Scaled presets: 'paper' mirrors §6.1 ratios (runtimes span orders of
magnitude); 'cpu' is the laptop-scale variant used by examples and tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MLDAWorkloadConfig:
    name: str
    # grid resolutions per level (level 0 is the GP surrogate)
    coarse_grid: Tuple[int, int]
    fine_grid: Tuple[int, int]
    t_end_s: float
    # GP surrogate (paper: 512 LHS points from the level-1 model)
    gp_train_points: int
    gp_opt_steps: int
    # sampler
    n_chains: int = 5  # paper: 5-element job array = 5 parallel chains
    n_fine_samples: int = 150  # paper: 155 level-2 samples
    subchain_lengths: Tuple[int, int] = (10, 5)
    rw_step_km: float = 15.0
    # balancer pool: servers per level (paper: shared pool, FCFS)
    servers_per_level: Dict[int, int] = field(
        default_factory=lambda: {0: 1, 1: 2, 2: 2}
    )
    # scheduling policy (repro_torch.balancer.policies registry): 'fifo' is the
    # paper-faithful Algorithm 1 default; alternatives: 'round_robin',
    # 'least_loaded', 'power_of_two', 'cost_aware'.
    balancer_policy: str = "fifo"
    # ensemble (repro_torch.ensemble): chains are multiplexed through one shared
    # balancer by a single driver thread; per-chain RNG streams are spawned
    # from ensemble_seed.  speculative_prefetch starts the next coarse
    # subchain while a fine solve is still on a server (bit-identical
    # chains either way; see DESIGN.md §8).
    ensemble_seed: int = 0
    speculative_prefetch: bool = False
    # batched forward-solve engine (DESIGN.md §2/§7): same-level solves from
    # the ensemble's chains coalesce into ONE stacked vmapped AOT launch per
    # server call.  batch_window_s caps the adaptive coalescing window (the
    # dispatcher shrinks it to a fraction of the level's EWMA service time);
    # max_batch caps the realised batch size (executables are cached per
    # power-of-two size up to this).
    batch_solves: bool = True
    max_batch: int = 8
    batch_window_s: float = 0.01
    # telemetry mode (DESIGN.md §2): the streaming default records in O(1)
    # with bounded memory (running moments + P2 quantile estimators); set
    # exact_telemetry for paper-figure runs that need exact quantiles over
    # the full, unbounded request history.
    exact_telemetry: bool = False
    # device-resident ensemble (DESIGN.md §9): advance all chains' coarse
    # subchains as ONE fused vmapped device kernel, surfacing to the
    # balancer only for fine-level solves; device_chunk is the fused
    # steps-per-host-sync in the fully-fused mode.  mesh_devices, when set,
    # makes each level ONE ShardedBatchServer over a 1-D ("data",) mesh of
    # that many devices (swe.make_level_servers; None = the per-level
    # BatchServer replicas; sharded pools need batch_solves).
    device_resident: bool = False
    device_chunk: int = 16
    mesh_devices: Optional[int] = None
    # remote serving (repro_torch.net, DESIGN.md §11): when remote_servers names
    # 'host:port' endpoints (each a launch/export.py ServerShell), the
    # example builds RemoteBatchServer replicas against them instead of
    # in-process pools.  remote_binary picks the zero-copy framing mode
    # (False = UM-Bridge JSON interop); remote_connections sizes the
    # pipelined connection pool per endpoint; remote_timeout_s bounds each
    # round trip; remote_retries is the transport-level redial budget
    # (the dispatcher's max_retries separately bounds requeues after a
    # remote server is declared dead).
    remote_servers: Tuple[str, ...] = ()
    remote_binary: bool = True
    remote_connections: int = 2
    remote_timeout_s: float = 30.0
    remote_retries: int = 2
    # fault tolerance (DESIGN.md §12) — all off by default (the defaults
    # keep the engine byte-identical to the pre-fault-tolerance one).
    # self_healing enables the balancer's quarantine/probe/re-admission
    # lifecycle for dead servers (probe_interval_s sets the monitor
    # cadence); poison_threshold fails a request once it has killed that
    # many distinct servers instead of letting one bad theta exterminate
    # the pool; max_queue_per_tag bounds per-level queue depth (admission
    # control: excess submissions are rejected with QueueFull); chain
    # auto-resume restarts a failed chain from its latest snapshot
    # (max_restarts times, snapshots every checkpoint_every fine samples).
    self_healing: bool = False
    probe_interval_s: float = 0.05
    poison_threshold: Optional[int] = None
    max_queue_per_tag: Optional[int] = None
    max_restarts: int = 0
    checkpoint_every: int = 0

    @property
    def batchable_levels(self) -> Tuple[int, ...]:
        """Levels whose requests may coalesce (all of them when batching)."""
        return (0, 1, 2) if self.batch_solves else (0,)

    def batch_kwargs(self) -> Dict[str, object]:
        """Balancer construction kwargs implementing this config's batching."""
        if not self.batch_solves:
            return {}
        return {"batch_window_s": self.batch_window_s, "max_batch": self.max_batch}

    def balancer_kwargs(self) -> Dict[str, object]:
        """All balancer construction kwargs this config implies (batching,
        telemetry mode, fault tolerance) — what examples/benchmarks splat."""
        kwargs = self.batch_kwargs()
        if self.exact_telemetry:
            kwargs["exact_telemetry"] = True
        if self.self_healing:
            from repro_torch.balancer import HealthConfig

            kwargs["health"] = HealthConfig(probe_interval_s=self.probe_interval_s)
        if self.poison_threshold is not None:
            kwargs["poison_threshold"] = self.poison_threshold
        if self.max_queue_per_tag is not None:
            kwargs["max_queue_per_tag"] = self.max_queue_per_tag
        return kwargs

    def runner_kwargs(self) -> Dict[str, object]:
        """EnsembleRunner construction kwargs for chain auto-resume."""
        if self.max_restarts <= 0:
            return {}
        return {
            "max_restarts": self.max_restarts,
            "checkpoint_every": self.checkpoint_every,
        }

    def remote_kwargs(self) -> Dict[str, object]:
        """Transport construction kwargs for the remote endpoints
        (:func:`repro_torch.net.make_transport` keywords)."""
        return {
            "binary": self.remote_binary,
            "n_connections": self.remote_connections,
            "read_timeout": self.remote_timeout_s,
            "retries": self.remote_retries,
        }


PAPER = MLDAWorkloadConfig(
    name="paper",
    coarse_grid=(96, 96),
    fine_grid=(288, 288),
    t_end_s=4 * 3600.0,
    gp_train_points=512,
    gp_opt_steps=200,
)

CPU = MLDAWorkloadConfig(
    name="cpu",
    coarse_grid=(32, 32),
    fine_grid=(64, 64),
    t_end_s=2 * 3600.0,
    gp_train_points=128,
    gp_opt_steps=150,
    n_chains=3,
    n_fine_samples=30,
    subchain_lengths=(5, 3),
    speculative_prefetch=True,
)

CONFIGS = {"paper": PAPER, "cpu": CPU}
