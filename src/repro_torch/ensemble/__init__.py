"""Multi-chain ensemble subsystem (DESIGN.md §8).

One driver thread multiplexes N independent MLDA chains' step machines
(:class:`repro_torch.core.mlda.ChainState`) through a shared
:class:`repro_torch.balancer.LoadBalancer`: while one chain's fine solve is
on a server, the other chains' coarse subchains keep the rest of the pool
busy.

* :class:`EnsembleRunner` — drive N per-chain samplers (own proposal, RNG
  stream, LevelRecords) to completion; returns an :class:`EnsembleResult`
  with pooled cross-chain diagnostics;
* :class:`DeviceEnsembleRunner` — the ``device_resident=True`` mode: all
  chains advance in lockstep inside captured device programs
  (:class:`repro_torch.core.mlda_device.DeviceEnsemble`), surfacing to the
  balancer only for fine-level solves (DESIGN.md §9);
* :func:`repro_torch.core.mlda.balanced_mlda` with ``n_chains > 1`` or
  ``device_resident=True`` — builds the runner and the shared balancer in
  one call.
"""
from .runner import (
    DeviceChainStats,
    DeviceEnsembleRunner,
    EnsembleResult,
    EnsembleRunner,
)

__all__ = [
    "DeviceChainStats",
    "DeviceEnsembleRunner",
    "EnsembleResult",
    "EnsembleRunner",
]
