"""Multi-chain ensemble subsystem (DESIGN.md §8).

One driver thread multiplexes N independent MLDA chains' step machines
(:class:`repro_torch.core.mlda.ChainState`) through a shared
:class:`repro_torch.balancer.LoadBalancer`: while one chain's fine solve is
on a server, the other chains' coarse subchains keep the rest of the pool
busy.

* :class:`EnsembleRunner` — drive N per-chain samplers (own proposal, RNG
  stream, LevelRecords) to completion; returns an :class:`EnsembleResult`
  with pooled cross-chain diagnostics;
* :class:`DeviceEnsembleRunner` — the device-resident mode, not ported yet
  (raises :class:`NotImplementedError`).
"""
from .runner import DeviceEnsembleRunner, EnsembleResult, EnsembleRunner

__all__ = ["DeviceEnsembleRunner", "EnsembleResult", "EnsembleRunner"]
