"""Latin hypercube sampling (paper §6.1: 512 LHS design points for the GP)."""
from __future__ import annotations

import torch


def latin_hypercube(generator: torch.Generator, n: int, d: int) -> torch.Tensor:
    """n points in [0, 1]^d, one per stratum per dimension (float32, on the
    generator's device)."""
    dev = generator.device
    perms = torch.stack(
        [torch.randperm(n, generator=generator, device=dev) for _ in range(d)], dim=1
    )  # (n, d) stratum indices
    jitter = torch.rand((n, d), generator=generator, device=dev)
    return (perms + jitter) / n


def scale_to_bounds(u: torch.Tensor, lo, hi) -> torch.Tensor:
    lo = torch.as_tensor(lo, dtype=u.dtype, device=u.device)
    hi = torch.as_tensor(hi, dtype=u.dtype, device=u.device)
    return lo + u * (hi - lo)
