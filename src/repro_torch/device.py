"""Device resolution: the CUDA card by default, the CPU only on request.

There is no silent step down to the CPU.  A caller that wants the CPU
(the parity tests do) passes ``device="cpu"``; asking for ``"cuda"`` on a
machine without a card raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``device`` as a :class:`torch.device`; raise if it is absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device '{dev}' (use 'cuda' or 'cpu')")
    return dev
