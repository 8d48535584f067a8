"""Configurations of the port: the Tōhoku MLDA presets and the LM zoo
(``--arch <id>``)."""
from __future__ import annotations

from typing import Dict

from .base import SHAPES, ArchConfig, MoEConfig, ShapeConfig, SSMConfig, arch_from_reference
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .mamba2_1_3b import CONFIG as mamba2_1_3b
from .phi4_mini_3_8b import CONFIG as phi4_mini_3_8b
from .qwen2_0_5b import CONFIG as qwen2_0_5b
from .smollm_360m import CONFIG as smollm_360m
from .tohoku_mlda import CONFIGS, CPU, PAPER, MLDAWorkloadConfig
from .zamba2_1_2b import CONFIG as zamba2_1_2b

# The architectures the port runs.
ARCHS: Dict[str, ArchConfig] = {
    c.arch_id: c
    for c in [qwen2_0_5b, smollm_360m, phi4_mini_3_8b, zamba2_1_2b, mamba2_1_3b,
              granite_moe_3b_a800m]
}
# The reference's other architectures, by family: not ported yet.
REFERENCE_ONLY: Dict[str, str] = {
    "nemotron-4-340b": "dense",
    "llava-next-mistral-7b": "vlm",
    "mixtral-8x22b": "moe",
    "whisper-large-v3": "encdec",
}


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id in REFERENCE_ONLY:
        raise NotImplementedError(
            f"arch '{arch_id}' (family '{REFERENCE_ONLY[arch_id]}') is not ported yet "
            f"(ROADMAP Queue 1 item 8); the port runs {sorted(ARCHS)}"
        )
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = [
    "ARCHS",
    "ArchConfig",
    "CONFIGS",
    "CPU",
    "MLDAWorkloadConfig",
    "MoEConfig",
    "PAPER",
    "REFERENCE_ONLY",
    "SHAPES",
    "SSMConfig",
    "ShapeConfig",
    "arch_from_reference",
    "get_arch",
]
