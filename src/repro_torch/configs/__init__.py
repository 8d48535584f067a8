"""Configurations of the port: the Tōhoku MLDA presets and the LM zoo
(``--arch <id>``)."""
from __future__ import annotations

from typing import Dict

from .base import (
    SHAPES,
    ArchConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    arch_from_reference,
    shape_applicable,
)
from .granite_4_0_h_small import CONFIG as granite_4_0_h_small
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .llava_next_mistral_7b import CONFIG as llava_next_mistral_7b
from .mamba2_1_3b import CONFIG as mamba2_1_3b
from .mixtral_8x22b import CONFIG as mixtral_8x22b
from .nemotron_4_340b import CONFIG as nemotron_4_340b
from .phi4_mini_3_8b import CONFIG as phi4_mini_3_8b
from .qwen2_0_5b import CONFIG as qwen2_0_5b
from .smollm_360m import CONFIG as smollm_360m
from .tohoku_mlda import CONFIGS, CPU, PAPER, MLDAWorkloadConfig
from .whisper_large_v3 import CONFIG as whisper_large_v3
from .zamba2_1_2b import CONFIG as zamba2_1_2b

# Every architecture of the reference, then the port's own.
ARCHS: Dict[str, ArchConfig] = {
    c.arch_id: c
    for c in [qwen2_0_5b, smollm_360m, phi4_mini_3_8b, nemotron_4_340b,
              llava_next_mistral_7b, mixtral_8x22b, granite_moe_3b_a800m, zamba2_1_2b,
              mamba2_1_3b, whisper_large_v3, granite_4_0_h_small]
}
# The architectures the reference (``repro.configs``) does not have.
PORT_ONLY_ARCHS = ("granite-4.0-h-small",)


def get_arch(arch_id: str) -> ArchConfig:
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
    "PORT_ONLY_ARCHS",
    "SHAPES",
    "SSMConfig",
    "ShapeConfig",
    "arch_from_reference",
    "get_arch",
    "shape_applicable",
]
