"""Configurations of the port: the Tōhoku MLDA presets and the dense LM zoo
(``--arch <id>``)."""
from __future__ import annotations

from typing import Dict

from .base import SHAPES, ArchConfig, ShapeConfig, arch_from_reference
from .qwen2_0_5b import CONFIG as qwen2_0_5b
from .smollm_360m import CONFIG as smollm_360m
from .tohoku_mlda import CONFIGS, CPU, PAPER, MLDAWorkloadConfig

# The dense architectures the port runs.
ARCHS: Dict[str, ArchConfig] = {c.arch_id: c for c in [qwen2_0_5b, smollm_360m]}
# The reference's other architectures, by family: not ported yet.
REFERENCE_ONLY: Dict[str, str] = {
    "phi4-mini-3.8b": "dense",
    "nemotron-4-340b": "dense",
    "llava-next-mistral-7b": "vlm",
    "zamba2-1.2b": "hybrid",
    "mamba2-1.3b": "ssm",
    "mixtral-8x22b": "moe",
    "granite-moe-3b-a800m": "moe",
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
    "PAPER",
    "REFERENCE_ONLY",
    "SHAPES",
    "ShapeConfig",
    "arch_from_reference",
    "get_arch",
]
