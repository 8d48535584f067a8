"""Workload configurations of the port (the Tōhoku MLDA presets)."""
from .tohoku_mlda import CONFIGS, CPU, PAPER, MLDAWorkloadConfig

__all__ = ["CONFIGS", "CPU", "PAPER", "MLDAWorkloadConfig"]
