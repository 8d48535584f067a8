"""zamba2-1.2b — Mamba2 backbone + one shared attention block.

[arXiv:2411.15242; hf]  38 Mamba2 blocks at d_model=2048; a single *shared*
(parameter-tied) attention+MLP block is interleaved every 6 core blocks
(``shared_attn_every``), MHA kv=32 per the assignment.
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    mlp="gelu",
    ssm=SSMConfig(d_state=64),
    shared_attn_every=6,
    source="arXiv:2411.15242",
)
