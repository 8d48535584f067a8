"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf]  SWA (window 4096) makes ``long_500k`` decodable
with a window-capped KV cache (DESIGN.md §4).
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    mlp="swiglu",
    rope_theta=1e6,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384),
    source="arXiv:2401.04088",
)
