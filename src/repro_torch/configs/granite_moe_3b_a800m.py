"""granite-moe-3b-a800m — 40-expert top-8 fine-grained MoE.

[hf:ibm-granite/granite-3.0-*-base; hf]  The assignment's explicit field
says ``MoE 40e top-8`` (its inline comment says 32e); we follow the field
(DESIGN.md §4).  d_ff=512 per expert.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    mlp="swiglu",
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
