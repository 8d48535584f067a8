"""llava-next-mistral-7b — Mistral-7B backbone + anyres patch stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  The vision tower/anyres
tiling is a STUB: ``input_specs()`` provides precomputed patch embeddings
(B, n_patches, d_vision); a trainable 2-layer projector maps them into the
LM stream (DESIGN.md §4).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    mlp="swiglu",
    rope_theta=1e6,
    n_patches=2880,  # anyres: 5 tiles x 576 patches (24x24 @ patch 14)
    d_vision=1024,  # CLIP ViT-L/14 feature width
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (unverified)",
)
