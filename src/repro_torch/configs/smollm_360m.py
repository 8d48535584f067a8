"""smollm-360m — llama-architecture small model.  [hf:HuggingFaceTB/SmolLM; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    mlp="swiglu",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M",
)
