"""qwen2-0.5b — GQA (kv=2) with QKV bias.  [arXiv:2407.10671; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1e6,
    tie_embeddings=True,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-0.5B",
)
