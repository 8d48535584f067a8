"""granite-4.0-h-small — Mamba2 mixers and NoPE attention, each followed by
a 72-expert top-10 MoE with a shared expert.

[hf:ibm-granite/granite-4.0-h-small config.json]  40 layers: Mamba2 mixers
(128 heads of 64, state 128, one group, conv 4 with a bias, chunk 256) and
grouped-query attention without position embeddings at layers 5, 15, 25
and 35 (32 query and 8 KV heads of 128).  Every layer's FFN is 72 SwiGLU
experts of 768, top-10 renormalised by a softmax, plus a shared SwiGLU
expert of 1,536.  Granite's multipliers: embedding x12, attention scores
x1/128, residual branches x0.22, logits /16.  d 4,096, vocabulary 100,352,
tied head: 3.22e10 parameters, 8.8e9 active a token.
"""
from .base import ArchConfig, MoEConfig, SSMConfig

ATTENTION_LAYERS = (5, 15, 25, 35)

CONFIG = ArchConfig(
    arch_id="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab=100352,
    mlp="swiglu",
    rope_theta=0.0,  # NoPE
    tie_embeddings=True,
    norm_eps=1e-5,
    # capacity E / k: a sequence's pairs never overflow an expert (the
    # published model drops none).
    moe=MoEConfig(n_experts=72, top_k=10, d_ff=768, capacity_factor=7.2, shared_d_ff=1536),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, d_conv=4, chunk=256),
    layer_types=tuple("attention" if i in ATTENTION_LAYERS else "mamba" for i in range(40)),
    embedding_multiplier=12.0,
    attention_multiplier=1.0 / 128,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    source="https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json",
)
