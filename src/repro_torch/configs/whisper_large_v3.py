"""whisper-large-v3 — encoder-decoder; conv frontend stubbed.

[arXiv:2212.04356; unverified]  ``input_specs()`` provides precomputed
(B, n_frames, d_model) frame embeddings (the conv1d+GELU frontend is the
stub); 32 encoder + 32 decoder layers, MHA (kv=20).  Decode shapes use the
decoder's self-attn KV cache + a cross-attention cache over the encoder
output; the assigned 32k decoder length far exceeds Whisper's real 448
positions and is honoured as a stress configuration (DESIGN.md §4).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-large-v3",
    family="encdec",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    mlp="gelu",
    rope_theta=0.0,  # learned absolute positions in whisper; we use rope=off
    n_encoder_layers=32,
    n_frames=1500,
    source="arXiv:2212.04356 (unverified)",
)
