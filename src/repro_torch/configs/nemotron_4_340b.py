"""nemotron-4-340b — GQA + squared-ReLU MLP.  [arXiv:2402.16819; unverified]

340B params: training requires 2D (TP x FSDP) parameter sharding and bf16
optimizer moments to fit 16 GB/chip on a single pod (runtime/sharding.py).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    mlp="sqrelu",
    rope_theta=10000.0,
    source="arXiv:2402.16819 (unverified)",
)
