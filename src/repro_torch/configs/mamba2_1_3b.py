"""mamba2-1.3b — attention-free SSD (state-space duality).  [arXiv:2405.21060]"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=0,  # no MLP blocks; Mamba2 blocks carry the capacity
    vocab=50280,
    ssm=SSMConfig(d_state=128),
    source="arXiv:2405.21060 (unverified)",
)
