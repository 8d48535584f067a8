"""Synthetic training data of the port (no I/O)."""
from .pipeline import batch_for, microbatch, synthetic_lm_batch

__all__ = ["batch_for", "microbatch", "synthetic_lm_batch"]
