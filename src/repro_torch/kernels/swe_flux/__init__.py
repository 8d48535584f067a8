"""Well-balanced SWE flux kernels: fused batched step and directional sweep."""
