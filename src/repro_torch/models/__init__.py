"""The LM zoo of the port: the dense, MoE, SSM, hybrid and VLM decoder
families and the encoder-decoder (plain PyTorch, per-layer parameter
dicts)."""
from .zoo import (
    ModelBundle,
    build_model,
    input_specs,
    paged_state_from_reference,
    params_from_reference,
)

__all__ = ["ModelBundle", "build_model", "input_specs", "paged_state_from_reference",
           "params_from_reference"]
