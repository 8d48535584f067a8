"""The LM zoo of the port: the dense, MoE, SSM, hybrid and VLM decoder
families and the encoder-decoder (plain PyTorch, per-layer parameter
dicts)."""
from .zoo import (
    ModelBundle,
    abstract_decode_state,
    abstract_inputs,
    abstract_params,
    build_model,
    input_specs,
    paged_state_from_reference,
    params_from_reference,
)

__all__ = ["ModelBundle", "abstract_decode_state", "abstract_inputs", "abstract_params",
           "build_model", "input_specs", "paged_state_from_reference",
           "params_from_reference"]
