"""The dense decoder-only LM zoo of the port (plain PyTorch, per-layer
parameter dicts)."""
from .zoo import ModelBundle, build_model, input_specs, params_from_reference

__all__ = ["ModelBundle", "build_model", "input_specs", "params_from_reference"]
