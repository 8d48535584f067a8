"""One module for each ``model_type`` of a served configuration file,
``archs/<model_type>.py``, found by path (``harness.cells.load_arch``), so
that a new architecture is new files.  Each gives:

- ``arch_config(c)``: the program's ``ArchConfig`` for configuration ``c``;
- ``leaf_specs(c)``: (path, shape, dtype name, scale) of every weight, in
  the order ``harness.weights.make_weights`` draws them;
- ``program_tree(w)``: the same tensors under the program's leaf names,
  with no copies;
- ``Reference(weights, cfg, *, dtype, quant)``: the plain forward,
  ``logits(tokens)`` -> (S, V), with the ``quant="fp8"`` control; plain
  PyTorch that imports nothing of the program;
- ``prompt_flops(c, n)`` and ``decode_token_flops(c, position)``: the
  model FLOPs the whole-step MFU counts.
"""
