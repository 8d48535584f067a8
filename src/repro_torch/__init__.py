"""PyTorch/CUDA port of the dynamic load-balancing UQ stack.

Mirrors the module layout of the JAX package: ``swe`` (shallow-water
forward model and the Tōhoku scenario), ``core`` (GP surrogate, LHS,
MH/MLDA samplers, diagnostics), ``balancer`` and ``ensemble`` (the load
balancer and the multi-chain driver), ``configs`` and ``launch``.  The
TPU kernels of the reference are hand-written CUDA kernels for Hopper
under ``csrc/``, wrapped in ``kernels/<name>/ops.py`` beside their plain
PyTorch versions (``ref.py``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).
"""
