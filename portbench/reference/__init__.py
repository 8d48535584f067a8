"""Plain references the benchmark judges the program's outputs against.

Plain PyTorch only: nothing here imports JAX, the JAX package or the port.
``tohoku`` is a frozen copy of the shallow-water model, the Tōhoku scenario
and the GP surrogate in any floating dtype; ``lm`` is a plain forward of
the served decoder-only MoE model.
"""
