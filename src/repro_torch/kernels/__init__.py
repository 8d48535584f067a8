"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each ``kernels/<name>/`` holds ``ref.py`` (the plain version, used for CPU
tensors and as the on-card yardstick) and ``ops.py`` (the wrapper: it
launches the kernel from ``csrc/<name>.cu`` for CUDA tensors and counts
its launches).  :mod:`repro_torch.kernels.build` compiles and loads the
sources.
"""
