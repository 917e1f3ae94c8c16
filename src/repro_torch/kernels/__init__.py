# Hand-written Hopper kernels of the port, one folder each beside the TPU
# kernel it replaces in ``repro.kernels``: ``ref.py`` (plain PyTorch, what
# the CPU runs) and ``ops.py`` (the wrapper: launches the CUDA kernel from
# ``repro_torch/csrc`` on a CUDA tensor, the plain version on a CPU tensor,
# and raises on anything else).  ``build.py`` compiles the kernels.
