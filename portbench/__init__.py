"""The benchmark of the PyTorch and CUDA port (``repro_torch``): see
``run.py`` for the command and ``BENCHMARK.json`` at the root for the
cells and metrics."""
