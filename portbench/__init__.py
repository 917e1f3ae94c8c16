"""The benchmark of the PyTorch and CUDA port (``repro_torch``): see
``run.py`` for the command and ``BENCHMARK.json`` at the root for the
cells and metrics."""
from __future__ import annotations

import functools
import importlib.util
import os


@functools.lru_cache(maxsize=None)
def load_file(path: str):
    """The module in the file ``path`` (a reader under ``metrics/``, a
    model under ``models/``), loaded once a process."""
    stem = os.path.splitext(os.path.basename(path))[0]
    kind = os.path.basename(os.path.dirname(path))
    name = f"portbench_{kind}_{stem}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
