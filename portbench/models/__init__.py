"""The models the benchmark checks, one file a model, found by name.

``models/<model>.py`` (``<model>`` is the configuration's ``"model"``)
holds one architecture's layer in plain torch and its counts:

- ``init_layer(dense, i, d_in, hidden, **args)``: layer ``i``'s leaves,
  ``{"layers.<i>.<leaf>": tensor}`` in the order they are drawn, each
  weight through the shared ``dense(d_in, d_out)``;
- ``layer(p, i, h, src, dst, n, mm, **args)``: layer ``i`` of the forward
  over the valid edges ``(src, dst)`` of ``n`` node positions, its
  activation included, every dense product through ``mm(a, b)``;
- ``flops(sizes, d_in, hidden, n_classes, **args)``: the forward
  operations of its layers on one batch (``counts.batch_sizes``);
- ``agg_calls(sizes, d_in, hidden, **args)``: every K2 and K3 launch of
  one training step, as ``counts.agg_calls`` gives them.

``args`` is the configuration's ``"model_args"``.  The head, the loss and
the optimizer are the same for every model (``reference.py``, ``counts.py``).
"""
from __future__ import annotations

import os

from portbench import load_file

DIR = os.path.dirname(os.path.abspath(__file__))


def load(name: str):
    """The module ``models/<name>.py``; a ``KeyError`` that names the
    missing file where there is none."""
    path = os.path.join(DIR, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no model {name!r}: {path} does not exist")
    return load_file(path)
