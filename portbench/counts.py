"""The yardstick: the card's peaks, each kernel's bytes and the model's
operations, counted from a batch's real sizes and index sets.  What is
particular to a model is in ``models/<model>.py``.

The peaks and the byte counts are copies of ``chip_smoke.py``'s, so that a
later change to the program or to that script cannot move them:

- ``HBM_BYTES_S``, ``F32_OPS_S``, ``BF16_OPS_S``: NVIDIA's data sheet for
  the H100 SXM (dense), as ``repro_torch/launch/roofline.py``'s
  ``load_rates`` gives them to ``chip_smoke.py:402-407``;
  ``PCIE_BYTES_S`` is ``chip_smoke.py:407``.
- ``k2_bytes``: ``chip_smoke.py:709-731`` (``k2_entry``): the indices and
  the output once, and each distinct row the indices name once.
- ``k3_bytes``: ``chip_smoke.py:733-761`` (``k3_entry``): the messages and
  ids once, and the float32 output once.  ``agg_calls`` gives it only the
  output rows that a valid message reaches: zeroing the others is work
  that the inputs do not need.
- ``k1_bound_s``: ``chip_smoke.py:764-790`` (``k1_entry``): HBM bytes, or
  the host-tier rows over PCIe, whichever takes longer.
"""
from __future__ import annotations

import numpy as np

from portbench import models

HBM_BYTES_S = 3.35e12      # HBM3, 80 GB
PCIE_BYTES_S = 64e9        # PCIe Gen5 x16, one direction
F32_OPS_S = 67e12          # float32 outside the tensor cores (TF32 is off)
BF16_OPS_S = 989e12        # dense bf16 on the tensor cores

IDX_BYTES = 4              # the step's block indices are int32
F32 = 4


def k2_bytes(n_idx: int, width: int, n_distinct: int) -> int:
    """Row gather ``table[idx]`` of float32 rows ``width`` wide."""
    rb = width * F32
    return n_idx * (IDX_BYTES + rb) + n_distinct * rb


def k3_bytes(n_msgs: int, width: int, n_segments: int) -> int:
    """Segment sum of (n_msgs, width) float32 into (n_segments, width)."""
    return n_msgs * width * F32 + n_msgs * IDX_BYTES + n_segments * width * F32


def k1_bound_s(n_ids: int, n_device: int, n_host: int, row_bytes: int,
               id_bytes: int = IDX_BYTES) -> float:
    """Least time of one fused cache lookup of ``n_ids`` ids, of which
    ``n_device`` lie in the device tier and ``n_host`` in the host tier."""
    hbm = n_ids * (id_bytes + 8 + row_bytes + 5 * 4) + n_device * row_bytes
    return max(hbm / HBM_BYTES_S, n_host * row_bytes / PCIE_BYTES_S)


def _distinct(pos: np.ndarray, n: int) -> int:
    return int(np.count_nonzero(np.bincount(pos, minlength=n)))


def batch_sizes(blocks, node_mask: np.ndarray, batch_size: int) -> dict:
    """The sizes a batch's counts need, from its padded blocks
    (outer hop first, as ``MiniBatch.blocks``: ``(src_pos, dst_pos,
    edge_mask)`` numpy arrays) and its node mask."""
    n_pad = len(node_mask)
    hops = []
    for src, dst, em in blocks:
        hops.append({
            "e_pad": len(src),
            "e_valid": int(np.count_nonzero(em)),
            "src_valid_distinct": _distinct(src[em], n_pad),
            "dst_valid_distinct": _distinct(dst[em], n_pad),
        })
    # layer 1's outputs the loss needs: the seeds and their hop-1 neighbours
    src0, _, em0 = blocks[0]
    need = np.zeros(n_pad, bool)
    need[:batch_size] = True
    need[src0[em0]] = True
    return {"n_pad": n_pad, "n_real": int(np.count_nonzero(node_mask)),
            "batch": batch_size, "layer1_nodes": int(np.count_nonzero(need)),
            "hops": hops}


def model_flops(model: str, sizes: dict, d_in: int, hidden: int,
                n_classes: int, **args) -> float:
    """Operations of one training step of the 2-layer model on one batch:
    its layers' forward (``models/<model>.py``'s ``flops``: dense products
    over the rows whose output the loss needs, the aggregation over the
    valid sampled edges), the head over the seeds; the backward counted as
    twice the forward."""
    layers = models.load(model).flops(sizes, d_in, hidden, n_classes, **args)
    head = 2 * sizes["batch"] * hidden * n_classes
    return 3.0 * (layers + head)


def k2_call(hop: dict, width: int, at: str) -> tuple:
    """A K2 launch over a hop's padded edges, ``width`` wide, that reads
    the rows of the hop's distinct valid ``at`` vertices
    (``"src_valid_distinct"`` or ``"dst_valid_distinct"``)."""
    return ("k2", (hop["e_pad"], width),
            k2_bytes(hop["e_valid"], width, hop[at]))


def k3_call(hop: dict, width: int, n_out: int, at: str) -> tuple:
    """A K3 launch of a hop's padded edges, ``width`` wide, into ``n_out``
    rows, of which the valid edges reach the hop's distinct ``at``."""
    return ("k3", (hop["e_pad"], width, n_out),
            k3_bytes(hop["e_valid"], width, hop[at]))


def gather_sum_backward(hop: dict, width: int, n_out: int) -> list:
    """The backward of ``h[src]`` summed at ``dst``: the sum's backward
    gathers at dst (K2), the gather's backward sums at src (K3)."""
    return [k2_call(hop, width, "dst_valid_distinct"),
            k3_call(hop, width, n_out, "src_valid_distinct")]


def agg_calls(model: str, sizes: dict, d_in: int, hidden: int,
              **args) -> list:
    """Every K2 and K3 launch of one training step, as ``(kernel, shape,
    bytes)`` (``models/<model>.py``'s ``agg_calls``).  ``shape`` is the
    launch as the step makes it, over the padded edges (K2: indices and
    width; K3: messages, width and output rows), which tells the launches
    apart.  ``bytes`` is what the batch needs: its valid edges alone, each
    distinct row they read once, and output rows only for the distinct
    valid vertices that the launch sums into."""
    return models.load(model).agg_calls(sizes, d_in, hidden, **args)
