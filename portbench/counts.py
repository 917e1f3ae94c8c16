"""The yardstick: the card's peaks, each kernel's bytes and the model's
operations, counted from a batch's real sizes and index sets.

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
                n_classes: int) -> float:
    """Operations of one training step of the 2-layer model on one batch:
    dense products over the rows whose output the loss needs, the
    aggregation over the valid sampled edges, the head over the seeds; the
    backward counted as twice the forward."""
    b = sizes["batch"]
    n1 = sizes["layer1_nodes"]
    e_l1 = sizes["hops"][1]["e_valid"]        # layer 1 aggregates hop 2
    e_l2 = sizes["hops"][0]["e_valid"]        # layer 2 aggregates hop 1
    if model == "sage":
        # self and neighbour products; a mean is one add an edge and entry
        # and one divide a destination and entry
        dense = 2 * (2 * n1 * d_in * hidden) + 2 * (2 * b * hidden * hidden)
        agg = (e_l1 * d_in + sizes["hops"][1]["dst_valid_distinct"] * d_in
               + e_l2 * hidden + sizes["hops"][0]["dst_valid_distinct"]
               * hidden)
    elif model == "gcn":
        # one product a layer; a normalised sum is a multiply and an add
        # an edge and entry
        dense = 2 * n1 * d_in * hidden + 2 * b * hidden * hidden
        agg = 2 * e_l1 * d_in + 2 * e_l2 * hidden
    else:
        raise ValueError(f"unknown model {model!r}")
    head = 2 * b * hidden * n_classes
    return 3.0 * (dense + agg + head)


def agg_calls(model: str, sizes: dict, d_in: int, hidden: int) -> list:
    """Every K2 and K3 launch of one training step, as ``(kernel, shape,
    bytes)``: the forward of both layers, and the backward of layer 2
    (layer 1's input, the gathered rows, takes no gradient).  ``shape`` is
    the launch as the step makes it, over the padded edges (K2: indices
    and width; K3: messages, width and output rows), which tells the
    launches apart.  ``bytes`` is what the batch needs: its valid edges
    alone, each distinct row they read once, and output rows only for the
    distinct valid vertices that the launch sums into."""
    n = sizes["n_pad"]
    calls = []

    def k2(hop, width, at):
        calls.append(("k2", (hop["e_pad"], width),
                      k2_bytes(hop["e_valid"], width, hop[at])))

    def k3(hop, width, at):
        calls.append(("k3", (hop["e_pad"], width, n),
                      k3_bytes(hop["e_valid"], width, hop[at])))

    src, dst = "src_valid_distinct", "dst_valid_distinct"
    # layer 1 aggregates the outer hop (blocks[1]), layer 2 the inner one
    for layer, (hop, width) in enumerate(((sizes["hops"][1], d_in),
                                          (sizes["hops"][0], hidden))):
        if model == "sage":
            k2(hop, width, src)             # h[src]
            k3(hop, width, dst)             # the sum at dst
            k3(hop, 1, dst)                 # the count at dst
        else:
            k3(hop, 1, dst)                 # the degrees at dst and src
            k3(hop, 1, src)
            k2(hop, 1, src)                 # each edge's two degrees
            k2(hop, 1, dst)
            k2(hop, width, src)             # h[src]
            k3(hop, width, dst)             # the normalised sum at dst
        if layer == 1:
            # the segment sum's backward gathers at dst (K2); the gather's
            # backward sums at src (K3)
            k2(hop, width, dst)
            k3(hop, width, src)
    return calls
