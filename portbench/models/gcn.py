"""GCN (arXiv:1609.02907) on sampled blocks: a layer is
``relu(sum_{src -> dst} h[src] / sqrt(deg(src) deg(dst)) @ w + b)``, the
degrees counted over the block's valid edges."""
from __future__ import annotations

import torch

from portbench import counts


def init_layer(dense, i, d_in, hidden):
    return {f"layers.{i}.w": dense(d_in, hidden),
            f"layers.{i}.b": torch.zeros(hidden)}


def layer(p, i, h, src, dst, n, mm):
    ones = torch.ones(len(src), dtype=h.dtype, device=h.device)
    zeros = torch.zeros(n, dtype=h.dtype, device=h.device)
    deg_dst = zeros.index_add(0, dst, ones)
    deg_src = zeros.index_add(0, src, ones)
    norm = (torch.rsqrt(torch.clamp(deg_src[src], min=1.0))
            * torch.rsqrt(torch.clamp(deg_dst[dst], min=1.0)))
    nb = torch.zeros((n, h.shape[1]), dtype=h.dtype,
                     device=h.device).index_add(0, dst, h[src] * norm[:, None])
    return torch.relu(mm(nb, p[f"layers.{i}.w"]) + p[f"layers.{i}.b"])


def flops(sizes, d_in, hidden, n_classes):
    """One product a layer over the rows whose output the loss needs; a
    normalised sum is a multiply and an add an edge and entry."""
    b, n1 = sizes["batch"], sizes["layer1_nodes"]
    dense = 2 * n1 * d_in * hidden + 2 * b * hidden * hidden
    agg = (2 * sizes["hops"][1]["e_valid"] * d_in
           + 2 * sizes["hops"][0]["e_valid"] * hidden)
    return dense + agg


def agg_calls(sizes, d_in, hidden):
    """The forward of both layers (the degrees, h[src] and the normalised sum; layer 1
    aggregates the outer hop, ``hops[1]``, layer 2 the inner one) and the
    backward of layer 2 (layer 1's input, the gathered rows, takes no
    gradient)."""
    n = sizes["n_pad"]
    src, dst = "src_valid_distinct", "dst_valid_distinct"
    calls = []
    for i, (hop, width) in enumerate(((sizes["hops"][1], d_in),
                                      (sizes["hops"][0], hidden))):
        calls += [counts.k3_call(hop, 1, n, dst),        # the degrees
                  counts.k3_call(hop, 1, n, src),
                  counts.k2_call(hop, 1, src),           # each edge's two
                  counts.k2_call(hop, 1, dst),           # degrees
                  counts.k2_call(hop, width, src),       # h[src]
                  counts.k3_call(hop, width, n, dst)]    # the normalised sum
        if i == 1:
            calls += counts.gather_sum_backward(hop, width, n)
    return calls
