"""GraphSAGE with the mean aggregator (arXiv:1706.02216): a layer is
``relu(h @ w_self + mean_{src -> dst} h[src] @ w_neigh + b)``."""
from __future__ import annotations

import torch

from portbench import counts


def init_layer(dense, i, d_in, hidden):
    return {f"layers.{i}.w_self": dense(d_in, hidden),
            f"layers.{i}.w_neigh": dense(d_in, hidden),
            f"layers.{i}.b": torch.zeros(hidden)}


def layer(p, i, h, src, dst, n, mm):
    ones = torch.ones(len(src), dtype=h.dtype, device=h.device)
    s = torch.zeros((n, h.shape[1]), dtype=h.dtype,
                    device=h.device).index_add(0, dst, h[src])
    cnt = torch.zeros(n, dtype=h.dtype, device=h.device).index_add(0, dst,
                                                                   ones)
    nb = s / torch.clamp(cnt, min=1.0)[:, None]
    return torch.relu(mm(h, p[f"layers.{i}.w_self"])
                      + mm(nb, p[f"layers.{i}.w_neigh"])
                      + p[f"layers.{i}.b"])


def flops(sizes, d_in, hidden, n_classes):
    """Self and neighbour products over the rows whose output the loss
    needs; a mean is one add an edge and entry and one divide a
    destination and entry."""
    b, n1 = sizes["batch"], sizes["layer1_nodes"]
    h1, h2 = sizes["hops"][1], sizes["hops"][0]
    dense = 2 * (2 * n1 * d_in * hidden) + 2 * (2 * b * hidden * hidden)
    agg = (h1["e_valid"] * d_in + h1["dst_valid_distinct"] * d_in
           + h2["e_valid"] * hidden + h2["dst_valid_distinct"] * hidden)
    return dense + agg


def agg_calls(sizes, d_in, hidden):
    """The forward of both layers (h[src], the sum and the count at dst; layer 1
    aggregates the outer hop, ``hops[1]``, layer 2 the inner one) and the
    backward of layer 2 (layer 1's input, the gathered rows, takes no
    gradient)."""
    n = sizes["n_pad"]
    src, dst = "src_valid_distinct", "dst_valid_distinct"
    calls = []
    for i, (hop, width) in enumerate(((sizes["hops"][1], d_in),
                                      (sizes["hops"][0], hidden))):
        calls += [counts.k2_call(hop, width, src),       # h[src]
                  counts.k3_call(hop, width, n, dst),    # the sum at dst
                  counts.k3_call(hop, 1, n, dst)]        # the count at dst
        if i == 1:
            calls += counts.gather_sum_backward(hop, width, n)
    return calls
