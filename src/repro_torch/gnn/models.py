"""GraphSAGE [Hamilton+17] and GCN [Kipf&Welling16] on padded sampled blocks.

PyTorch port of ``repro.gnn.models``: the forward, the serving step and
the train step.  Message passing gathers with the K2 row-gather kernel
(``h[src_pos]``) and aggregates with the K3 segment-sum kernel, which take
a card's tensors to the CUDA kernels and a CPU's to their plain versions.
The train step is eager autograd: K3 is the gather's backward and K2 the
segment sum's (see their wrappers).  The dense products ``h @ W`` stay
``torch.matmul``, as the reference leaves them to XLA.  Parameters are a
plain dict in the reference's pytree layout, weights ``(d_in, d_out)`` so
that ``h @ w``.

TF32 is off for float32 products and convolutions on the card (set here,
for the whole process), so logits match the CPU and the reference within
float32 rounding.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels.gather.ops import gather_rows
from repro_torch.kernels.segment_agg.ops import segment_sum
from repro_torch.core.tree import tree_map

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _dense_init(gen, shape, dtype, fan_in, device):
    """N(0, 1/fan_in) weights (the reference's ``dense_init`` scale)."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32)
    return (w / math.sqrt(max(fan_in, 1))).to(device=device, dtype=dtype)


def init_gnn_params(generator: torch.Generator, model: str, in_dim: int,
                    hidden: int, n_classes: int, n_layers: int = 2,
                    dtype=torch.float32, device="cuda"):
    """Random parameters drawn from a CPU ``generator``, placed on
    ``device``.  Same layout as the reference; not the same numbers (a
    ``torch.Generator`` is not ``jax.random``) — load the reference's with
    ``params_from_numpy`` to compare the two."""
    dev = resolve_device(device)
    layers = []
    for i in range(n_layers):
        d_in = in_dim if i == 0 else hidden
        if model == "sage":
            layers.append({
                "w_self": _dense_init(generator, (d_in, hidden), dtype, d_in,
                                      dev),
                "w_neigh": _dense_init(generator, (d_in, hidden), dtype,
                                       d_in, dev),
                "b": torch.zeros(hidden, dtype=dtype, device=dev),
            })
        else:  # gcn
            layers.append({
                "w": _dense_init(generator, (d_in, hidden), dtype, d_in, dev),
                "b": torch.zeros(hidden, dtype=dtype, device=dev),
            })
    head = {"w": _dense_init(generator, (hidden, n_classes), dtype, hidden,
                             dev),
            "b": torch.zeros(n_classes, dtype=dtype, device=dev)}
    return {"layers": layers, "head": head}


def params_from_numpy(tree, device="cuda"):
    """The reference's parameter pytree, with numpy arrays as leaves
    (``jax.tree.map(np.asarray, params)``), as the port's parameters on
    ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dev) for v in tree]
    return torch.from_numpy(np.array(tree)).to(dev)


def _agg_mean(h, src_pos, dst_pos, edge_mask, n_nodes, n_out):
    """Mean aggregation: for each dst, mean of h[src] over valid edges.
    The sums fill all ``n_nodes`` rows; rows ``[0, n_out)`` are returned."""
    w = edge_mask.to(h.dtype)
    msg = gather_rows(h, src_pos) * w[:, None]
    summed = segment_sum(msg, dst_pos, n_nodes)[:n_out]
    cnt = segment_sum(w[:, None].contiguous(), dst_pos, n_nodes)[:n_out, 0]
    return summed / torch.clamp(cnt, min=1.0)[:, None]


def _agg_gcn(h, src_pos, dst_pos, edge_mask, n_nodes, n_out):
    """Symmetric-normalised sum (degrees from the sampled block), rows
    ``[0, n_out)`` of the ``n_nodes`` summed."""
    w = edge_mask.to(h.dtype)
    w1 = w[:, None].contiguous()
    deg_dst = segment_sum(w1, dst_pos, n_nodes)
    deg_src = segment_sum(w1, src_pos, n_nodes)
    norm = torch.rsqrt(torch.clamp(gather_rows(deg_src, src_pos)[:, 0],
                                   min=1.0)) * \
        torch.rsqrt(torch.clamp(gather_rows(deg_dst, dst_pos)[:, 0], min=1.0))
    msg = gather_rows(h, src_pos) * (w * norm)[:, None]
    return segment_sum(msg, dst_pos, n_nodes)[:n_out]


def gnn_forward(params, feats, blocks, model: str, n_out: int | None = None):
    """feats: (N_pad, F); blocks: list of (src_pos, dst_pos, edge_mask)
    outer-hop-first.  Applied inner-hop-first (reversed).  Returns the last
    hidden layer, (N_pad, hidden); with ``n_out``, its rows ``[0, n_out)``
    alone: the last layer's products, bias and ReLU then run on those rows
    only, after an aggregation that still sums into all N_pad rows (the
    same K2/K3 calls either way).  Earlier layers are dense: the next
    layer reads every row."""
    h = feats
    n_nodes = feats.shape[0]
    layer_blocks = list(reversed(blocks))
    last = len(params["layers"]) - 1
    for i, (lp, blk) in enumerate(zip(params["layers"], layer_blocks)):
        src_pos, dst_pos, edge_mask = blk
        # h[:n_nodes] is h itself (a full slice adds no op)
        rows = n_nodes if n_out is None or i < last else n_out
        if model == "sage":
            nb = _agg_mean(h, src_pos, dst_pos, edge_mask, n_nodes, rows)
            h = h[:rows] @ lp["w_self"] + nb @ lp["w_neigh"] + lp["b"]
        else:
            nb = _agg_gcn(h, src_pos, dst_pos, edge_mask, n_nodes, rows)
            h = nb @ lp["w"] + lp["b"]
        h = torch.relu(h)
    return h


def make_gnn_infer_step(model: str, batch_size: int):
    """Forward-only step for serving: params + padded blocks -> float32
    logits for the first ``batch_size`` nodes (the seeds).  No optimizer
    state, no gradients.  Tensors are used on the device they lie on."""
    @torch.inference_mode()
    def step(params, feats, src, dst, emask):
        blocks = [(s, d, m) for s, d, m in zip(src, dst, emask)]
        h = gnn_forward(params, feats, blocks, model, n_out=batch_size)
        logits = h @ params["head"]["w"] + params["head"]["b"]
        return logits.to(torch.float32)
    return step


def gnn_loss(params, feats, blocks, labels, batch_size: int, model: str):
    """Mean cross-entropy of the seeds' float32 logits, and accuracy."""
    h = gnn_forward(params, feats, blocks, model, n_out=batch_size)
    logits = h @ params["head"]["w"] + params["head"]["b"]
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    loss = torch.mean(lse - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, acc


def make_gnn_train_step(model: str, optimizer, batch_size: int,
                        embedding_grads: bool = False):
    """Training step: loss, gradients by autograd, one optimizer update.
    ``step(state, feats, src, dst, emask, labels)`` returns ``(state',
    {"loss", "acc"})`` with 0-d tensors; with ``embedding_grads=True`` it
    also differentiates w.r.t. the INPUT features and returns dL/dfeats,
    ``(N_pad, F)``, as a third output — the trainer's write path applies
    it to the trainable embedding rows.  Only the seeds' logits enter the
    loss, so the padding rows get zero gradients.  The last layer's
    products, forward and backward, run on the ``batch_size`` seed rows
    alone (``gnn_forward``'s ``n_out``); the earlier layers, and every K2
    and K3 call, still run over all ``N_pad`` rows, as the reference's
    do."""
    def step(state, feats, src, dst, emask, labels):
        blocks = [(s, d, m) for s, d, m in zip(src, dst, emask)]
        params = state["params"]
        leaves = []

        def leaf(t):
            t = t.detach().requires_grad_(True)
            leaves.append(t)
            return t
        with torch.enable_grad():
            p = tree_map(leaf, params)
            f = feats.detach().requires_grad_(embedding_grads)
            loss, acc = gnn_loss(p, f, blocks, labels, batch_size, model)
            grads = torch.autograd.grad(
                loss, leaves + ([f] if embedding_grads else []))
        it = iter(grads)
        pgrads = tree_map(lambda _: next(it), params)
        new_p, new_opt = optimizer.update(pgrads, state["opt"], params)
        metrics = {"loss": loss.detach(), "acc": acc}
        if embedding_grads:
            return {"params": new_p, "opt": new_opt}, metrics, next(it)
        return {"params": new_p, "opt": new_opt}, metrics
    return step
