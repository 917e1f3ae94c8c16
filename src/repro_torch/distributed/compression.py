"""int8 gradient compression with error feedback (cross-pod DP all-reduce).

Grads synchronised across a slow link are quantised to int8 with
per-block scales before the all-reduce and the quantisation residual is
fed back into the next step's gradient (error feedback keeps convergence
unbiased in practice).

PyTorch port of ``repro.distributed.compression``: plain functions on
tensors, trees as ``train.optim`` keeps them (dicts and lists).
``torch.round`` rounds half to even as ``jnp.round`` does, so the int8
codes match the reference's exactly.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map

BLOCK = 256


def _pad_to(x: torch.Tensor, m: int):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % m
    return torch.nn.functional.pad(flat, (0, pad)), pad


def quantize_int8(g: torch.Tensor):
    """returns (q int8, scales f32, pad) with per-BLOCK scaling."""
    flat, pad = _pad_to(g.to(torch.float32), BLOCK)
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale, pad


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, pad: int, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compress_decompress(g: torch.Tensor) -> torch.Tensor:
    """Quantise-dequantise round trip (what the wire sees)."""
    q, s, pad = quantize_int8(g)
    return dequantize_int8(q, s, pad, g.shape)


def compressed_grad_tree(grads, error_state):
    """Apply int8 EF compression leaf-wise.

    Returns (compressed grads to all-reduce, new error state).  The caller
    all-reduces the compressed values (the quantised representation is what
    crosses the link — 4x smaller than fp32).
    """
    if error_state is None:
        error_state = tree_map(torch.zeros_like, grads)
    sent = tree_map(lambda g, e: compress_decompress(g + e), grads,
                    error_state)
    err = tree_map(lambda g, e, s: (g + e) - s, grads, error_state, sent)
    return sent, err


def wire_bytes(grads) -> tuple[int, int]:
    """(fp32 bytes, int8+scale bytes) for the gradient tree."""
    leaves = tree_leaves(grads)
    raw = sum(a.numel() * 4 for a in leaves)
    comp = sum(a.numel() + (a.numel() // BLOCK + 1) * 4 for a in leaves)
    return raw, comp
