"""AdamW and its learning-rate schedules, on trees of tensors.

PyTorch port of ``repro.train.optim`` (``adamw`` and the helpers it uses;
``adafactor`` comes with the LM train step).  A tree is a dict or list of
tensors, as the GNN parameters are; the optimizer state mirrors it leaf
for leaf, ``{"step", "m", "v"}``, so a checkpoint of either package
restores in the other.  ``update`` is functional, as the reference's is:
it returns new parameters and a new state and leaves its inputs as they
were.

This is not ``torch.optim.AdamW``: b2 defaults to 0.95, weight decay
(0.1) applies to every leaf, biases included, as ``u + wd * p`` inside
the step, gradients are first clipped to a global norm of 1.0 (with
``max(gn, 1e-9)`` in the denominator), and the bias corrections are
computed in float32.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (grads, state, params)
                                               # -> (params', state')
    name: str = "opt"


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of each
    tree in ``rest``), keeping the dict/list structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def constant_lr(v: float):
    return lambda step: torch.tensor(v, dtype=torch.float32,
                                     device=step.device)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        step = step.to(torch.float32)
        wu = peak * (step + 1.0) / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, wu, cos)
    return lr


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(a.to(torch.float32)))
                          for a in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          moment_dtype=torch.float32, max_grad_norm=1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_lr(lr)

    @torch.no_grad()
    def init(params):
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                                    device=p.device), params),
                "v": tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                                    device=p.device), params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        if max_grad_norm:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        lr_t = lr_fn(step)
        step32 = step.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32,
                               device=step.device) ** step32
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32,
                               device=step.device) ** step32

        def upd(p, g, m, v):
            g32 = g.to(torch.float32)
            m32 = m.to(torch.float32) * b1 + (1 - b1) * g32
            v32 = v.to(torch.float32) * b2 + (1 - b2) * g32 * g32
            u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            u = u + weight_decay * p.to(torch.float32)
            return ((p.to(torch.float32) - lr_t * u).to(p.dtype),
                    m32.to(moment_dtype), v32.to(moment_dtype))

        out = tree_map(upd, params, grads, state["m"], state["v"])
        return _pick(out, 0), {"step": step, "m": _pick(out, 1),
                               "v": _pick(out, 2)}

    return Optimizer(init, update, "adamw")


def _pick(tree, k):
    """Element ``k`` of every (param, m, v) leaf tuple in ``tree``."""
    if isinstance(tree, dict):
        return {n: _pick(v, k) for n, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, k) for v in tree]
    return tree[k]
