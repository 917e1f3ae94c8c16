"""AdamW and Adafactor with their learning-rate schedules, on trees of
tensors.

PyTorch port of ``repro.train.optim``.  A tree is a dict or list of
tensors, as the GNN parameters are; a leaf may also be a ``Stacked``, the
slices of one of the reference's layer-stacked leaves, which the port's
LM keeps as one tensor per layer (``lm.param_tree`` gives the LM's
parameters in the reference's layout).  The optimizer state mirrors the
tree leaf for leaf in the reference's layout (a ``Stacked`` leaf's
moments are one stacked tensor), ``{"step", "m", "v"}`` for AdamW and
``{"step", "v"}`` of ``{"vr", "vc"}`` or ``{"v"}`` for Adafactor, so a
checkpoint of either package restores in the other.

``update_`` updates the parameters and the state in place (and clips
the gradients in place): at full LM width a second copy of the
parameters and moments would not fit (tens of GB).  AdamW's walks each
leaf in chunks of ``CHUNK`` elements, so its float32 temporaries stay
small.  ``update`` is the functional form the reference has (and the GNN
trainer uses): ``update_`` on copies.

This is not ``torch.optim.AdamW``: b2 defaults to 0.95, weight decay
(0.1) applies to every leaf, biases included, as ``u + wd * p`` inside
the step, gradients are first clipped to a global norm of 1.0 (with
``max(gn, 1e-9)`` in the denominator), and the bias corrections are
computed in float32.  Adafactor keeps no first moment and a factored
second moment (row and column means) for every leaf of two or more
dimensions; the reference's ``scan_stacked`` (a ``lax.scan`` over a
stack deeper than 8, an XLA memory device) is a loop over the stack here,
with the same arithmetic: each slice is clipped by its own RMS.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.tree import (Stacked, full, slices, tree_clone,
                                   tree_leaves, tree_map)

CHUNK = 1 << 24    # elements per chunk of AdamW's in-place update


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update_: Callable[[Any, Any, Any], tuple]  # (grads, state, params)
                                               # -> (params, state), in place
    name: str = "opt"

    def update(self, grads, state, params):
        """The functional form, as the reference's: ``update_`` on copies,
        so the inputs are left as they were."""
        return self.update_(tree_clone(grads), tree_clone(state),
                            tree_clone(params))


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
                          for leaf in tree_leaves(tree)
                          for a in slices(leaf)))


def clip_by_global_norm(grads, max_norm: float):
    """(clipped copy of ``grads``, the norm before the clip)."""
    grads = tree_clone(grads)
    return grads, clip_by_global_norm_(grads, max_norm)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns the norm before the clip."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for leaf in tree_leaves(grads):
        for g in slices(leaf):
            g.mul_(scale.to(g.dtype))
    return gn


def _zeros_like_leaf(p, dtype):
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _chunks(*ts):
    """Matching flat chunks of ``CHUNK`` elements of equally shaped
    contiguous tensors (the tensors whole where one is not contiguous, or
    is a ``DTensor``: a rank's shard cannot be flattened across the mesh,
    and it is a fraction of the leaf)."""
    if not all(t.is_contiguous() and not isinstance(t, DTensor)
               for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for a in range(0, flat[0].numel(), CHUNK):
        yield [f[a:a + CHUNK] for f in flat]


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          moment_dtype=torch.float32, max_grad_norm=1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_lr(lr)

    @torch.no_grad()
    def init(params):
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": tree_map(lambda p: _zeros_like_leaf(p, moment_dtype),
                              params),
                "v": tree_map(lambda p: _zeros_like_leaf(p, moment_dtype),
                              params)}

    def scalars(step):
        step32 = step.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32,
                               device=step.device) ** step32
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32,
                               device=step.device) ** step32
        return lr_fn(step), bc1, bc2

    def leaf(p, g, m, v, lr_t, bc1, bc2):
        g32 = g.to(torch.float32)
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g32
        v32 = v.to(torch.float32) * b2 + (1 - b2) * g32 * g32
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        u = u + weight_decay * p.to(torch.float32)
        return ((p.to(torch.float32) - lr_t * u).to(p.dtype),
                m32.to(moment_dtype), v32.to(moment_dtype))

    @torch.no_grad()
    def update_(grads, state, params):
        state["step"].add_(1)
        if max_grad_norm:
            clip_by_global_norm_(grads, max_grad_norm)
        sc = scalars(state["step"])

        def upd(p, g, m, v):
            for i, pi in enumerate(slices(p)):
                gi, mi, vi = ((g[i], m[i], v[i]) if isinstance(p, Stacked)
                              else (g, m, v))
                for pc, gc, mc, vc in _chunks(pi, gi, mi, vi):
                    new = leaf(pc, gc, mc, vc, *sc)
                    for dst, a in zip((pc, mc, vc), new):
                        dst.copy_(a)

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer(init, update_, "adamw")


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0, max_grad_norm=1.0,
              scan_stacked: bool = True) -> Optimizer:
    """Factored second moment (no first moment): O(n+m) state per (n, m)
    leaf.  ``scan_stacked``: a leaf of rank >= 3 whose leading axis is
    longer than 8 is updated slice by slice (the reference's ``lax.scan``
    over the stack), each slice clipped by its own RMS."""
    lr_fn = lr if callable(lr) else constant_lr(lr)

    @torch.no_grad()
    def init(params):
        def vstate(p):
            shape, dev = tuple(p.shape), p.device
            f32 = torch.float32
            if len(shape) >= 2:
                return {"vr": torch.zeros(shape[:-1], dtype=f32, device=dev),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=f32,
                                          device=dev)}
            return {"v": torch.zeros(shape, dtype=f32, device=dev)}
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "v": tree_map(vstate, params)}

    def leaf(p, g, v, lr_t, beta):
        g32 = g.to(torch.float32)
        g2 = g32 * g32 + eps
        if "vr" in v:
            vr = beta * v["vr"] + (1 - beta) * g2.mean(-1)
            vc = beta * v["vc"] + (1 - beta) * g2.mean(-2)
            denom = torch.sqrt(vr[..., None] * vc[..., None, :]
                               / torch.clamp(
                                   vr.mean(-1, keepdim=True)[..., None],
                                   min=eps))
            nv = {"vr": vr, "vc": vc}
        else:
            v2 = beta * v["v"] + (1 - beta) * g2
            denom = torch.sqrt(v2)
            nv = {"v": v2}
        u = g32 / torch.clamp(denom, min=eps)
        rms = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        if weight_decay:
            u = u + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr_t * u).to(p.dtype), nv

    def scalars(step):
        beta = 1.0 - (step.to(torch.float32) + 1.0) ** (-decay)
        return lr_fn(step), beta

    @torch.no_grad()
    def update_(grads, state, params):
        state["step"].add_(1)
        if max_grad_norm:
            clip_by_global_norm_(grads, max_grad_norm)
        sc = scalars(state["step"])

        def one(p, g, v):
            if scan_stacked and len(p.shape) >= 3 and p.shape[0] > 8 and \
                    set(v) == {"vr", "vc"}:
                # slice by slice, as the reference's scan over the stack
                parts = [(p[i], g[i], {k: v[k][i] for k in v})
                         for i in range(p.shape[0])]
            else:
                parts = [(p, full(g), v)]
            for pi, gi, vi in parts:
                new, nv = leaf(full(pi), gi, vi, *sc)
                for dst, a in zip(slices(pi), new.unbind(0)
                                  if isinstance(pi, Stacked) else [new]):
                    dst.copy_(a)
                for k, a in nv.items():
                    vi[k].copy_(a)

        tree_map(one, params, grads, state["v"])
        return params, state

    return Optimizer(init, update_, "adafactor")


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adamw_bf16":
        return adamw(moment_dtype=torch.bfloat16, **kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(name)

