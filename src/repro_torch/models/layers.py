"""Shared neural-net building blocks of the LM path (PyTorch port of
``repro.models.layers``).

Parameters live in ``nn.Module``s whose attribute names are the reference
pytree's keys (``scale``, ``bias``, ``w_gate``, ...), so a reference pytree
loads by name (``models/lm.py::params_from_numpy``).  A module's
constructor only allocates its parameters; ``reset_parameters(generator)``
draws them as the reference's initializers do, from an explicit
``torch.Generator`` (not the same numbers as ``jax.random``).  The
functions take those modules where the reference takes dicts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised, frozen parameter (serving takes no gradients)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


DRAW_CHUNK = 1 << 28    # float32 elements drawn at once: 1 GiB


def normal_(t: torch.Tensor, gen: torch.Generator, stddev: float):
    """Fill ``t`` with N(0, stddev^2) drawn in float32 on the generator's
    device, then cast (the reference's ``_normal``).  A tensor of more than
    ``DRAW_CHUNK`` elements is drawn in slices along its first axis, so the
    float32 draw beside it stays near 1 GiB (kimi-k2's stacked experts
    are 21 GiB in float32)."""
    parts = [t]
    if t.numel() > DRAW_CHUNK and t.dim() > 1:
        parts = t.split(max(1, DRAW_CHUNK // (t.numel() // t.shape[0])))
    for part in parts:
        w = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        part.copy_(w.mul_(stddev))


def dense_init_(t: torch.Tensor, gen: torch.Generator,
                fan_in: int | None = None):
    """1/sqrt(fan_in) normal init (the reference's ``dense_init``)."""
    fan_in = (fan_in if fan_in is not None
              else t.shape[-2] if t.dim() >= 2 else t.shape[-1])
    normal_(t, gen, 1.0 / math.sqrt(max(fan_in, 1)))


def embed_init_(t: torch.Tensor, gen: torch.Generator):
    normal_(t, gen, 0.02)


@torch.no_grad()
def draw_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw a model's parameters as the reference's initializers do: its
    ``embed`` and ``unembed`` normal 0.02, then every submodule's
    ``reset_parameters(gen)``, in module order."""
    embed_init_(model.embed, gen)
    embed_init_(model.unembed, gen)
    for mod in model.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)
    return model


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float()) + bias.float()).to(dt)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``), both applied
    as ``1 + scale`` and initialised to zeros, in float32."""

    def __init__(self, d: int, kind: str, device=None):
        super().__init__()
        self.scale = param((d,), torch.float32, device)
        if kind != "rmsnorm":
            self.bias = param((d,), torch.float32, device)

    def reset_parameters(self, gen: torch.Generator):
        del gen
        for p in self.parameters():
            p.zero_()


def apply_norm(x, p: Norm, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, p.scale)
    return layernorm(x, p.scale, p.bias)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Rotates
    the two halves of the head (not interleaved pairs), in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``w_gate`` (gated activations only), ``w_up``, ``w_down`` and, with
    ``bias``, ``b_up``/``b_down``; weights ``(d_in, d_out)`` so ``x @ w``."""

    def __init__(self, d_model: int, d_ff: int, act: str, dtype,
                 bias: bool = False, device=None):
        super().__init__()
        self.d_model, self.d_ff = d_model, d_ff
        if act in ("swiglu", "geglu"):
            self.w_gate = param((d_model, d_ff), dtype, device)
        self.w_up = param((d_model, d_ff), dtype, device)
        self.w_down = param((d_ff, d_model), dtype, device)
        if bias:
            self.b_up = param((d_ff,), dtype, device)
            self.b_down = param((d_model,), dtype, device)

    def reset_parameters(self, gen: torch.Generator):
        for name, p in self.named_parameters():
            if name.startswith("b_"):
                p.zero_()
            else:
                dense_init_(p, gen, self.d_ff if name == "w_down"
                            else self.d_model)


def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp(x, p: MLP, act: str):
    if act == "swiglu":
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    elif act == "geglu":
        h = gelu(x @ p.w_gate) * (x @ p.w_up)
    else:  # gelu
        h = x @ p.w_up
        if hasattr(p, "b_up"):
            h = h + p.b_up
        h = gelu(h)
    y = h @ p.w_down
    if hasattr(p, "b_down"):
        y = y + p.b_down
    return y


def remat(cfg, fn, *args):
    """``fn(*args)``; under autograd with ``cfg.remat`` set, through
    ``torch.utils.checkpoint`` (non-reentrant), as the reference wraps a
    layer in ``jax.checkpoint``: the layer's activations are dropped after
    the forward and recomputed in the backward, K4's forward kernel
    included."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)
