"""RWKV-6 ("Finch") blocks: data-dependent decay linear attention (PyTorch
port of ``repro.models.rwkv6``).

Prefill and training run the WKV recurrence through the K5 kernel (``wkv``
from ``kernels/rwkv_scan``): the exact recurrence per token on the card, its
plain version on the CPU, from a given state to the final state that
becomes the decode cache.  Under grad on the card its gradient is K5's
backward kernel (``WkvFn``), which recomputes the states from checkpoints
the forward saves every 16 tokens; on the CPU autograd runs through the
plain version.  The reference's ``wkv_chunked`` is not copied: its 16-token
factorisation forms ``exp(-cumsum(logw))``, which overflows to inf (and
NaN) once the clipped decays reach logw <= -6, and K5 computes the same
recurrence without it.  Decode (``wkv_step``) is the exact single step in
plain PyTorch, as in the reference.

All WKV math runs in float32; projections stay in the model dtype.  The
parameters of a layer are the ``TimeMix`` and ``ChannelMix`` modules (the
reference's ``init_time_mix``/``init_channel_mix`` pytrees, same names).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import local_einsum, split_heads
from repro_torch.kernels.rwkv_scan.ops import wkv
from repro_torch.models.layers import dense_init_, param

LORA_MIX = 32     # rank of the per-(r,w,k,v,g) token-shift loras
LORA_DECAY = 64   # rank of the decay lora
MIX_KINDS = 5     # r, w, k, v, g


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class TimeMix(nn.Module):
    """The reference's ``init_time_mix`` leaves; loras and decay params in
    float32, the five D x D projections in the model dtype."""

    def __init__(self, d_model, dtype, device=None):
        super().__init__()
        D, f32 = d_model, torch.float32
        self.d_model = D
        self.mu_x = param((D,), f32, device)
        self.mix_w1 = param((D, MIX_KINDS * LORA_MIX), f32, device)
        self.mix_w2 = param((MIX_KINDS, LORA_MIX, D), f32, device)
        self.w0 = param((D,), f32, device)
        self.wA = param((D, LORA_DECAY), f32, device)
        self.wB = param((LORA_DECAY, D), f32, device)
        self.u = param((D,), f32, device)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, param((D, D), dtype, device))
        self.ln_x_scale = param((D,), f32, device)
        self.ln_x_bias = param((D,), f32, device)

    def reset_parameters(self, gen: torch.Generator):
        D = self.d_model
        fan_in = {"mix_w1": D, "mix_w2": LORA_MIX, "wA": D, "wB": LORA_DECAY}
        for name, p in self.named_parameters():
            if name in fan_in:
                dense_init_(p, gen, fan_in[name])
            elif name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
                dense_init_(p, gen, D)
            elif name == "w0":
                p.fill_(-6.0)
            elif name == "u":
                p.fill_(0.5)
            else:
                p.zero_()


class ChannelMix(nn.Module):
    """The reference's ``init_channel_mix`` leaves."""

    def __init__(self, d_model, d_ff, dtype, device=None):
        super().__init__()
        self.d_model, self.d_ff = d_model, d_ff
        self.mu_k = param((d_model,), torch.float32, device)
        self.mu_r = param((d_model,), torch.float32, device)
        self.w_in = param((d_model, d_ff), dtype, device)
        self.w_out = param((d_ff, d_model), dtype, device)
        self.w_r = param((d_model, d_model), dtype, device)

    def reset_parameters(self, gen: torch.Generator):
        self.mu_k.zero_()
        self.mu_r.zero_()
        dense_init_(self.w_in, gen, self.d_model)
        dense_init_(self.w_out, gen, self.d_ff)
        dense_init_(self.w_r, gen, self.d_model)


# ---------------------------------------------------------------------------
# Token shift
# ---------------------------------------------------------------------------

def _shift(x, x_prev):
    """x: (B, T, D); x_prev: (B, D) last token of previous segment."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def ddlerp(x, xx, p: TimeMix):
    """Data-dependent token-shift mixing -> (x_r, x_w, x_k, x_v, x_g)."""
    sx = (xx - x).float()
    x32 = x.float()
    base = x32 + sx * p.mu_x
    m = torch.tanh(base @ p.mix_w1)                          # (B,T,5*R)
    m = m.reshape(m.shape[:-1] + (MIX_KINDS, LORA_MIX))
    offs = torch.einsum("btkr,krd->kbtd", m, p.mix_w2)       # (5,B,T,D)
    return [(x32 + sx * (p.mu_x + offs[i])).to(x.dtype)
            for i in range(MIX_KINDS)]                       # r, w, k, v, g


# ---------------------------------------------------------------------------
# WKV decode step
# ---------------------------------------------------------------------------

def wkv_step(r, k, v, logw, u, state):
    """Exact single-token recurrence. r,k,v,logw: (B,H,N); state:
    (B,H,N,N)."""
    a = local_einsum("bhk,bhn->bhkn", k, v)
    y = local_einsum("bhk,bhkn->bhn", r, state + u[None, :, :, None] * a)
    state = torch.exp(logw)[..., None] * state + a
    return y, state


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _group_norm(y, scale, bias, H, eps=64e-5):
    """Per-head layernorm over N (RWKV's ln_x)."""
    B, T = y.shape[:2]
    yh = y.reshape(B, T, H, -1).float()
    mu = yh.mean(-1, keepdim=True)
    var = ((yh - mu) ** 2).mean(-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    y = yh.reshape(B, T, -1)
    return y * (1.0 + scale) + bias


def _decay(x_w, p: TimeMix):
    logw = -torch.exp(p.w0 + torch.tanh(x_w.float() @ p.wA) @ p.wB)
    return torch.clamp(logw, -20.0, -1e-4)


def time_mix(x, p: TimeMix, head_size, x_prev, state):
    """RWKV6 attention analogue. x: (B,T,D); state: (B,H,N,N) float32.
    Returns (y, (x_last, state')), state' the state after the last token."""
    B, T, D = x.shape
    H = D // head_size
    xx = _shift(x, x_prev)
    x_r, x_w, x_k, x_v, x_g = ddlerp(x, xx, p)
    r = split_heads((x_r @ p.w_r).float(), H, head_size, "rnn")
    k = split_heads((x_k @ p.w_k).float(), H, head_size, "rnn")
    v = (x_v @ p.w_v).float().reshape(B, T, H, head_size)
    g = F.silu((x_g @ p.w_g).float())
    logw = _decay(x_w, p).reshape(B, T, H, head_size)
    u = p.u.reshape(H, head_size)
    y, state = wkv(r, k, v, logw, u, state)
    y = _group_norm(y.reshape(B, T, D), p.ln_x_scale, p.ln_x_bias, H)
    y = (y * g).to(x.dtype) @ p.w_o
    return y, (x[:, -1, :], state)


def time_mix_step(x, p: TimeMix, head_size, x_prev, state):
    """Decode: x (B, D). Returns (y (B,D), (x, state'))."""
    B, D = x.shape
    H = D // head_size
    x_r, x_w, x_k, x_v, x_g = (a[:, 0, :] for a in
                               ddlerp(x[:, None, :], x_prev[:, None, :], p))
    r = (x_r @ p.w_r).float().reshape(B, H, head_size)
    k = (x_k @ p.w_k).float().reshape(B, H, head_size)
    v = (x_v @ p.w_v).float().reshape(B, H, head_size)
    g = F.silu((x_g @ p.w_g).float())
    logw = _decay(x_w, p).reshape(B, H, head_size)
    u = p.u.reshape(H, head_size)
    y, state = wkv_step(r, k, v, logw, u, state)
    y = _group_norm(y.reshape(B, 1, D), p.ln_x_scale, p.ln_x_bias, H)[:, 0]
    y = (y * g).to(x.dtype) @ p.w_o
    return y, (x, state)


def channel_mix(x, p: ChannelMix, x_prev):
    """RWKV6 FFN. x: (B,T,D). Returns (y, x_last)."""
    xx = _shift(x, x_prev)
    x32, xx32 = x.float(), xx.float()
    xk = (x32 + (xx32 - x32) * p.mu_k).to(x.dtype)
    xr = (x32 + (xx32 - x32) * p.mu_r).to(x.dtype)
    kk = torch.square(torch.relu(xk @ p.w_in))
    v = kk @ p.w_out
    rr = torch.sigmoid(xr @ p.w_r)
    return rr * v, x[:, -1, :]


def channel_mix_step(x, p: ChannelMix, x_prev):
    y, xl = channel_mix(x[:, None, :], p, x_prev)
    return y[:, 0], xl
