"""Griffin / RecurrentGemma recurrent blocks: causal conv + RG-LRU (PyTorch
port of ``repro.models.rglru``).

The reference runs the gated linear recurrence h_t = a_t h_{t-1} + b_t
with ``jax.lax.associative_scan`` over time.  That is not a TPU kernel
(XLA lowers it), so its counterpart here is plain PyTorch: a log-depth
inclusive scan (``linear_scan``), ceil(log2 T) elementwise steps over the
whole sequence (12 at T = 4096), in float32 as in the reference.  Decode is
the exact single-step update with O(d_rnn) state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import annotate
from repro_torch.models.layers import dense_init_, gelu, param

RG_C = 8.0
CONV_W = 4


class RecurrentBlock(nn.Module):
    """The reference's ``init_recurrent_block``: ``w_in``, ``w_gate_in``
    ``(d, Dr)``, float32 ``conv_w`` ``(4, Dr)`` and ``conv_b``, ``w_a``,
    ``w_x`` ``(Dr, Dr)`` with float32 ``b_a``, ``b_x``, float32
    ``lambda_p`` (-1: softplus ~ 0.31) and ``w_out`` ``(Dr, d)``."""

    def __init__(self, d_model: int, d_rnn: int, dtype, device=None):
        super().__init__()
        self.d_model, self.d_rnn = d_model, d_rnn
        f32 = torch.float32
        self.w_in = param((d_model, d_rnn), dtype, device)
        self.w_gate_in = param((d_model, d_rnn), dtype, device)
        self.conv_w = param((CONV_W, d_rnn), f32, device)
        self.conv_b = param((d_rnn,), f32, device)
        self.w_a = param((d_rnn, d_rnn), dtype, device)
        self.b_a = param((d_rnn,), f32, device)
        self.w_x = param((d_rnn, d_rnn), dtype, device)
        self.b_x = param((d_rnn,), f32, device)
        self.lambda_p = param((d_rnn,), f32, device)
        self.w_out = param((d_rnn, d_model), dtype, device)

    def reset_parameters(self, gen: torch.Generator):
        fan_in = {"w_in": self.d_model, "w_gate_in": self.d_model,
                  "conv_w": CONV_W, "w_a": self.d_rnn, "w_x": self.d_rnn,
                  "w_out": self.d_rnn}
        for name, p in self.named_parameters():
            if name in fan_in:
                dense_init_(p, gen, fan_in[name])
            elif name == "lambda_p":
                p.fill_(-1.0)
            else:
                p.zero_()


def causal_conv(x, w, b, x_prev=None):
    """Depthwise causal conv, width 4. x: (B, T, C) float32; x_prev:
    (B, 3, C), the 3 inputs before x (zeros when None).  Returns (y, the
    last 3 inputs)."""
    B, T, C = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, CONV_W - 1, C), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([x_prev, x], dim=1)                      # (B, T+3, C)
    y = sum(w[j][None, None, :] * xp[:, j:j + T] for j in range(CONV_W))
    return y + b, xp[:, -(CONV_W - 1):, :]


def _gates(x, p: RecurrentBlock):
    r = torch.sigmoid(x @ p.w_a.float() + p.b_a)
    i = torch.sigmoid(x @ p.w_x.float() + p.b_x)
    log_a = -RG_C * F.softplus(p.lambda_p) * r
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-8)) * (i * x)
    return a, gated_x


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over dim 1
    of (B, T, C): the composition (a1, b1) then (a2, b2) is
    (a1 a2, a2 b1 + b2), applied at strides 1, 2, 4, ... (Hillis-Steele),
    ceil(log2 T) steps.  Returns h (B, T, C)."""
    T = a.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru(x, p: RecurrentBlock, h0):
    """x: (B, T, Dr) float32; h0: (B, Dr).  Returns (h_all (B, T, Dr),
    h_last)."""
    a, b = _gates(x, p)
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    return h, h[:, -1, :]


def rglru_step(x, p: RecurrentBlock, h0):
    """x: (B, Dr) float32, one token."""
    a, b = _gates(x[:, None, :], p)
    h = a[:, 0] * h0 + b[:, 0]
    return h, h


def recurrent_block(x, p: RecurrentBlock, state=None):
    """Full Griffin temporal block. x: (B, T, D); state: None (zeros) or
    {"h": (B, Dr), "conv": (B, 3, Dr)}.  Returns (y (B, T, D), new
    state)."""
    B = x.shape[0]
    gate = gelu(x @ p.w_gate_in)
    h = annotate((x @ p.w_in).float(), "batch", None, "rnn")
    h0 = (state["h"] if state is not None else
          torch.zeros((B, h.shape[-1]), dtype=torch.float32,
                      device=x.device))
    cp = state["conv"] if state is not None else None
    h, conv_state = causal_conv(h, p.conv_w, p.conv_b, cp)
    h, h_last = rglru(h, p, h0)
    y = (h.to(x.dtype) * gate) @ p.w_out
    return y, {"h": h_last, "conv": conv_state}


def recurrent_block_step(x, p: RecurrentBlock, state):
    """Decode one token. x: (B, D); state {"h": (B, Dr), "conv":
    (B, 3, Dr)}."""
    gate = gelu(x @ p.w_gate_in)
    h = (x @ p.w_in).float()
    h3, conv_state = causal_conv(h[:, None, :], p.conv_w, p.conv_b,
                                 state["conv"])
    h1, h_last = rglru_step(h3[:, 0, :], p, state["h"])
    y = (h1.to(x.dtype) * gate) @ p.w_out
    return y, {"h": h_last, "conv": conv_state}
