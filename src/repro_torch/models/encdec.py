"""Encoder-decoder transformer, the whisper-small backbone (PyTorch port of
``repro.models.encdec``).

The audio conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S, D) (``models/frontends.py`` makes
them).  Sinusoidal positions on both sides, no RoPE (``rope_theta=0``),
LayerNorm with bias, biases on every linear, tanh-GELU.  Every prefill
attention runs K4 on the card: the encoder's self-attention and the
cross-attention non-causal (S != T, ragged T), the decoder's causal.

Parameters are one ``EncDec`` module named as the reference pytree
(``embed``, ``unembed``, ``enc.blocks.<i>.attn.wq``, ``enc.final_norm``,
``dec.blocks.<i>.xattn.wk``, ...).  Two differences from the reference,
both for serving:

  * ``decode_train`` can return each decoder layer's self-attention keys
    and values, so that ``steps.make_prefill_step`` hands decode a cache
    that holds the prompt; the reference's prefill returns only the cross
    caches, and its launcher decodes from position 0.
  * ``build_cross_cache`` adds the cross-attention's ``bk``/``bv``, as
    ``_xattn`` does; the reference's leaves them out, which agrees only
    while they are zero (as they are initialised).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.distributed.sharding import (annotate, merged_heads,
                                              split_heads)
from repro_torch.models.attention import (Attention, attend, attention_block,
                                          attention_decode_block,
                                          decode_attend, output_proj)
from repro_torch.models.layers import (MLP, Norm, apply_norm, draw_, mlp,
                                       param, remat)


def sinusoid(seq_len: int, d_model: int, dtype=torch.float32, device=None):
    """(seq_len, d_model): sin at even, cos at odd columns, computed in
    float64 and rounded to float32 as the reference's numpy does."""
    pos = torch.arange(seq_len, dtype=torch.float64)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float64)[None, :]
    ang = pos / torch.pow(10000.0, dim / d_model)
    out = torch.zeros((seq_len, d_model), dtype=torch.float32)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out.to(dtype=dtype, device=device)


def sinusoid_at(pos: int, d_model: int, dtype, device=None):
    """(1, 1, d_model): the position-``pos`` row in float32, as the
    reference's decode computes it."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
    ang = float(pos) / torch.pow(10000.0, dim / d_model)
    out = torch.zeros((d_model,), dtype=torch.float32, device=device)
    out[0::2] = torch.sin(ang)
    out[1::2] = torch.cos(ang)
    return out.to(dtype)[None, None, :]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class EncDecLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, cross: bool):
        super().__init__()
        attn = dict(qkv_bias=cfg.qkv_bias, bias=cfg.bias, device=device)
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, dtype, **attn)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, bias=cfg.bias,
                       device=device)
        if cross:
            self.ln_x = Norm(cfg.d_model, cfg.norm, device)
            self.xattn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, dtype, **attn)


class Stack(nn.Module):
    def __init__(self, cfg: ModelConfig, n: int, dtype, device, cross: bool):
        super().__init__()
        self.blocks = nn.ModuleList(EncDecLayer(cfg, dtype, device, cross)
                                    for _ in range(n))
        self.final_norm = Norm(cfg.d_model, cfg.norm, device)


class EncDec(nn.Module):
    """The parameters of one encoder-decoder model, allocated but not
    drawn (``init_params`` draws them, ``lm.params_from_numpy`` loads
    them)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dtype = getattr(torch, cfg.dtype)
        self.embed = param((cfg.vocab, cfg.d_model), dtype, device)
        self.unembed = param((cfg.d_model, cfg.vocab), dtype, device)
        self.enc = Stack(cfg, cfg.n_enc_layers, dtype, device, cross=False)
        self.dec = Stack(cfg, cfg.n_layers, dtype, device, cross=True)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> EncDec:
    """Random parameters as the reference's initializers draw them, from
    ``generator``, on ``device`` (``lm.init_params``' rules)."""
    return draw_(EncDec(cfg, resolve_device(device)), generator)


# ---------------------------------------------------------------------------
# Encoder, teacher-forced decoder
# ---------------------------------------------------------------------------

def _cross_kv(enc_out, p: Attention, cfg: ModelConfig):
    """Cross-attention keys and values (B, Te, K, hd) from the encoder
    output, biases included."""
    k, v = enc_out @ p.wk, enc_out @ p.wv
    if hasattr(p, "bk"):
        k, v = k + p.bk, v + p.bv
    K, hd = cfg.n_kv_heads, cfg.head_dim
    return (split_heads(k, K, hd, "kv_heads"),
            split_heads(v, K, hd, "kv_heads"))


def _xattn(x, p: Attention, cfg: ModelConfig, enc_out):
    """Cross attention: q from x, k/v from the encoder output, every query
    sees every frame (K4, non-causal, on the card)."""
    q = x @ p.wq
    if hasattr(p, "bq"):
        q = q + p.bq
    q = split_heads(q, cfg.n_heads, cfg.head_dim, "heads", cfg.n_kv_heads)
    k, v = _cross_kv(enc_out, p, cfg)
    o = attend(q, k, v, causal=False, q_chunk=512)
    return output_proj(merged_heads(o, cfg.n_heads, cfg.n_kv_heads), p)


def _enc_layer(x, lp: EncDecLayer, cfg: ModelConfig):
    a, _ = attention_block(apply_norm(x, lp.ln1, cfg.norm), lp.attn, cfg,
                           causal=False)
    x = x + a
    return annotate(x + mlp(apply_norm(x, lp.ln2, cfg.norm), lp.mlp,
                            cfg.act), "batch", None, None)


def _dec_layer(x, lp: EncDecLayer, cfg: ModelConfig, enc_out):
    """One decoder layer: (x', its self-attention (k, v))."""
    a, kv = attention_block(apply_norm(x, lp.ln1, cfg.norm), lp.attn, cfg,
                            causal=True)
    x = x + a
    x = x + _xattn(apply_norm(x, lp.ln_x, cfg.norm), lp.xattn, cfg, enc_out)
    return annotate(x + mlp(apply_norm(x, lp.ln2, cfg.norm), lp.mlp,
                            cfg.act), "batch", None, None), kv


def encode(params: EncDec, cfg: ModelConfig, frames):
    """frames: (B, S, D) stub embeddings -> encoder hidden (B, S, D).
    Each layer is checkpointed under autograd with ``cfg.remat``."""
    x = frames + sinusoid(frames.shape[1], cfg.d_model, frames.dtype,
                          frames.device)[None]
    x = annotate(x, "batch", None, None)
    for lp in params.enc.blocks:
        x = remat(cfg, _enc_layer, x, lp, cfg)
    return apply_norm(x, params.enc.final_norm, cfg.norm)


def decode_train(params: EncDec, cfg: ModelConfig, tok_embeds, enc_out,
                 return_kv: bool = False):
    """Teacher-forced decoder pass.  tok_embeds: (B, S, D).  Returns the
    hidden (B, S, D), and with ``return_kv`` also each layer's
    self-attention (k, v).  Each layer is checkpointed under autograd with
    ``cfg.remat``."""
    x = tok_embeds + sinusoid(tok_embeds.shape[1], cfg.d_model,
                              tok_embeds.dtype, tok_embeds.device)[None]
    kvs = []
    for lp in params.dec.blocks:
        x, kv = remat(cfg, _dec_layer, x, lp, cfg, enc_out)
        kvs.append(kv)
    x = apply_norm(x, params.dec.final_norm, cfg.norm)
    return (x, kvs) if return_kv else x


def forward(params: EncDec, cfg: ModelConfig, frames, tok_embeds):
    enc_out = encode(params, cfg, frames)
    return (decode_train(params, cfg, tok_embeds, enc_out),
            torch.zeros((), dtype=torch.float32, device=frames.device))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               device="cuda"):
    """Zeros: ``{"self": {"k", "v"}, "cross_k", "cross_v"}``, each
    (L, B, length, K, hd)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def z(n):
        return torch.zeros((L, batch, n, K, hd), dtype=dtype, device=dev)
    return {"self": {"k": z(max_len), "v": z(max_len)},
            "cross_k": z(enc_len), "cross_v": z(enc_len)}


def build_cross_cache(params: EncDec, cfg: ModelConfig, enc_out):
    """Per-layer cross-attention K/V from the encoder output, stacked
    (L, B, Te, K, hd)."""
    kv = [_cross_kv(enc_out, lp.xattn, cfg) for lp in params.dec.blocks]
    return (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]))


def decode_one(params: EncDec, cfg: ModelConfig, x, cache, pos: int):
    """One decoder token.  x: (B, 1, D) current-token embedding; returns
    (hidden (B, 1, D), cache), the self-attention cache updated in
    place."""
    x = x + sinusoid_at(pos, cfg.d_model, x.dtype, x.device)
    B = x.shape[0]
    for i, lp in enumerate(params.dec.blocks):
        sc = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i]}
        a, _ = attention_decode_block(apply_norm(x, lp.ln1, cfg.norm),
                                      lp.attn, cfg, sc, pos)
        x = x + a
        hx = apply_norm(x, lp.ln_x, cfg.norm)
        q = hx @ lp.xattn.wq
        if hasattr(lp.xattn, "bq"):
            q = q + lp.xattn.bq
        q = split_heads(q, cfg.n_heads, cfg.head_dim, "heads",
                        cfg.n_kv_heads)
        ck, cv = cache["cross_k"][i], cache["cross_v"][i]
        x = x + output_proj(decode_attend(q, ck, cv, ck.shape[1] - 1),
                            lp.xattn)
        x = x + mlp(apply_norm(x, lp.ln2, cfg.norm), lp.mlp, cfg.act)
    return apply_norm(x, params.dec.final_norm, cfg.norm), cache

