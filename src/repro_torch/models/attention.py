"""Grouped-query attention (PyTorch port of ``repro.models.attention``).

Prefill attention (``attend``) runs the flash-attention kernel K4 on the
card, which reads q, k, v in the model's ``(B, S, H, hd)`` layout and maps
query head h to kv head ``h // G`` itself: bf16 at head widths 64-256 on
the tensor cores (P rounded to bf16 before P.V, as the reference does),
float32 and the reduced configs' narrow heads on the CUDA cores;
local-attention windows, and the encoder's and the cross-attention's
non-causal S != T, in both.  On the CPU it runs the
plain version of the reference's chunked attention.  Single-token decode
(``decode_attend``) is an einsum in the reference, not a kernel, and
stays plain PyTorch on both devices.

The reference's ``annotate`` sharding hints are kept
(``distributed/sharding.py``): on one card they return their input after
one check; on a mesh they place DTensors, and ``split_heads`` gathers a
flat head dim whose head count the mesh axis does not divide (DTensor
cannot reshape an uneven shard).  Unlike the reference's pure functions,
``cache_update`` writes the new keys and values into the cache in place, so
decode never copies the multi-GB cache.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.distributed.sharding import (annotate, merged_heads,
                                              split_heads)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense_init_, param, rmsnorm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` (``(d_in, d_out)``), with ``bq``,
    ``bk``, ``bv`` for QKV bias, ``bo`` for output bias and float32
    ``q_norm``/``k_norm`` for QK-norm (the reference's ``init_attention``)."""

    def __init__(self, d_model, n_heads, n_kv, head_dim, dtype,
                 qkv_bias=False, qk_norm=False, bias=False, device=None):
        super().__init__()
        self.d_model, self.fan_out = d_model, n_heads * head_dim
        self.wq = param((d_model, n_heads * head_dim), dtype, device)
        self.wk = param((d_model, n_kv * head_dim), dtype, device)
        self.wv = param((d_model, n_kv * head_dim), dtype, device)
        self.wo = param((n_heads * head_dim, d_model), dtype, device)
        if qkv_bias:
            self.bq = param((n_heads * head_dim,), dtype, device)
            self.bk = param((n_kv * head_dim,), dtype, device)
            self.bv = param((n_kv * head_dim,), dtype, device)
        if bias:
            self.bo = param((d_model,), dtype, device)
        if qk_norm:
            self.q_norm = param((head_dim,), torch.float32, device)
            self.k_norm = param((head_dim,), torch.float32, device)

    def reset_parameters(self, gen: torch.Generator):
        for name, p in self.named_parameters():
            if name.startswith("w"):
                dense_init_(p, gen, self.fan_out if name == "wo"
                            else self.d_model)
            else:
                p.zero_()


def project_qkv(x, p: Attention, *, n_heads, n_kv, head_dim, positions=None,
                rope_theta=0.0, qk_norm=False):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,K,hd); RoPE applied if
    theta > 0."""
    B, S, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = split_heads(q, n_heads, head_dim, "heads", n_kv)
    k = split_heads(k, n_kv, head_dim, "kv_heads")
    v = split_heads(v, n_kv, head_dim, "kv_heads")
    if qk_norm:
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    if rope_theta:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def output_proj(o, p: Attention):
    y = o @ p.wo
    if hasattr(p, "bo"):
        y = y + p.bo
    return y


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def _scores_softmax_out(q, k, v, mask, scale, probs_dtype=torch.float32):
    """q: (B,Cq,K,G,hd); k,v: (B,T,K,hd); mask: (Cq, T) bool."""
    s = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float())
    s = s * scale
    s = torch.where(mask, s, NEG_INF)
    # max/sum in fp32; the normalised probs may be materialised in bf16
    m = torch.amax(s, dim=-1, keepdim=True)
    if probs_dtype == torch.bfloat16:
        s = (s - m).to(torch.bfloat16)
        p = torch.exp(s.float())
    else:
        p = torch.exp(s - m)
    p = (p / torch.sum(p, dim=-1, keepdim=True)).to(probs_dtype)
    return torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v)


def _attend_plain(q, k, v, causal, window, q_chunk, q_offset, probs_dtype):
    """The reference's chunked attention in plain PyTorch: same masks
    (causal and window), probabilities cast to ``probs_dtype`` and then to
    v's dtype before P.V.  Returns (B, S, H*hd)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, K, H // K, hd)
    kv_pos = torch.arange(T, device=q.device)
    outs = []
    for c0 in range(0, S, max(min(q_chunk, S), 1)):
        q_c = qg[:, c0:c0 + q_chunk]
        q_pos = q_offset + c0 + torch.arange(q_c.shape[1], device=q.device)
        m = torch.ones((q_c.shape[1], T), dtype=torch.bool, device=q.device)
        if causal:
            m &= q_pos[:, None] >= kv_pos[None, :]
        if window:
            m &= q_pos[:, None] - kv_pos[None, :] < window
        outs.append(_scores_softmax_out(q_c, k, v, m, scale, probs_dtype))
    return torch.cat(outs, dim=1).reshape(B, S, H * hd)


def attend(q, k, v, *, causal=True, window=0, q_chunk=512, q_offset=0,
           probs_dtype=torch.float32):
    """Prefill attention.  q: (B, S, H, hd); k, v: (B, T, K, hd).
    ``q_offset`` is the absolute position of q[0] within the kv stream.
    Returns (B, S, H*hd).

    On the card: the K4 kernel, window included.  Its bf16 route
    rounds the probabilities to bf16 before P.V, as the reference casts
    them to v's dtype, but from an online softmax: it rounds exp(s - m) for
    the running max m and divides by the float32 sum at the end, where the
    reference rounds the normalised probabilities, so bf16 results differ
    at bf16 rounding.  Its float32 route keeps everything in float32.  On
    the CPU: the reference's chunked attention (``_attend_plain``)."""
    B, S, H, hd = q.shape
    if q.device.type != "cpu":
        o = flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                            window=window)
        return o.reshape(B, S, H * hd)
    return _attend_plain(q, k, v, causal, window, q_chunk, q_offset,
                         probs_dtype)


def decode_attend(q, k_cache, v_cache, pos):
    """Single-token decode. q: (B, 1, H, hd); caches: (B, T, K, hd) with
    the time axis sequence-sharded over the ``model`` mesh axis (the
    reference's annotations).  ``pos`` is the index of the current token
    (attends to [0, pos]).  Scores in float32 (the reference's
    ``preferred_element_type``).  On a mesh the query's heads are gathered
    first: the scores' heads take no mesh axis in the reference either,
    and DTensor cannot contract over a batch that flattens two sharded
    dims (batch and heads)."""
    B, _, H, hd = q.shape
    T, K = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg = annotate(q, "batch", None, None, None).reshape(B, 1, K, H // K, hd)
    k_cache = annotate(k_cache, "batch", "kv_seq", None, None)
    v_cache = annotate(v_cache, "batch", "kv_seq", None, None)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k_cache.float()) * scale
    s = annotate(s, "batch", None, None, None, "kv_seq")
    mask = torch.arange(T, device=q.device) <= pos
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H * hd)


def cache_update(k_cache, v_cache, k_new, v_new, pos):
    """Write k/v at time index ``pos`` (decode) or [0, S) (prefill), in
    place; returns the same caches."""
    S = k_new.shape[1]
    k_cache[:, pos:pos + S] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + S] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# Full blocks
# ---------------------------------------------------------------------------

def attention_block(x, p: Attention, cfg, *, positions=None, causal=True,
                    window=0, q_chunk=512):
    """Train/prefill self-attention over (B, S, D)."""
    q, k, v = project_qkv(
        x, p, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        positions=positions, rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm)
    o = attend(q, k, v, causal=causal, window=window, q_chunk=q_chunk,
               probs_dtype=getattr(torch, cfg.attn_probs_dtype))
    o = merged_heads(o, cfg.n_heads, cfg.n_kv_heads)
    return output_proj(o, p), (k, v)


def attention_decode_block(x, p: Attention, cfg, kv_cache, pos, *, window=0):
    """Decode self-attention for one token.  kv_cache: dict(k, v), updated
    in place."""
    q, k, v = project_qkv(
        x, p, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        positions=torch.full((x.shape[0], 1), pos, device=x.device),
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm)
    T = kv_cache["k"].shape[1]
    if window and window <= T:
        # ring buffer: during warmup (pos < T) entries [0, pos] are valid;
        # once full, every slot holds one of the last T (>= window) tokens.
        write_pos, valid_upto = pos % T, min(pos, T - 1)
    else:
        write_pos = valid_upto = pos
    kc, vc = cache_update(kv_cache["k"], kv_cache["v"], k, v, write_pos)
    o = decode_attend(q, kc, vc, valid_upto)
    return output_proj(o, p), {"k": kc, "v": vc}
