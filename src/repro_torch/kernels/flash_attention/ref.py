"""Plain PyTorch version of the flash-attention kernel (K4)."""
import math

import torch


def visible(S, T, causal: bool, q_offset: int, window: int, device=None):
    """(S, T) bool: query i (at absolute position ``q_offset + i``) sees key
    t.  Causal: t <= q_offset + i.  ``window`` > 0 (local attention, the
    reference's ``attend``): also q_offset + i - t < window."""
    q_pos = q_offset + torch.arange(S, device=device)[:, None]
    t = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= t
    if window:
        mask &= q_pos - t < window
    return mask


def attention_ref(q, k, v, causal: bool = True, q_offset: int = 0,
                  window: int = 0):
    """q: (B, S, H, hd); k, v: (B, T, K, hd) with H % K == 0 (query head h
    reads kv head h // (H // K)).  Scores, softmax and P.V in float32;
    returns (B, S, H, hd) in q's dtype.  Query i sees the keys ``visible``
    gives; a query that sees no key gets zeros, as the kernel gives."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * (
        1.0 / math.sqrt(hd))
    if causal or window:
        mask = visible(S, T, causal, q_offset, window, q.device)
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1).masked_fill(
            ~mask.any(-1, keepdim=True), 0.0)
    else:
        p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)
