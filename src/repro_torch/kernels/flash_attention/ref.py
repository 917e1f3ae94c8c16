"""Plain PyTorch version of the flash-attention kernel (K4)."""
import math

import torch


def attention_ref(q, k, v, causal: bool = True, q_offset: int = 0):
    """q: (B, S, H, hd); k, v: (B, T, K, hd) with H % K == 0 (query head h
    reads kv head h // (H // K)).  Scores, softmax and P.V in float32;
    returns (B, S, H, hd) in q's dtype.  Causal: query i (at absolute
    position ``q_offset + i``) sees keys 0 .. q_offset + i."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * (
        1.0 / math.sqrt(hd))
    if causal:
        q_pos = q_offset + torch.arange(S, device=q.device)
        mask = q_pos[:, None] >= torch.arange(T, device=q.device)[None, :]
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)
