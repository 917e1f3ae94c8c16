"""A CPU model of K4's tensor-core forward at head width 256
(``csrc/flash_attention.cu``, namespace ``tc``, ``flash_fwd_tc_kernel<256>``),
shared by ``test_torch_k4_fwd.py``: the kernel computed tile by tile as the
card computes it, a CTA per 128 queries of a (batch, head) and a consumer
per 64 of them over key tiles of 64 keys, with the same first tile (the
window's ``first_key``), the same last tile, the same tiles skipped per
consumer, the same per-element masks on the tiles that cross an edge and
none on the others, the online softmax on scores scaled by ``scale_log2``
in exp2, P rounded to bf16 before P.V, the normaliser l summed from the
unrounded P, float32 sums and a bf16 output.  With ``rounding=False`` it
runs in float64 and rounds nothing, so it must then give the exact
attention: that holds the tile schedule and the masks apart from the
rounding.
"""
import math

import torch

BQ, BK = 128, 64         # query rows per CTA (64 per consumer); keys a tile
LOG2E = 1.4426950408889634


def first_key(p0, window, tile):
    """``helios_wgmma.cuh::first_key``: the first key tile, a multiple of
    ``tile``, holding a key that a query at position p0 or later sees."""
    lo = p0 - window + 1 if window > 0 else 0
    return lo // tile * tile if lo > 0 else 0


def _rows(x, lo, n):
    """Rows lo .. lo + n of x's axis 1, zero past its end (TMA's fill)."""
    out = x.new_zeros((x.shape[0], n) + x.shape[2:])
    hi = min(lo + n, x.shape[1])
    if hi > lo:
        out[:, :hi - lo] = x[:, lo:hi]
    return out


def fwd_model(q, k, v, causal=True, q_offset=0, window=0, rounding=True):
    """(o, lse) of the tensor-core forward at hd 256 on q (B, S, H, hd) and
    k, v (B, T, K, hd), H % K == 0 (query head h reads kv head h // G):
    o (B, S, H, hd), lse (B, H, S) in log2 units, +inf for a query that
    sees no key (whose output is 0).  ``rounding``: float32 sums, P and o
    rounded to bf16 (the inputs should hold bf16 values, as on the card);
    off: float64 throughout, nothing rounded."""
    dt = torch.float32 if rounding else torch.float64
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    kvh = torch.arange(H) // (H // K)
    q, k, v = q.to(dt), k.to(dt)[:, :, kvh], v.to(dt)[:, :, kvh]

    def rnd(x):
        return x.to(torch.bfloat16).to(dt) if rounding else x
    scale_log2 = LOG2E / math.sqrt(hd)
    o = torch.zeros(B, S, H, hd, dtype=dt)
    lse = torch.full((B, H, S), math.inf, dtype=dt)
    for q0 in range(0, S, BQ):          # a CTA, every (batch, head) at once
        kv_end = min(T, q_offset + min(q0 + BQ, S)) if causal else T
        j_end = -(-kv_end // BK) if kv_end > 0 else 0
        j0 = first_key(q_offset + q0, window, BK) // BK
        for w in range(2):              # its two consumer warpgroups
            r0 = q0 + 64 * w
            my_end = (0 if r0 >= S else
                      min(T, q_offset + min(r0 + 64, S)) if causal else T)
            pos = q_offset + torch.arange(r0, r0 + 64)
            qw = _rows(q, r0, 64)
            m = torch.full((B, H, 64), -math.inf, dtype=dt)
            den = torch.zeros(B, H, 64, dtype=dt)    # the normaliser l
            acc = torch.zeros(B, H, 64, hd, dtype=dt)
            for j in range(j0, j_end):
                k0 = j * BK
                if not (k0 < my_end and (
                        window <= 0 or k0 + BK > q_offset + r0 - window + 1)):
                    continue            # no row of the consumer sees a key
                kt, vt = _rows(k, k0, BK), _rows(v, k0, BK)
                sc = torch.einsum("bqhd,bthd->bhqt", qw, kt)
                if (k0 + BK > T or (causal and k0 + BK - 1 > q_offset + r0)
                        or (window > 0 and q_offset + r0 + 63 - k0
                            >= window)):
                    keys = torch.arange(k0, k0 + BK)[None, :]
                    ok = keys < T
                    if causal:
                        ok = ok & (keys <= pos[:, None])
                    if window > 0:
                        ok = ok & (pos[:, None] - keys < window)
                    sc = sc.masked_fill(~ok, -math.inf)
                m_new = torch.maximum(m, sc.amax(-1))
                # a row that has seen no key yet keeps a zero sum and O
                m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                alpha = torch.exp2((m - m_use) * scale_log2)
                shift = (m_use * scale_log2)[..., None]
                p = torch.exp2(sc * scale_log2 - shift)
                den = den * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhqt,bthd->bhqd", rnd(p), vt)
                m = m_new
            n = min(64, S - r0)
            if n > 0:
                seen = den > 0
                lr = torch.where(seen, den, 1.0)
                inv = torch.where(seen, 1.0 / lr, 0.0)
                o[:, r0:r0 + n] = (acc * inv[..., None]).permute(
                    0, 2, 1, 3)[:, :n]
                lse[:, :, r0:r0 + n] = torch.where(
                    seen, m * scale_log2 + torch.log2(lr), math.inf)[..., :n]
    return rnd(o), lse
