"""A CPU model of K4's tensor-core backward (``csrc/flash_attention_bwd.cu``,
namespace ``tcb``), shared by ``test_torch_k4_bwd.py``: the dK/dV kernel
and the dQ kernel computed tile by tile as the card computes them, with
the same tiles, the same tiles skipped, the same per-element masks, P
recomputed from the forward's log-sum-exp (``ref.lse_ref``) and delta =
rowsum(dO * O) from the forward's bf16 output, dS rounded to bf16 before
its products and P as a bf16 pair hi + lo for dV (``split``), float32
sums, outputs rounded to bf16.  With ``rounding=False`` nothing is
rounded, so the model must then give the exact gradient: that holds the
tiling and masking logic apart from the rounding.

``K4_BWD_TOL``, ``K4_BWD_FLOOR`` and ``K4_BWD_LARGEST`` are chip_smoke.py's
limits of the same names (entry by entry, |got - want| <= rtol |want| +
atol mean|want| + floor, per gradient; the largest |got - want| within a
share of the largest |want|, or of 1 where that is smaller).
"""
import math

import torch

from repro_torch.kernels.flash_attention.ref import lse_ref, visible

K4_BWD_TOL = {"float32": (1e-5, (1e-3, 1e-3, 1e-3)),
              "bfloat16": (2 ** -6, (2 ** -2, 2 ** -2, 2 ** -8))}
K4_BWD_FLOOR = 1e-4
K4_BWD_LARGEST = {"float32": 1e-4, "bfloat16": 2e-2}

BLK, TILE = 128, 64      # resident rows per CTA (64 per consumer); a tile
LOG2E = 1.4426950408889634


def tol_ratio(got, want, dtype, i):
    """The largest |got - want| / (rtol |want| + atol mean|want| + floor)
    of gradient ``i`` (0 dq, 1 dk, 2 dv) under ``K4_BWD_TOL[dtype]``."""
    rtol, atols = K4_BWD_TOL[dtype]
    want = want.float()
    return float(((got.float() - want).abs()
                  / (rtol * want.abs() + atols[i] * want.abs().mean()
                     + K4_BWD_FLOOR)).max())


def largest_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1.0)


def forward_out(q, k, v, causal, q_offset, window):
    """The tensor-core forward's output in float32: P = exp2(s - m)
    rounded to bf16 before P.V, divided by the unrounded sum, rounded to
    bf16 (0 where a query sees no key)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k) / math.sqrt(hd)
    mask = visible(S, T, causal, q_offset, window)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True).nan_to_num(neginf=0.0)
    p = torch.exp(s - m)
    o = torch.einsum("bkgqt,btkd->bqkgd", _bf(p), v)
    den = p.sum(-1).permute(0, 3, 1, 2)[..., None]          # (B, S, K, G, 1)
    o = torch.where(den > 0, o / den.clamp_min(1e-30), torch.zeros(()))
    return _bf(o.reshape(B, S, H, hd))


def _bf(x):
    return x.to(torch.bfloat16).float()


def _prod(a, b, rnd, split):
    """a @ b with a rounded by ``rnd``; ``split``: as a bf16 pair hi + lo
    (two products)."""
    hi = rnd(a)
    return hi @ b + (rnd(a - hi) @ b if split else 0.0)


def _rows(x, lo, n):
    """Rows lo .. lo + n of x's axis 0, zero past its end (TMA's fill)."""
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype)
    hi = min(lo + n, x.shape[0])
    if hi > lo:
        out[:hi - lo] = x[lo:hi]
    return out


def _mask(keys, pos, S_ok, T, causal, window):
    """(len(keys), len(pos)) bool: key t is seen from position p (and the
    query lies before S and the key before T)."""
    t, p = keys[:, None], pos[None, :]
    ok = (t < T) & S_ok[None, :]
    if causal:
        ok &= t <= p
    if window:
        ok &= p - t < window
    return ok


def bwd_model(q, k, v, do, causal=True, q_offset=0, window=0,
              rounding=True, split=(True, False)):
    """(dq, dk, dv) in float32 as the tensor-core kernels compute them from
    float32 inputs that hold bf16 values (q, k, v, do: (B, S, H, hd) and
    (B, T, K, hd)).  Outputs rounded to bf16 unless ``rounding`` is off,
    which also drops the rounding of P and dS and takes the plain
    version's float32 output for delta.  ``split``: (P for dV, dS for dK
    and dQ) as a bf16 pair hi + lo, two products each, else rounded once;
    the kernels split P only."""
    rnd = _bf if rounding else (lambda x: x)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    c = LOG2E / math.sqrt(hd)
    if rounding:
        o = forward_out(q, k, v, causal, q_offset, window)
    else:
        from repro_torch.kernels.flash_attention.ref import attention_ref
        o = attention_ref(q, k, v, causal, q_offset, window)
    lse = lse_ref(q, k, causal, q_offset, window)             # (B, H, S)
    delta = (do * o).sum(-1).permute(0, 2, 1)                 # (B, H, S)
    dq = torch.zeros(B, S, H, hd)
    dk = torch.zeros(B, T, K, hd)
    dv = torch.zeros(B, T, K, hd)
    for b in range(B):
        for kvh in range(K):
            # dK/dV: a CTA per kBlk keys, a consumer per 64 of them
            for n0 in range(0, T, BLK):
                s_lo = max(0, n0 - q_offset) if causal else 0
                s_hi = (min(S, n0 + BLK - 1 + window - q_offset) if window
                        else S)
                t0 = s_lo // TILE
                n_tiles = max(0, -(-max(s_hi, 0) // TILE) - t0)
                for w in range(2):
                    k0w = n0 + 64 * w
                    keys = torch.arange(k0w, k0w + 64)
                    kw = _rows(k[b, :, kvh], k0w, 64)
                    vw = _rows(v[b, :, kvh], k0w, 64)
                    acc_k, acc_v = torch.zeros(64, hd), torch.zeros(64, hd)
                    for g in range(G):
                        h = kvh * G + g
                        for tile in range(t0, t0 + n_tiles):
                            q0 = tile * TILE
                            p0 = q_offset + q0
                            p1 = q_offset + min(q0 + TILE, S) - 1
                            if not (k0w < T and (not causal or k0w <= p1)
                                    and (not window
                                         or p0 - (k0w + 63) < window)):
                                continue
                            qt = _rows(q[b, :, h], q0, TILE)
                            dot = _rows(do[b, :, h], q0, TILE)
                            # past S the card reads whatever follows: NaN
                            lt = _rows(lse[b, h], q0, TILE).clone()
                            dt = _rows(delta[b, h], q0, TILE).clone()
                            lt[max(0, S - q0):] = float("nan")
                            dt[max(0, S - q0):] = float("nan")
                            st = kw @ qt.T
                            dpt = vw @ dot.T
                            pt = torch.exp2(st * c - lt[None])
                            dst = pt * (dpt - dt[None])
                            edge = (k0w + 64 > T or q0 + TILE > S
                                    or (causal and k0w + 63 > p0)
                                    or (window and p0 + TILE - 1 - k0w
                                        >= window))
                            if edge:
                                qi = torch.arange(q0, q0 + TILE)
                                ok = _mask(keys, q_offset + qi, qi < S, T,
                                           causal, window)
                                pt = torch.where(ok, pt, torch.zeros(()))
                                dst = torch.where(ok, dst, torch.zeros(()))
                            acc_v += _prod(pt, dot, rnd, split[0])
                            acc_k += _prod(dst, qt, rnd, split[1])
                    n = min(64, T - k0w)
                    if n > 0:
                        dk[b, k0w:k0w + n, kvh] = acc_k[:n] / math.sqrt(hd)
                        dv[b, k0w:k0w + n, kvh] = acc_v[:n]
        for h in range(H):
            kvh = h // G
            # dQ: a CTA per kBlk queries, a consumer per 64 of them
            for q0 in range(0, S, BLK):
                kv_end = min(T, q_offset + min(q0 + BLK, S)) if causal else T
                j_end = -(-kv_end // TILE) if kv_end > 0 else 0
                lo = q_offset + q0 - window + 1 if window else 0
                j0 = (lo // TILE * TILE if lo > 0 else 0) // TILE
                for w in range(2):
                    r0 = q0 + 64 * w
                    my_end = (0 if r0 >= S else
                              min(T, q_offset + min(r0 + 64, S)) if causal
                              else T)
                    rows = torch.arange(r0, r0 + 64)
                    qw = _rows(q[b, :, h], r0, 64)
                    dow = _rows(do[b, :, h], r0, 64)
                    lr = torch.full((64,), float("inf"))
                    dr = torch.zeros(64)
                    n = max(0, min(64, S - r0))
                    lr[:n], dr[:n] = lse[b, h, r0:r0 + n], \
                        delta[b, h, r0:r0 + n]
                    acc = torch.zeros(64, hd)
                    for j in range(j0, j_end):
                        k0 = j * TILE
                        if not (k0 < my_end and (
                                not window
                                or k0 + TILE > q_offset + r0 - window + 1)):
                            continue
                        kt = _rows(k[b, :, kvh], k0, TILE)
                        vt = _rows(v[b, :, kvh], k0, TILE)
                        sc = qw @ kt.T
                        dp = dow @ vt.T
                        p = torch.exp2(sc * c - lr[:, None])
                        ds = p * (dp - dr[:, None])
                        edge = (k0 + TILE > T
                                or (causal and k0 + TILE - 1 > q_offset + r0)
                                or (window and q_offset + r0 + 63 - k0
                                    >= window))
                        if edge:
                            ok = _mask(torch.arange(k0, k0 + TILE),
                                       q_offset + rows,
                                       torch.ones(64, dtype=torch.bool), T,
                                       causal, window).T
                            ds = torch.where(ok, ds, torch.zeros(()))
                        acc += _prod(ds, kt, rnd, split[1])
                    if n:
                        dq[b, r0:r0 + n, h] = acc[:n] / math.sqrt(hd)
    return tuple(rnd(t) for t in (dq, dk, dv))
