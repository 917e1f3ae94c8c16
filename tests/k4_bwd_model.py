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

The schedule follows the head width (``Schedule``, ``schedule_for``): at
hd 64-128 a dK/dV CTA holds 128 keys, 64 a consumer, over 64-query
tiles, and a dQ CTA 128 queries over 64-key tiles; at hd 256 a dK/dV CTA
holds 64 keys that both consumers share, each owning half the head's
columns, its kv head's query heads split into head groups
(``ops.bwd_head_groups``) whose float32 sums are added in group order,
and a dQ CTA 128 queries over 32-key tiles.  ``mutant`` plants one
off-by-one fault in the schedule (``MUTANTS``), which the exact-gradient
test must catch.

``K4_BWD_TOL``, ``K4_BWD_FLOOR`` and ``K4_BWD_LARGEST`` are chip_smoke.py's
limits of the same names (entry by entry, |got - want| <= rtol |want| +
atol mean|want| + floor, per gradient; the largest |got - want| within a
share of the largest |want|, or of 1 where that is smaller).
"""
import dataclasses
import math

import torch

from repro_torch.kernels.flash_attention.ops import bwd_head_groups
from repro_torch.kernels.flash_attention.ref import lse_ref, visible

K4_BWD_TOL = {"float32": (1e-5, (1e-3, 1e-3, 1e-3)),
              "bfloat16": (2 ** -6, (2 ** -2, 2 ** -2, 2 ** -8))}
K4_BWD_FLOOR = 1e-4
K4_BWD_LARGEST = {"float32": 1e-4, "bfloat16": 2e-2}

LOG2E = 1.4426950408889634
N_SM = 132               # the H100's SMs, for the head-group rule


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The tile schedule of the tensor-core kernels at one head width."""
    keys: int          # resident keys per dK/dV CTA
    col_split: bool    # both consumers share the keys, each half the columns
    q_tile: int        # queries per streamed dK/dV tile
    q_blk: int         # resident queries per dQ CTA (64 per consumer)
    k_tile: int        # keys per streamed dQ tile


SCHEDULES = {"narrow": Schedule(128, False, 64, 128, 64),   # hd 64-128
             "wide": Schedule(64, True, 64, 128, 32)}       # hd 256

# planted faults: the first or last query tile of a dK/dV CTA, the first or
# last key tile of a dQ CTA, a head group left out of the ordered sum, a
# group's last head dropped, the window's seam off by one in the masks
MUTANTS = ("dkdv_first_tile", "dkdv_last_tile", "dq_first_tile",
           "dq_last_tile", "group_left_out", "group_head_short",
           "window_seam")


def schedule_for(hd):
    return SCHEDULES["wide" if hd == 256 else "narrow"]


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


def _mask(keys, pos, S_ok, T, causal, window, mutant=None):
    """(len(keys), len(pos)) bool: key t is seen from position p (and the
    query lies before S and the key before T)."""
    t, p = keys[:, None], pos[None, :]
    ok = (t < T) & S_ok[None, :]
    if causal:
        ok &= t <= p
    if window:
        ok &= (p - t <= window) if mutant == "window_seam" else (p - t
                                                                 < window)
    return ok


def bwd_model(q, k, v, do, causal=True, q_offset=0, window=0,
              rounding=True, split=(True, False), groups=None,
              mutant=None):
    """(dq, dk, dv) in float32 as the tensor-core kernels compute them from
    float32 inputs that hold bf16 values (q, k, v, do: (B, S, H, hd) and
    (B, T, K, hd)).  Outputs rounded to bf16 unless ``rounding`` is off,
    which also drops the rounding of P and dS and takes the plain
    version's float32 output for delta.  ``split``: (P for dV, dS for dK
    and dQ) as a bf16 pair hi + lo, two products each, else rounded once;
    the kernels split P only.  ``groups``: the head groups of the dK/dV
    kernel at hd 256 (default ``ops.bwd_head_groups`` on ``N_SM`` SMs);
    ``mutant``: one of ``MUTANTS``."""
    rnd = _bf if rounding else (lambda x: x)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    sch = schedule_for(hd)
    if groups is None:
        groups = bwd_head_groups(B, T, K, G, hd, N_SM)
    c = LOG2E / math.sqrt(hd)
    if rounding:
        o = forward_out(q, k, v, causal, q_offset, window)
    else:
        from repro_torch.kernels.flash_attention.ref import attention_ref
        o = attention_ref(q, k, v, causal, q_offset, window)
    lse = lse_ref(q, k, causal, q_offset, window)             # (B, H, S)
    delta = (do * o).sum(-1).permute(0, 2, 1)                 # (B, H, S)
    args = (q, k, v, do, lse, delta, causal, q_offset, window, c, rnd, split,
            sch, mutant)
    dk, dv = _dkdv(*args, groups)
    dq = _dq(*args)
    return tuple(rnd(t) for t in (dq, dk, dv))


def _dkdv(q, k, v, do, lse, delta, causal, q_offset, window, c, rnd, split,
          sch, mutant, groups):
    """dk, dv in float32 (unrounded): a CTA per (batch, kv head, head group,
    ``sch.keys`` keys); its consumers take 64 keys each, or (``col_split``)
    all of them at half the columns each; groups' sums added in order."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G, QT = H // K, sch.q_tile
    dk = torch.zeros(B, T, K, hd)
    dv = torch.zeros(B, T, K, hd)
    halves = ((0, hd // 2), (hd // 2, hd)) if sch.col_split else ((0, hd),)
    for b in range(B):
        for kvh in range(K):
            for n0 in range(0, T, sch.keys):
                s_lo = max(0, n0 - q_offset) if causal else 0
                s_hi = (min(S, n0 + sch.keys - 1 + window - q_offset)
                        if window else S)
                t0 = s_lo // QT
                n_tiles = max(0, -(-max(s_hi, 0) // QT) - t0)
                if mutant == "dkdv_first_tile":
                    t0, n_tiles = t0 + 1, n_tiles - 1
                elif mutant == "dkdv_last_tile":
                    n_tiles -= 1
                firsts = ([n0] if sch.col_split
                          else [n0 + 64 * w for w in range(sch.keys // 64)])
                parts = []
                for grp in range(groups):
                    g_lo, g_hi = G * grp // groups, G * (grp + 1) // groups
                    if mutant == "group_head_short":
                        g_hi -= 1
                    acc_k = torch.zeros(sch.keys, hd)
                    acc_v = torch.zeros(sch.keys, hd)
                    for k0w in firsts:
                        nk = 64 if not sch.col_split else sch.keys
                        keys = torch.arange(k0w, k0w + nk)
                        kw = _rows(k[b, :, kvh], k0w, nk)
                        vw = _rows(v[b, :, kvh], k0w, nk)
                        for g in range(g_lo, g_hi):
                            h = kvh * G + g
                            for tile in range(t0, t0 + n_tiles):
                                q0 = tile * QT
                                p0 = q_offset + q0
                                p1 = q_offset + min(q0 + QT, S) - 1
                                if not (k0w < T and (not causal or k0w <= p1)
                                        and (not window or
                                             p0 - (k0w + nk - 1) < window)):
                                    continue
                                qt = _rows(q[b, :, h], q0, QT)
                                dot = _rows(do[b, :, h], q0, QT)
                                # past S the card reads whatever follows: NaN
                                lt = _rows(lse[b, h], q0, QT).clone()
                                dt = _rows(delta[b, h], q0, QT).clone()
                                lt[max(0, S - q0):] = float("nan")
                                dt[max(0, S - q0):] = float("nan")
                                st = kw @ qt.T
                                dpt = vw @ dot.T
                                pt = torch.exp2(st * c - lt[None])
                                dst = pt * (dpt - dt[None])
                                edge = (k0w + nk > T or q0 + QT > S
                                        or (causal and k0w + nk - 1 > p0)
                                        or (window and p0 + QT - 1 - k0w
                                            >= window))
                                if edge:
                                    qi = torch.arange(q0, q0 + QT)
                                    ok = _mask(keys, q_offset + qi, qi < S,
                                               T, causal, window, mutant)
                                    pt = torch.where(ok, pt, torch.zeros(()))
                                    dst = torch.where(ok, dst,
                                                      torch.zeros(()))
                                # each consumer its columns (all of them
                                # without the split)
                                r = slice(k0w - n0, k0w - n0 + nk)
                                for lo, hi in halves:
                                    acc_v[r, lo:hi] += _prod(
                                        pt, dot[:, lo:hi], rnd, split[0])
                                    acc_k[r, lo:hi] += _prod(
                                        dst, qt[:, lo:hi], rnd, split[1])
                    parts.append((acc_k, acc_v))
                if mutant == "group_left_out" and len(parts) > 1:
                    parts = parts[:-1]
                sum_k, sum_v = parts[0]
                for pk, pv in parts[1:]:          # in group order
                    sum_k, sum_v = sum_k + pk, sum_v + pv
                n = min(sch.keys, T - n0)
                dk[b, n0:n0 + n, kvh] = sum_k[:n] / math.sqrt(hd)
                dv[b, n0:n0 + n, kvh] = sum_v[:n]
    return dk, dv


def _dq(q, k, v, do, lse, delta, causal, q_offset, window, c, rnd, split,
        sch, mutant):
    """dq in float32 (unrounded): a CTA per (batch, head, ``sch.q_blk``
    queries), a consumer per 64 of them, over tiles of ``sch.k_tile``
    keys."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G, KT = H // K, sch.k_tile
    dq = torch.zeros(B, S, H, hd)
    for b in range(B):
        for h in range(H):
            kvh = h // G
            for q0 in range(0, S, sch.q_blk):
                kv_end = (min(T, q_offset + min(q0 + sch.q_blk, S)) if causal
                          else T)
                j_end = -(-kv_end // KT) if kv_end > 0 else 0
                lo = q_offset + q0 - window + 1 if window else 0
                j0 = (lo // KT * KT if lo > 0 else 0) // KT
                if mutant == "dq_first_tile":
                    j0 += 1
                elif mutant == "dq_last_tile":
                    j_end -= 1
                for w in range(sch.q_blk // 64):
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
                        k0 = j * KT
                        if not (k0 < my_end and (
                                not window
                                or k0 + KT > q_offset + r0 - window + 1)):
                            continue
                        kt = _rows(k[b, :, kvh], k0, KT)
                        vt = _rows(v[b, :, kvh], k0, KT)
                        sc = qw @ kt.T
                        dp = dow @ vt.T
                        p = torch.exp2(sc * c - lr[:, None])
                        ds = p * (dp - dr[:, None])
                        edge = (k0 + KT > T
                                or (causal and k0 + KT - 1 > q_offset + r0)
                                or (window and q_offset + r0 + 63 - k0
                                    >= window))
                        if edge:
                            ok = _mask(torch.arange(k0, k0 + KT),
                                       q_offset + rows,
                                       torch.ones(64, dtype=torch.bool), T,
                                       causal, window, mutant).T
                            ds = torch.where(ok, ds, torch.zeros(()))
                        acc += _prod(ds, kt, rnd, split[1])
                    if n:
                        dq[b, r0:r0 + n, h] = acc[:n] / math.sqrt(hd)
    return dq
