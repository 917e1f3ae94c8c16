"""A float64 model of K5's backward schedule (``csrc/rwkv_scan_bwd.cu``)
and of the checkpoints the forward (``csrc/rwkv_scan.cu``) saves for it,
shared by ``test_torch_k5_bwd.py``.

The forward updates the state ``regroup`` tokens at a time (the two-token
regrouping at N 16 and 64: S_{t+1} = (w_{t+1} w_t) S_{t-1} + (w_{t+1} k_t)
v_t^T + k_{t+1} v_{t+1}^T, tokens past T read as zeros, whose decay is 1)
and saves the state before every ``chunk``-th token, a group boundary.

The backward runs in two kernels, on inputs padded to whole chunks as the
TMA's zero fill pads them (r, k, v, dy zero and logw 0 past T: decay 1,
nothing added):

* the carry: from the final state's cotangent, chunk by chunk from last to
  first, G before a chunk = diag(A) G_end + (P r)^T Dy, with P_s the
  product of w over the chunk's tokens before s and A over all of them; G
  at the end of every chunk is stored, and G before chunk 0 is the
  initial state's gradient;
* the chunks: one cluster per (batch, head, group of ``per_cta`` chunks),
  one rank per group of value columns and the same slice of rows, each
  chunk's gradients in closed form from its own checkpoint S0 and G_end
  (``chunk_grads``: every decay a product over an interval, never a
  quotient): each rank's partial products over its columns (S0 dy_s,
  G_end v_s, rowsum(G_end * S0), v_x . dy_t) and over its rows (M[s][t] =
  sum_i D(s,t) r_t k_s) are added over the ranks in ``order``, rank c
  forming dr, dk and dlogw of the c-th slice of rows; dv of its columns,
  (K Q)^T G_end in two levels (``dv_rows`` rows at a time, then those
  sums in order) plus M's terms; du per chunk, added over a group's
  chunks in order, then over (batch, group).

With the schedule as parameters (``Schedule``) the model must give the
exact gradient for any chunk length, chunks per group, ragged T (T % chunk
!= 0, T < chunk, T = 1, T = 0) and any number of column groups from 1 to
N; ``mutant`` plants one off-by-one fault (``MUTANTS``), which the
exact-gradient test must catch.
"""
import dataclasses

import numpy as np
import torch

# a checkpoint one token late; G decayed before a chunk's last token
# instead of after it; a rank's partial left out of the cluster sum; du of
# one batch only; G_end stored one chunk late in the carry (after the
# chunk's update); D_chunk applied after the chunk's rank-C update instead
# of before it; one rank's slice of rows never written; the ragged last
# chunk's du added twice
MUTANTS = ("late_checkpoint", "decay_before_last", "drop_group",
           "du_first_batch", "gend_late", "dchunk_wrong_side", "drop_slice",
           "du_ragged_twice")


@dataclasses.dataclass(frozen=True)
class Schedule:
    chunk: int = 16          # tokens between checkpoints (the kernel's 16)
    n_groups: int = 4        # column groups of a chunk: a cluster's ranks
    regroup: int = 2         # the forward's tokens per state update
    order: tuple = ()        # the ranks' order in the sum (default 0, 1..)
    per_cta: int = 4         # chunks a cluster walks (du added per group)
    dv_rows: int = 16        # dv's first level: rows summed in one block


def forward_checkpoints(k, v, logw, s0, chunk, regroup, late=False):
    """The forward's state before tokens 0, chunk, 2 chunk, ..., (B, H,
    n_chunks, N, N), computed ``regroup`` tokens a step as the kernel does;
    ``late``: each taken one token late (the mutant)."""
    assert chunk % regroup == 0, "a checkpoint must fall on a group boundary"
    B, T, H, N = k.shape
    n_chunks = -(-T // chunk)
    pad = -T % regroup
    kp, vp = (np.concatenate([a, np.zeros((B, pad, H, N))], 1)
              for a in (k, v))
    wp = np.concatenate([np.exp(logw), np.ones((B, pad, H, N))], 1)
    s, out = s0.copy(), []
    for t0 in range(0, T + pad, regroup):
        if t0 % chunk == 0:
            out.append(s.copy())
        # S <- (prod_g w_g) S + sum_g (prod_{x>g} w_x) k_g v_g^T
        add = np.zeros_like(s)
        for g in range(regroup):
            d = np.prod(wp[:, t0 + g + 1:t0 + regroup], axis=1)
            add += (d * kp[:, t0 + g])[..., None] * vp[:, t0 + g, :, None, :]
        s = np.prod(wp[:, t0:t0 + regroup], axis=1)[..., None] * s + add
    ck = (np.stack(out, 2) if out else np.zeros((B, H, 0, N, N)))
    if late:
        for c in range(n_chunks):
            t = c * chunk
            if t < T:
                ck[:, :, c] = np.exp(logw[:, t])[..., None] * ck[:, :, c] + \
                    k[:, t, :, :, None] * v[:, t, :, None, :]
    return ck


def _padded(a, T_pad):
    """``a`` (B, T, H, N) with zero tokens up to T_pad (the TMA's fill)."""
    B, T, H, N = a.shape
    return np.concatenate([a, np.zeros((B, T_pad - T, H, N))], 1)


def carry(r, logw, dy, ds, sched, mutant=None):
    """The carry kernel: ``(gend, ds0)``, gend (B, H, n_chunks, N, N) the
    cotangent of the state after each chunk, ds0 the initial state's
    gradient."""
    B, T, H, N = r.shape
    C = sched.chunk
    n_chunks = -(-T // C)
    rp, lp, dp = (_padded(a, n_chunks * C) for a in (r, logw, dy))
    gend = np.zeros((B, H, n_chunks, N, N))
    g = ds.copy()
    for c in reversed(range(n_chunks)):
        if mutant != "gend_late":
            gend[:, :, c] = g
        w = np.exp(lp[:, c * C:(c + 1) * C])               # (B, C, H, N)
        d = np.concatenate([np.ones_like(w[:, :1]),
                            np.cumprod(w, axis=1)[:, :-1]], 1)
        d_chunk = np.prod(w, axis=1)                       # (B, H, N)
        a = d * rp[:, c * C:(c + 1) * C]
        update = np.einsum("bthi,bthj->bhij", a, dp[:, c * C:(c + 1) * C])
        if mutant == "dchunk_wrong_side":
            g = d_chunk[..., None] * (g + update)
        else:
            g = d_chunk[..., None] * g + update
        if mutant == "gend_late":
            gend[:, :, c] = g
    return gend, g


def _decays(w):
    """D[..., x, y] = prod_{x<z<y} w_z for x < y (1 for y = x + 1), 0
    elsewhere, from w (B, C, H, N): (B, H, N, C, C)."""
    B, C, H, N = w.shape
    wt = w.transpose(0, 2, 3, 1)                           # (B, H, N, C)
    D = np.zeros((B, H, N, C, C))
    for x in range(C):
        d = np.ones((B, H, N))
        for y in range(x + 1, C):
            D[..., x, y] = d
            d = d * wt[..., y]
    return D


def chunk_grads(rr, kk, vv, ww, dd, u, s0, ge, sched, mutant=None):
    """One chunk's gradients from its checkpoint ``s0`` and the cotangent
    ``ge`` of the state after its last token, as the chunk kernel's
    cluster forms them: the inputs (B, C, H, N) padded, w = exp(logw).
    Returns ``(dr, dk, dlogw, dv, du (B, H, N))``."""
    B, C, H, N = rr.shape
    G = sched.n_groups
    cols = np.array_split(np.arange(N), G)     # rank c: columns c
    rows = np.array_split(np.arange(N), G)     # ... and its slice of rows
    order = sched.order or tuple(range(G))
    used = order[:-1] if mutant == "drop_group" else order
    w = ww
    P = np.concatenate([np.ones_like(w[:, :1]),
                        np.cumprod(w, axis=1)[:, :-1]], 1)  # prod_{y<s}
    Q = np.concatenate([np.cumprod(w[:, ::-1], axis=1)[:, ::-1][:, 1:],
                        np.ones_like(w[:, :1])], 1)          # prod_{y>s}
    if mutant == "decay_before_last":          # G_end decayed once early
        Q[:, -1] = w[:, -1]
    A = np.prod(w, axis=1)                                   # (B, H, N)
    D = _decays(w)                                           # (B,H,N,C,C)
    # each rank's partials over its columns: S0 dy_s, G_end v_s,
    # sum_j G_end S0 and v_x . dy_s
    x1p, x2p, x3p, vdp = {}, {}, {}, {}
    for g, js in enumerate(cols):
        x1p[g] = np.einsum("bhij,bshj->bshi", s0[..., js], dd[..., js])
        x2p[g] = np.einsum("bhij,bshj->bshi", ge[..., js], vv[..., js])
        x3p[g] = (ge[..., js] * s0[..., js]).sum(-1)
        vdp[g] = np.einsum("bxhj,bshj->bhxs", vv[..., js], dd[..., js])
    # and over its rows: M[s][tau] = sum_i D(s, tau) r_tau k_s (tau > s),
    # M[s][s] = sum_i u_i r_s k_s
    mp = {}
    for g, ii in enumerate(rows):
        m = np.einsum("bhist,bthi,bshi->bhst", D[:, :, ii],
                      rr[..., ii], kk[..., ii])
        diag = np.einsum("hi,bshi,bshi->bhs", u[:, ii], rr[..., ii],
                         kk[..., ii])
        m[..., np.arange(C), np.arange(C)] = diag
        mp[g] = m
    x1, x2, x3, vd = (sum(part[g] for g in used)
                      for part in (x1p, x2p, x3p, vdp))
    M = sum(mp[g] for g in order)
    tri = np.triu(np.ones((C, C)), 1)                        # x < y
    vdd = vd[..., np.arange(C), np.arange(C)]                # (B, H, C)
    kt, rt = (a.transpose(0, 2, 3, 1) for a in (kk, rr))     # (B, H, N, C)
    # dr_s = P_s (S0 dy_s) + sum_{x<s} D(x,s) k_x VD[x][s] + u k_s VD[s][s]
    dr = P * x1 + np.einsum("bhixs,bhix,bhxs->bshi", D * tri, kt,
                            vd) + u * kk * vdd.transpose(0, 2, 1)[..., None]
    # dk_s = Q_s (G_end v_s) + sum_{t>s} D(s,t) r_t VD[s][t] + u r_s VD[s][s]
    dk = Q * x2 + np.einsum("bhist,bhit,bhst->bshi", D * tri, rt,
                            vd) + u * rr * vdd.transpose(0, 2, 1)[..., None]
    # dlogw_s = A X3 + sum_{x<s} Q_x k_x X2_x + sum_{t>s} P_t r_t X1_t
    #         + sum_{x<s<t} D(x,t) k_x r_t VD[x][t]
    before = np.tril(np.ones((C, C)), -1)                    # [s][x]: x < s
    after = np.triu(np.ones((C, C)), 1)                      # [s][t]: t > s
    dw = (A * x3)[:, None] + \
        np.einsum("sx,bxhi->bshi", before, Q * kk * x2) + \
        np.einsum("st,bthi->bshi", after, P * rr * x1)
    between = np.einsum("sx,st->sxt", before, after)         # x < s < t
    dw = dw + np.einsum("sxt,bhixt,bhix,bhit,bhxt->bshi", between, D, kt,
                        rt, vd)
    # dv_s[j] = sum_i k_s Q_s G_end[i][j] (rows in ``dv_rows`` blocks, the
    # blocks in order) + sum_{t>=s} M[s][t] dy_t[j]
    kq = kk * Q
    dv = sum(np.einsum("bshi,bhij->bshj", kq[..., i0:i0 + sched.dv_rows],
                       ge[:, :, i0:i0 + sched.dv_rows])
             for i0 in range(0, N, sched.dv_rows))
    dv = dv + np.einsum("bhst,bthj->bshj", M * np.triu(np.ones((C, C))),
                        dd)
    for ii in rows[-1:] if mutant == "drop_slice" else ():
        for a in (dr, dk, dw):
            a[..., ii] = 0.0
    du = (rr * kk * vdd.transpose(0, 2, 1)[..., None]).sum(1)
    return dr, dk, dw, dv, du


def bwd_model(r, k, v, logw, u, s0, dy, ds, sched=Schedule(), mutant=None):
    """K5's backward on float64 numpy arrays (B, T, H, N), u (H, N), s0 and
    ds (B, H, N, N) with ``sched``: ``(dr, dk, dv, dlogw, du, ds0)``."""
    B, T, H, N = r.shape
    C, K = sched.chunk, sched.per_cta
    n_chunks = -(-T // C)
    Tp = n_chunks * C
    ck = forward_checkpoints(k, v, logw, s0, C, sched.regroup,
                             late=mutant == "late_checkpoint")
    gend, ds0 = carry(r, logw, dy, ds, sched, mutant)
    rp, kp, vp, lp, dp = (_padded(a, Tp) for a in (r, k, v, logw, dy))
    w = np.exp(lp)
    dr, dk, dv, dlogw = (np.zeros((B, Tp, H, N)) for _ in range(4))
    du_part = np.zeros((B, -(-n_chunks // K), H, N))
    for p in range(du_part.shape[1]):
        for c in range(p * K, min((p + 1) * K, n_chunks)):
            sl = slice(c * C, (c + 1) * C)
            a, b_, dw, dvc, duc = chunk_grads(
                rp[:, sl], kp[:, sl], vp[:, sl], w[:, sl], dp[:, sl], u,
                ck[:, :, c], gend[:, :, c], sched, mutant)
            dr[:, sl], dk[:, sl], dlogw[:, sl], dv[:, sl] = a, b_, dw, dvc
            times = 2 if mutant == "du_ragged_twice" and T % C and \
                c == n_chunks - 1 else 1
            du_part[:, p] += times * duc
    du = np.zeros((H, N))
    for b in range(1 if mutant == "du_first_batch" else B):
        for p in range(du_part.shape[1]):
            du += du_part[b, p]
    return dr[:, :T], dk[:, :T], dv[:, :T], dlogw[:, :T], du, ds0


def exact_grads(r, k, v, logw, u, s0, dy, ds):
    """The gradient of the exact per-token recurrence by float64 autograd:
    ``(dr, dk, dv, dlogw, du, ds0)``, du summed over the batch."""
    ins = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
           for a in (r, k, v, logw, u, s0)]
    rr, kk, vv, lw, uu, s = ins
    B, T, H, N = r.shape
    loss = 0.0
    for t in range(T):
        a = kk[:, t, :, :, None] * vv[:, t, :, None, :]
        y = torch.einsum("bhk,bhkn->bhn", rr[:, t], s + uu[..., None] * a)
        loss = loss + (y * torch.from_numpy(dy[:, t])).sum()
        s = torch.exp(lw[:, t])[..., None] * s + a
    loss = loss + (s * torch.from_numpy(ds)).sum()
    grads = torch.autograd.grad(loss, ins, allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr
             for t, gr in zip(ins, grads)]
    return tuple(gr.detach().numpy() for gr in grads)
