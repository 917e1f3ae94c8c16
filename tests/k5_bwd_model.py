"""A float64 model of K5's backward schedule (``csrc/rwkv_scan_bwd.cu``)
and of the checkpoints the forward (``csrc/rwkv_scan.cu``) saves for it,
shared by ``test_torch_k5_bwd.py``.

The forward updates the state ``regroup`` tokens at a time (the two-token
regrouping at N 16 and 64: S_{t+1} = (w_{t+1} w_t) S_{t-1} + (w_{t+1} k_t)
v_t^T + k_{t+1} v_{t+1}^T, tokens past T read as zeros, whose decay is 1)
and saves the state before every ``chunk``-th token, a group boundary.
The backward runs one CTA per (batch, head, group of value columns): the
chunks from last to first, sweep 1 recomputing the chunk's states token by
token from its checkpoint, sweep 2 walking it backwards with G_t, each
group's partial sums of dr, dk and dlogw (and of du, over its tokens)
added over the groups in ``order``, then du over the batch.  With the
schedule as parameters (``Schedule``) the model must give the exact
gradient for any chunk length, ragged T (T % chunk != 0, T < chunk, T = 1,
T = 0) and any number of column groups from 1 to N; ``mutant`` plants one
off-by-one fault (``MUTANTS``), which the exact-gradient test must catch.
"""
import dataclasses

import numpy as np
import torch

MUTANTS = ("late_checkpoint", "decay_before_last", "drop_group",
           "du_first_batch")


@dataclasses.dataclass(frozen=True)
class Schedule:
    chunk: int = 16          # tokens between checkpoints (the kernel's 16)
    n_groups: int = 4        # CTAs per (batch, head), each a column group
    regroup: int = 2         # the forward's tokens per state update
    order: tuple = ()        # the groups' order in the sum (default 0, 1..)


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


def bwd_model(r, k, v, logw, u, s0, dy, ds, sched=Schedule(), mutant=None):
    """K5's backward on float64 numpy arrays (B, T, H, N), u (H, N), s0 and
    ds (B, H, N, N) with ``sched``: ``(dr, dk, dv, dlogw, du, ds0)``."""
    B, T, H, N = r.shape
    C = sched.chunk
    cols = np.array_split(np.arange(N), sched.n_groups)
    order = sched.order or tuple(range(sched.n_groups))
    ck = forward_checkpoints(k, v, logw, s0, C, sched.regroup,
                             late=mutant == "late_checkpoint")
    w = np.exp(logw)
    dv = np.zeros((B, T, H, N))
    ds0 = np.zeros((B, H, N, N))
    parts = {}          # group -> (dr, dk, dlogw, du (B, H, N))
    for gi, js in enumerate(cols):
        pr, pk, pw = (np.zeros((B, T, H, N)) for _ in range(3))
        pu = np.zeros((B, H, N))
        g = ds[..., js].copy()                     # (B, H, N, |js|)
        for c in reversed(range(ck.shape[2])):
            t0, n = c * C, min(C, T - c * C)
            st, prev = ck[:, :, c][..., js].copy(), []
            for s in range(n):                     # sweep 1
                t = t0 + s
                prev.append(st.copy())
                st = w[:, t, ..., None] * st + \
                    k[:, t, :, :, None] * v[:, t][..., None, js]
            for s in reversed(range(n)):           # sweep 2
                t = t0 + s
                rt, kt, wt = r[:, t], k[:, t], w[:, t]
                vt, dt = v[:, t][..., js], dy[:, t][..., js]
                if mutant == "decay_before_last" and s == n - 1:
                    g = wt[..., None] * g + rt[..., None] * dt[..., None, :]
                sp = prev[s]
                vdy = (vt * dt).sum(-1)            # the group's columns
                pr[:, t] = (sp * dt[..., None, :]).sum(-1) + \
                    u * kt * vdy[..., None]
                pk[:, t] = (g * vt[..., None, :]).sum(-1) + \
                    u * rt * vdy[..., None]
                pw[:, t] = wt * (g * sp).sum(-1)
                pu += rt * kt * vdy[..., None]
                b = (u * rt * kt).sum(-1)
                dv[:, t][..., js] = (g * kt[..., None]).sum(-2) + \
                    b[..., None] * dt
                if not (mutant == "decay_before_last" and s == n - 1):
                    g = wt[..., None] * g + rt[..., None] * dt[..., None, :]
        ds0[..., js] = g
        parts[gi] = (pr, pk, pw, pu)
    used = order[:-1] if mutant == "drop_group" else order
    dr, dk, dlogw = (sum(parts[gi][x] for gi in used) for x in range(3))
    du = np.zeros((H, N))
    for b in range(1 if mutant == "du_first_batch" else B):
        for gi in used:
            du += parts[gi][3][b]
    return dr, dk, dv, dlogw, du, ds0


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
