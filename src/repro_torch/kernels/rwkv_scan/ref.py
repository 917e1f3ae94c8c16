"""Plain PyTorch versions of the WKV6 scan kernel (K5) and its backward:
the exact sequential recurrence, one step per token
(``repro.kernels.rwkv_scan.ref.wkv_ref``, in the model's layout, with an
initial and a final state), the states it passes at every 16th token (what
the forward kernel saves), and its gradient (``wkv_bwd_ref``)."""
import torch


def wkv_ref(r, k, v, logw, u, state=None):
    """r, k, v, logw: (B, T, H, N) float32 (logw is the per-channel log
    decay, < 0); u: (H, N); state: (B, H, N, N) [key x value] or None for
    zeros.  For each token t:

        y_t = r_t . (S + u * k_t^T v_t);   S <- exp(logw_t) * S + k_t^T v_t

    Returns (y (B, T, H, N), final state (B, H, N, N)), float32."""
    B, T, H, N = r.shape
    s = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    ys = []
    for t in range(T):
        a = k[:, t, :, :, None] * v[:, t, :, None, :]           # (B,H,N,N)
        ys.append(torch.einsum("bhk,bhkn->bhn", r[:, t],
                               s + u[None, :, :, None] * a))
        s = torch.exp(logw[:, t])[..., None] * s + a
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((B, 0, H, N), dtype=torch.float32, device=r.device))
    return y, s


def checkpoints_ref(k, v, logw, state=None, every=16):
    """The state before tokens 0, ``every``, 2 ``every``, ... of the
    recurrence above, (B, H, ceil(T / every), N, N) float32: what the
    forward kernel saves for the backward."""
    B, T, H, N = k.shape
    s = (torch.zeros((B, H, N, N), dtype=torch.float32, device=k.device)
         if state is None else state.float())
    out = []
    for t in range(T):
        if t % every == 0:
            out.append(s)
        s = torch.exp(logw[:, t])[..., None] * s + \
            k[:, t, :, :, None] * v[:, t, :, None, :]
    if not out:
        return torch.zeros((B, H, 0, N, N), dtype=torch.float32,
                           device=k.device)
    return torch.stack(out, dim=2)


def wkv_bwd_ref(r, k, v, logw, u, state, dy, dstate, chunk=64):
    """The gradient of ``wkv_ref(r, k, v, logw, u, state)`` given the
    cotangents ``dy`` of y (B, T, H, N) and ``dstate`` of the final state
    (B, H, N, N; None for zeros): ``(dr, dk, dv, dlogw, du, dstate0)``,
    float32, du (H, N) summed over the batch, dstate0 the initial state's
    gradient (also where ``state`` is None, zeros).  With S_{t-1} the state
    before token t, w_t = exp(logw_t) and G_t the cotangent of S_t
    (G_{T-1} = dstate), for t = T-1 down to 0:

        dr_t    = (S_{t-1} + u k_t v_t^T) dy_t
        dk_t    = (G_t + u r_t dy_t^T) v_t
        dv_t    = (G_t + u r_t dy_t^T)^T k_t
        dlogw_t = w_t * rowsum(G_t * S_{t-1})
        du     += r_t k_t (v_t . dy_t)
        G_{t-1} = diag(w_t) G_t + r_t dy_t^T

    and dstate0 = G_{-1}.  The states come from a forward that keeps the
    state every ``chunk`` tokens; each chunk's states are recomputed from
    there, the chunks walked backwards (never S_{t-1} from S_t: that
    divides by w_t, 2e-9 at logw -20).  Elementwise products and sums, no
    matrix product, so no TF32 setting reaches it.  Not autograd: the
    plain version of the backward kernel."""
    B, T, H, N = r.shape
    f32 = torch.float32
    w = torch.exp(logw.float())
    starts = checkpoints_ref(k, v, logw, state, chunk)
    g = (torch.zeros((B, H, N, N), dtype=f32, device=r.device)
         if dstate is None else dstate.float().clone())
    dr, dk, dv, dlogw = (torch.empty((B, T, H, N), dtype=f32,
                                     device=r.device) for _ in range(4))
    du = torch.zeros((H, N), dtype=f32, device=r.device)
    uu = u.float()[None, None]                       # (1, 1, H, N)
    for c in reversed(range(starts.shape[2])):
        t0, t1 = c * chunk, min(T, (c + 1) * chunk)
        s, prev = starts[:, :, c], []
        for t in range(t0, t1):
            prev.append(s)
            s = w[:, t, ..., None] * s + k[:, t, :, :, None] * v[:, t, :,
                                                                 None, :]
        gs = []
        for t in reversed(range(t0, t1)):
            gs.append(g)
            g = w[:, t, ..., None] * g + r[:, t, :, :, None] * dy[:, t, :,
                                                                  None, :]
        sp = torch.stack(prev, dim=1)                # (B, n, H, N, N)
        gt = torch.stack(gs[::-1], dim=1)
        rr, kk, vv, dd, ww = (a[:, t0:t1].float() for a in (r, k, v, dy, w))
        vdy = (vv * dd).sum(-1, keepdim=True)
        dr[:, t0:t1] = (sp * dd[..., None, :]).sum(-1) + uu * kk * vdy
        dk[:, t0:t1] = (gt * vv[..., None, :]).sum(-1) + uu * rr * vdy
        dv[:, t0:t1] = (gt * kk[..., None]).sum(-2) + \
            (uu * rr * kk).sum(-1, keepdim=True) * dd
        dlogw[:, t0:t1] = ww * (gt * sp).sum(-1)
        du += (rr * kk * vdy).sum((0, 1))
    return dr, dk, dv, dlogw, du, g
