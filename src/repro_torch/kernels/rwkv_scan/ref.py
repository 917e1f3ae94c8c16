"""Plain PyTorch version of the WKV6 scan kernel (K5): the exact sequential
recurrence, one step per token (``repro.kernels.rwkv_scan.ref.wkv_ref``,
in the model's layout, with an initial and a final state)."""
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
