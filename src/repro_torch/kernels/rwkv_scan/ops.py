"""Wrapper for the WKV6 scan kernel (K5) that RWKV-6 prefill runs.

On CUDA tensors ``wkv`` launches ``csrc/rwkv_scan.cu`` (one CTA per
(batch, head), tokens staged by TMA, two tokens per state update) and
counts the launch in ``launches``; on CPU tensors it runs the plain version
(``ref.py``, the exact sequential recurrence); anything else raises, and so
does a CUDA tensor in a form the kernel does not take.

The kernel has no backward yet: on the card, with grad enabled and an
input that requires grad, ``wkv`` raises ``NotImplementedError`` rather
than return a result cut from the autograd graph.  On the CPU autograd
runs through the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv_scan.ref import wkv_ref

launches = 0    # kernel launches since the last reset (chip_smoke reads it)
HEAD_SIZES = (8, 16, 32, 64)
ALIGN = 16    # bytes

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = build.load("rwkv_scan")
    lib.helios_wkv6.argtypes = _ARGS
    lib.helios_wkv6.restype = ctypes.c_int
    return lib


def _check(r, k, v, logw, u, state) -> None:
    """Raise unless the CUDA kernel takes these tensors as they are."""
    ts = [r, k, v, logw, u] + ([] if state is None else [state])
    if any(t.device != r.device for t in ts) or r.device.type != "cuda":
        raise ValueError("wkv: tensors on " + ", ".join(
            str(t.device) for t in ts) + "; all must be on one CUDA device "
            "(or all on the CPU)")
    _check_forms(r, k, v, logw, u, state)


def _check_forms(r, k, v, logw, u, state) -> None:
    """Raise unless the kernel takes the tensors' shapes, dtypes and
    layouts."""
    ts = [r, k, v, logw, u] + ([] if state is None else [state])
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"wkv: r, k, v, logw must share one (B, T, H, N) "
                         f"shape; got {[tuple(t.shape) for t in ts[:4]]}")
    B, T, H, N = r.shape
    if u.shape != (H, N):
        raise ValueError(f"wkv: u {tuple(u.shape)} is not (H, N) = {(H, N)}")
    if state is not None and state.shape != (B, H, N, N):
        raise ValueError(f"wkv: state {tuple(state.shape)} is not "
                         f"(B, H, N, N) = {(B, H, N, N)}")
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv: head size {N} is not one of {HEAD_SIZES}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("wkv: every input must be float32; got "
                        + ", ".join(str(t.dtype) for t in ts))
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("wkv: every input must be contiguous")
    if any(t.data_ptr() % ALIGN for t in ts):
        raise ValueError(f"wkv: every input must start at a {ALIGN}-byte-"
                         "aligned address (the kernel stages tokens with "
                         "TMA)")


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor | None = None):
    """r, k, v, logw: (B, T, H, N) float32; u: (H, N); state: (B, H, N, N)
    [key x value] or None (zeros).  Returns (y (B, T, H, N), final state
    (B, H, N, N)), float32; any T, no padding, so the final state is the
    state after token T - 1."""
    global launches
    ts = (r, k, v, logw, u) if state is None else (r, k, v, logw, u, state)
    if all(t.device.type == "cpu" for t in ts):
        return wkv_ref(r, k, v, logw, u, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "wkv: K5 has no backward kernel yet (ROADMAP.md queue 1: K5's "
            "backward, then rwkv6-7b training on the card); on the card it "
            "runs only without grad (torch.no_grad) or on inputs that do not "
            "require grad")
    _check(r, k, v, logw, u, state)
    B, T, H, N = r.shape
    s_in = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
            if state is None else state)
    y = torch.empty_like(r)
    s_out = torch.empty_like(s_in)
    if B * H == 0:
        return y, s_out
    lib = _lib()
    rc = lib.helios_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), s_in.data_ptr(), y.data_ptr(), s_out.data_ptr(),
        B, T, H, N, torch.cuda.current_stream(r.device).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"wkv: no TMA descriptor for r/k/v/logw (CUresult "
                           f"{-rc}; 1000: the driver has no "
                           "cuTensorMapEncodeTiled)")
    build.check(lib, rc, "wkv")
    launches += 1
    return y, s_out
