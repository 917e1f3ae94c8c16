"""Wrapper for the flash-attention kernel (K4) that prefill attention runs.

On CUDA tensors ``flash_attention`` launches ``csrc/flash_attention.cu``
and counts the launch in ``launches``; on CPU tensors it runs the plain
version (``ref.py``); anything else raises, and so does a CUDA tensor in a
form the kernel does not take.  The kernel reads q, k and v in the model's
own ``(B, S, H, hd)`` layout through their strides (no copy); only the
head dimension must be contiguous.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0    # kernel launches since the last reset (chip_smoke reads it)
HEAD_DIMS = (8, 16, 32, 64, 80, 128)

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 9
         + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.helios_flash_attention.argtypes = _ARGS
    lib.helios_flash_attention.restype = ctypes.c_int
    return lib


def _check(q, k, v) -> None:
    """Raise unless the CUDA kernel takes (q, k, v) as they are."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device},"
                         f" v on {v.device}; all must be on one CUDA device "
                         "(or all on the CPU)")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device}; expected "
                         "a CUDA device or the CPU")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} must be "
                         f"(B, S, H, hd) and k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} equal (B, T, K, hd)")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)} (batch, head dim, H % K)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} is not one of "
                         f"{HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; all float32 or all bfloat16")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dimension of q, k and v "
                         "must be contiguous (stride 1)")
    if k.shape[1] == 0:
        raise ValueError("flash_attention: no keys (T == 0)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, T, K, hd), H % K == 0, float32 or
    bfloat16.  Returns softmax(q k^T / sqrt(hd)) v as (B, S, H, hd) in q's
    dtype; scores, softmax and P.V in float32.  ``causal``: query i sits at
    absolute position ``q_offset + i`` and sees keys up to it."""
    global launches
    if q.device.type == k.device.type == v.device.type == "cpu":
        return attention_ref(q, k, v, causal, q_offset)
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    strides = [t.stride(i) for t in (q, k, v) for i in (0, 1, 2)]
    rc = lib.helios_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, S, T, H, K, hd, *strides,
        int(causal), int(q_offset), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_attention")
    launches += 1
    return out
