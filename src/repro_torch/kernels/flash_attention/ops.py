"""Wrapper for the flash-attention kernel (K4) that prefill attention runs.

On CUDA tensors ``flash_attention`` launches one of two kernels of
``csrc/flash_attention.cu``, chosen by ``pick_route`` from the dtype, the
head width and the alignment of q, k and v:

- ``"tensor_cores"``: bf16 at head widths 64, 80, 96, 112 and 128 — every
  bf16 prefill of the served configs but recurrentgemma's.  wgmma on the
  bf16 tensor cores, fed by TMA (widths under 128 padded to 64 or 128 by
  its zero fill); P is rounded to bf16 before P.V, as the reference model
  does.
- ``"cuda_cores"``: float32 at every width, and bf16 at widths 8-32 (the
  reduced configs) and 256 (recurrentgemma-2b).  Scores, softmax and P.V
  in float32 on the CUDA cores.

Both take a local-attention ``window`` (query at position p sees keys
t > p - window) and skip the key tiles that lie wholly below it.

Each launch counts in ``launches``, in its route's ``route_launches`` and
by use in ``launches_by_use``.
On CPU tensors it runs the plain version (``ref.py``); anything else
raises, and so does a CUDA tensor in a form neither kernel takes.  Both
kernels read q, k and v in the model's own ``(B, S, H, hd)`` layout
through their strides (no copy); only the head dimension must be
contiguous.

Under autograd (grad enabled and an input that requires grad) a CUDA call
goes through ``FlashAttentionFn``: the same forward launch, and a backward
that is a kernel too, ``csrc/flash_attention_bwd.cu`` (``flash_attention_
bwd``: a statistics pre-pass, then dq, dk, dv in float32 on the CUDA
cores, every form the forward takes), counted in ``bwd_launches``.  On the
CPU autograd runs through the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

ROUTES = ("tensor_cores", "cuda_cores")
launches = 0    # kernel launches since the last reset (chip_smoke reads it)
route_launches = dict.fromkeys(ROUTES, 0)   # the same, per route
# (causal, window, S == T) -> launches: an encoder's self-attention, a
# decoder's, a cross-attention and a local one tell apart
launches_by_use: dict = {}
bwd_launches = 0   # backward calls (pre-pass + gradient kernel each)
HEAD_DIMS = (8, 16, 32, 64, 80, 96, 112, 128, 256)
TENSOR_CORE_HEAD_DIMS = (64, 80, 96, 112, 128)
TMA_ALIGN = 16    # bytes: TMA reads base pointers and strides of this unit

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 9
         + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
_ARGS_TC = _ARGS[:4] + _ARGS[5:]    # no dtype flag: bf16 only
_ARGS_BWD = [ctypes.c_void_p] * 10 + _ARGS[4:]   # + o, do and 4 buffers


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.helios_flash_attention.argtypes = _ARGS
    lib.helios_flash_attention.restype = ctypes.c_int
    lib.helios_flash_attention_tc.argtypes = _ARGS_TC
    lib.helios_flash_attention_tc.restype = ctypes.c_int
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    lib.helios_flash_attention_bwd.argtypes = _ARGS_BWD
    lib.helios_flash_attention_bwd.restype = ctypes.c_int
    return lib


def pick_route(dtype: torch.dtype, hd: int, layouts) -> str:
    """The kernel that takes q, k, v of ``dtype`` and head width ``hd``:
    ``"tensor_cores"`` for bf16 at widths 64-128, else
    ``"cuda_cores"``.  ``layouts`` gives each tensor's ``(data_ptr, shape,
    stride)``, strides in elements.  The tensor-core route loads by TMA,
    which takes only 16-byte-aligned base pointers and strides (the stride
    of an axis of size 1 is never used): a bf16 tensor at a tensor-core
    width that breaks that raises ValueError rather than take the other
    route."""
    if dtype != torch.bfloat16 or hd not in TENSOR_CORE_HEAD_DIMS:
        return "cuda_cores"
    unit = TMA_ALIGN // 2    # bf16 elements
    for name, (ptr, shape, stride) in zip("qkv", layouts):
        if ptr % TMA_ALIGN or any(n > 1 and (s <= 0 or s % unit)
                                  for n, s in zip(shape[:3], stride[:3])):
            raise ValueError(
                f"flash_attention: bf16 {name} at head dim {hd} takes the "
                f"tensor-core route, whose TMA loads need a {TMA_ALIGN}-byte"
                f"-aligned base pointer and positive strides of a multiple "
                f"of {unit} elements; got pointer {ptr:#x}, shape "
                f"{tuple(shape)}, strides {tuple(stride)}")
    return "tensor_cores"


def _tma_strides(t: torch.Tensor) -> list[int]:
    """Element strides of the batch, sequence and head axes for a tensor
    map; an axis of size 1 gets a legal placeholder, as TMA checks every
    stride but never steps along that axis."""
    return [s if n > 1 else TMA_ALIGN // 2
            for n, s in zip(t.shape[:3], t.stride()[:3])]


def _check(q, k, v) -> None:
    """Raise unless the CUDA kernels take (q, k, v) as they are."""
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
                    causal: bool = True, q_offset: int = 0,
                    window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, T, K, hd), H % K == 0, float32 or
    bfloat16.  Returns softmax(q k^T / sqrt(hd)) v as (B, S, H, hd) in q's
    dtype; scores and softmax in float32, P.V in float32 on the CUDA-core
    route and with P rounded to bf16 on the tensor-core route (the plain
    version keeps P in float32).  Query i sits at absolute position
    ``q_offset + i``; ``causal``: it sees keys up to it; ``window`` > 0:
    only keys less than ``window`` before it (``ref.visible``).  A query
    that sees no key gets zeros."""
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if q.device.type == k.device.type == v.device.type == "cpu":
        return attention_ref(q, k, v, causal, q_offset, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, q_offset, window)
    return _forward(q, k, v, causal, q_offset, window)


def _forward(q, k, v, causal, q_offset, window) -> torch.Tensor:
    """One forward launch on CUDA tensors (no autograd record)."""
    global launches
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    route = pick_route(q.dtype, hd, [(t.data_ptr(), t.shape, t.stride())
                                     for t in (q, k, v)])
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    tail = (int(causal), int(q_offset), int(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if route == "tensor_cores":
        strides = [s for t in (q, k, v) for s in _tma_strides(t)]
        rc = lib.helios_flash_attention_tc(*ptrs, B, S, T, H, K, hd,
                                           *strides, *tail)
        if rc < 0:
            raise RuntimeError(
                f"flash_attention: no TMA descriptor for q/k/v (CUresult "
                f"{-rc}; 1000: the driver has no cuTensorMapEncodeTiled)")
    else:
        strides = [t.stride(i) for t in (q, k, v) for i in (0, 1, 2)]
        rc = lib.helios_flash_attention(*ptrs, int(q.dtype == torch.bfloat16),
                                        B, S, T, H, K, hd, *strides, *tail)
    build.check(lib, rc, "flash_attention")
    launches += 1
    route_launches[route] += 1
    use = (bool(causal), int(window), S == T)
    launches_by_use[use] = launches_by_use.get(use, 0) + 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """K4 under autograd on the card: the forward kernel, and the backward
    kernel for its gradient.  Saves q, k, v and the output; under
    ``torch.utils.checkpoint`` the forward is launched again inside the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window):
        o = _forward(q, k, v, causal, q_offset, window)
        ctx.save_for_backward(q, k, v, o)
        ctx.args = (causal, q_offset, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, do, *ctx.args),
                None, None, None)


def flash_attention_bwd(q, k, v, o, do, causal: bool = True,
                        q_offset: int = 0, window: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal, q_offset,
    window)`` given its output ``o`` and the output's gradient ``do``, in
    the inputs' dtype; dk and dv summed over the query heads that share a
    kv head.  On CUDA tensors: the backward kernel (P recomputed in float32
    from q and k, float32 accumulation, dq through a float32 buffer then
    cast); on CPU tensors: autograd through the plain version, the
    gradient the kernel is held to (``o`` unused)."""
    global bwd_launches
    if window < 0:
        raise ValueError(f"flash_attention_bwd: window {window} < 0")
    if q.device.type == k.device.type == v.device.type == "cpu":
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_ref(*qkv, causal, q_offset, window)
            return torch.autograd.grad(out, qkv, do)
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device} is not q's "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    o, do = o.contiguous(), do.contiguous()
    dev = q.device
    dq = torch.zeros((B, S, H, hd), dtype=torch.float32, device=dev)
    # the kernel writes every entry of dk and dv; with no query it is not
    # launched and they are zeros
    alloc = torch.empty if dq.numel() else torch.zeros
    dk = alloc((B, T, K, hd), dtype=q.dtype, device=dev)
    dv = alloc((B, T, K, hd), dtype=q.dtype, device=dev)
    if dq.numel():
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        delta = torch.empty_like(lse)
        lib = _lib_bwd()
        rc = lib.helios_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), int(q.dtype == torch.bfloat16),
            B, S, T, H, K, hd,
            *[t.stride(i) for t in (q, k, v) for i in (0, 1, 2)],
            int(causal), int(q_offset), int(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(lib, rc, "flash_attention_bwd")
        bwd_launches += 1
    return dq.to(q.dtype), dk, dv
