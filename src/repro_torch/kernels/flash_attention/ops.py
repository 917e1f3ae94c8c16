"""Wrapper for the flash-attention kernel (K4) that prefill attention runs.

On CUDA tensors ``flash_attention`` launches one of two kernels of
``csrc/flash_attention.cu``, chosen by ``pick_route`` from the dtype, the
head width and the alignment of q, k and v:

- ``"tensor_cores"``: bf16 at head widths 64, 80, 96, 112, 128 and 256 —
  every bf16 prefill of the served configs.  wgmma on the bf16 tensor
  cores, fed by TMA (widths under 128 padded to 64 or 128 by its zero
  fill; 64-key tiles at 256); P is rounded to bf16 before P.V, as the
  reference model does.
- ``"cuda_cores"``: float32 at every width, and bf16 at widths 8-32 (the
  reduced configs).  Scores, softmax and P.V in float32 on the CUDA cores.

Both take a local-attention ``window`` (query at position p sees keys
t > p - window) and skip the key tiles that lie wholly below it.

Each launch counts in ``launches``, in its route's ``route_launches`` and
by use in ``launches_by_use``.
On CPU tensors it runs the plain version (``ref.py``); anything else
raises, and so does a CUDA tensor in a form neither kernel takes.  A fake
tensor (the dry run, ``launch/dryrun.py``) takes ``kernels/dry_run.py``'s
shape-only ops, and only a fake tensor does.  Both
kernels read q, k and v in the model's own ``(B, S, H, hd)`` layout
through their strides (no copy); only the head dimension must be
contiguous.

Under autograd (grad enabled and an input that requires grad) a CUDA call
goes through ``FlashAttentionFn``: the same forward launch, which also
writes each query's log-sum-exp (``flash_attention_fwd``), and a backward
that is a kernel too, ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd``: a pre-pass for rowsum(dO * O), then the
gradients on the backward's own route, ``bwd_route_of``: on the tensor
cores, bf16 at the forward's tensor-core widths 64-256, a dK/dV kernel and
a dQ kernel with no atomics (at 256 the dK/dV kernel may split the query
heads into groups, ``bwd_head_groups``, whose float32 sums a fixed-order
pass adds); on the CUDA cores, float32 and bf16 at 8-32, one float32
kernel that adds dQ by atomics), counted in ``bwd_launches`` and by route
in ``bwd_route_launches``.  On the CPU autograd runs through the plain
version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import build, dry_run
from repro_torch.kernels.flash_attention.ref import attention_ref, lse_ref

ROUTES = ("tensor_cores", "cuda_cores")
launches = 0    # kernel launches since the last reset (chip_smoke reads it)
route_launches = dict.fromkeys(ROUTES, 0)   # the same, per route
# (causal, window, S == T) -> launches: an encoder's self-attention, a
# decoder's, a cross-attention and a local one tell apart
launches_by_use: dict = {}
bwd_launches = 0   # backward calls (the pre-pass and its gradient kernels)
bwd_route_launches = dict.fromkeys(ROUTES, 0)   # the same, per route
HEAD_DIMS = (8, 16, 32, 64, 80, 96, 112, 128, 256)
TENSOR_CORE_HEAD_DIMS = (64, 80, 96, 112, 128, 256)
TENSOR_CORE_BWD_HEAD_DIMS = (64, 80, 96, 112, 128, 256)   # the backward's
BWD_KEYS_256 = 64   # keys per dK/dV CTA of the tensor-core backward at 256
TMA_ALIGN = 16    # bytes: TMA reads base pointers and strides of this unit

# q, k, v, o, lse; is_bf16, B, S, T, H, K, hd; 9 strides; causal, q_offset,
# window; scale, stream
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 9
         + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
_ARGS_TC = _ARGS[:5] + _ARGS[6:]    # no dtype flag: bf16 only
# q, k, v, o, do, lse, delta, dq, dk, dv, then as the forward's from is_bf16
_ARGS_BWD = [ctypes.c_void_p] * 10 + _ARGS[5:]
# the tensor cores': the head groups' scratch after dv, no dtype flag, and
# lse's and delta's row stride and the head groups after hd
_ARGS_BWD_TC = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + _ARGS_TC[11:]


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
    lib.helios_flash_attention_bwd_tc.argtypes = _ARGS_BWD_TC
    lib.helios_flash_attention_bwd_tc.restype = ctypes.c_int
    return lib


def pick_route(dtype: torch.dtype, hd: int, layouts) -> str:
    """The kernel that takes q, k, v of ``dtype`` and head width ``hd``:
    ``"tensor_cores"`` for bf16 at widths 64-256, else
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


def route_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``pick_route`` for the tensors themselves: the route of the forward
    on (q, k, v)."""
    return pick_route(q.dtype, q.shape[3], [(t.data_ptr(), t.shape,
                                             t.stride()) for t in (q, k, v)])


def bwd_route_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route of the backward on (q, k, v): the forward's at
    ``TENSOR_CORE_BWD_HEAD_DIMS`` (64-256, the same widths), else the CUDA
    cores.  A misaligned bf16 tensor at those widths raises ValueError, as
    the forward does."""
    if q.shape[3] not in TENSOR_CORE_BWD_HEAD_DIMS:
        return "cuda_cores"
    return route_of(q, k, v)


def bwd_head_groups(B: int, T: int, K: int, G: int, hd: int,
                    n_sm: int) -> int:
    """Head groups of the tensor-core dK/dV kernel: 1 below hd 256.  At
    256 a CTA holds ``BWD_KEYS_256`` keys of one (batch, kv head), so
    ``ctas = B K ceil(T / 64)``; where that leaves SMs idle, each kv head's
    G query heads split into as many groups as one wave of ``n_sm`` CTAs
    takes, ``min(G, n_sm // ctas)``, at least 1, each group a CTA per key
    block writing float32 partial sums that a fixed-order pass adds
    (recurrentgemma-2b's layer, B 1, one kv head, T 4096, G 10, on 132
    SMs: 64 CTAs, 2 groups)."""
    if hd != 256:
        return 1
    ctas = B * K * -(-T // BWD_KEYS_256)
    return max(1, min(G, n_sm // max(ctas, 1)))


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
    if is_fake(q):
        return dry_run.flash_attention(q, k, v, causal, q_offset, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, q_offset, window)
    return _forward(q, k, v, causal, q_offset, window)[0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0,
                        window: int = 0):
    """``(o, lse)``: ``flash_attention``'s output (no autograd record) and
    each query's log-sum-exp of its scaled scores in log2 units, (B, H, S)
    float32, ``+inf`` for a query that sees no key (``ref.lse_ref``): what
    the forward saves for ``flash_attention_bwd``.  One forward launch on
    CUDA tensors, the plain versions on CPU tensors."""
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if q.device.type == k.device.type == v.device.type == "cpu":
        return (attention_ref(q, k, v, causal, q_offset, window),
                lse_ref(q, k, causal, q_offset, window))
    if is_fake(q):
        return dry_run.flash_attention_fwd(q, k, v, causal, q_offset, window)
    return _forward(q, k, v, causal, q_offset, window, with_lse=True)


def _forward(q, k, v, causal, q_offset, window, with_lse=False):
    """One forward launch on CUDA tensors (no autograd record): ``(o,
    lse)``, lse None unless ``with_lse``."""
    global launches
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    route = route_of(q, k, v)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    lib = _lib()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr())
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
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """K4 under autograd on the card: the forward kernel, and the backward
    kernels for its gradient.  Saves q, k, v, the output and each query's
    log-sum-exp; under ``torch.utils.checkpoint`` the forward is launched
    again inside the backward and saves its own."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window):
        o, lse = _forward(q, k, v, causal, q_offset, window, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, q_offset, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, do, *ctx.args, lse=lse),
                None, None, None)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a ``TMA_ALIGN``-byte aligned address (a copy
    where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % TMA_ALIGN == 0 else t.clone()


def flash_attention_bwd(q, k, v, o, do, causal: bool = True,
                        q_offset: int = 0, window: int = 0, *, lse=None):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal, q_offset,
    window)`` given its output ``o``, the output's gradient ``do`` and, on
    CUDA tensors, each query's log-sum-exp ``lse`` as ``flash_attention_
    fwd`` returns it; in the inputs' dtype, dk and dv summed over the query
    heads that share a kv head.  On CUDA tensors: the backward kernels of
    ``bwd_route_of(q, k, v)``, P recomputed from q, k and lse, float32 sums
    (the tensor cores round P and dS to bf16 before each product and write
    dq once, and dk and dv once or, split into ``bwd_head_groups`` at hd
    256, as float32 sums that one pass adds in order; the CUDA cores add
    dq into a float32 buffer, then cast); on
    CPU tensors: autograd through the plain version, the gradient the
    kernels are held to (``o`` and ``lse`` unused)."""
    global bwd_launches
    if window < 0:
        raise ValueError(f"flash_attention_bwd: window {window} < 0")
    if q.device.type == k.device.type == v.device.type == "cpu":
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_ref(*qkv, causal, q_offset, window)
            return torch.autograd.grad(out, qkv, do)
    if is_fake(q):
        return dry_run.flash_attention_bwd(q, k, v, o, do, causal, q_offset,
                                           window, lse)
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device} is not q's "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if lse is None or lse.shape != (B, H, S) or \
            lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(
            "flash_attention_bwd: needs the forward's log-sum-exp, (B, H, S) "
            f"float32 on {q.device} (flash_attention_fwd); got "
            f"{None if lse is None else (tuple(lse.shape), lse.dtype)}")
    route = bwd_route_of(q, k, v)
    tc = route == "tensor_cores"
    # the tensor cores read lse and delta by TMA as rows of a multiple of 4
    # floats (16 bytes)
    ld = -(-S // 4) * 4 if tc else S
    if ld != S:
        lse = torch.nn.functional.pad(lse, (0, ld - S))
    o, do, lse = _aligned(o), _aligned(do), _aligned(lse)
    dev = q.device
    # the tensor cores write dq once in q's dtype; the CUDA cores add it
    # into a zeroed float32 buffer
    dq = (torch.empty((B, S, H, hd), dtype=q.dtype, device=dev) if tc else
          torch.zeros((B, S, H, hd), dtype=torch.float32, device=dev))
    # the kernels write every entry of dk and dv; with no query nothing is
    # launched and they are zeros
    alloc = torch.empty if dq.numel() else torch.zeros
    dk = alloc((B, T, K, hd), dtype=q.dtype, device=dev)
    dv = alloc((B, T, K, hd), dtype=q.dtype, device=dev)
    if dq.numel():
        delta = torch.empty((B, H, ld), dtype=torch.float32, device=dev)
        lib = _lib_bwd()
        ptrs = [t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk,
                                       dv)]
        tail = (int(causal), int(q_offset), int(window), 1.0 / math.sqrt(hd),
                torch.cuda.current_stream(dev).cuda_stream)
        if tc:
            groups = bwd_head_groups(
                B, T, K, H // K, hd,
                torch.cuda.get_device_properties(dev).multi_processor_count)
            # each group's float32 dK and dV sums, added by a last pass
            part = (torch.empty((2, groups, B, T, K, hd), dtype=torch.float32,
                                device=dev) if groups > 1 else None)
            rc = lib.helios_flash_attention_bwd_tc(
                *ptrs, 0 if part is None else part.data_ptr(), B, S, T, H, K,
                hd, ld, groups,
                *[s for t in (q, k, v) for s in _tma_strides(t)], *tail)
            if rc < 0:
                raise RuntimeError(
                    f"flash_attention_bwd: no TMA descriptor (CUresult "
                    f"{-rc}; 1000: the driver has no cuTensorMapEncodeTiled)")
        else:
            rc = lib.helios_flash_attention_bwd(
                *ptrs, int(q.dtype == torch.bfloat16), B, S, T, H, K, hd,
                *[t.stride(i) for t in (q, k, v) for i in (0, 1, 2)], *tail)
        build.check(lib, rc, "flash_attention_bwd")
        bwd_launches += 1
        bwd_route_launches[route] += 1
    return dq.to(q.dtype), dk, dv
