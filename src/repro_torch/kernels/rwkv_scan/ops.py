"""Wrappers for the WKV6 scan kernel (K5) that RWKV-6 runs, and its
backward.

On CUDA tensors ``wkv`` launches ``csrc/rwkv_scan.cu`` (one CTA per
(batch, head), tokens staged by TMA, two tokens per state update) and
counts the launch in ``launches``; on CPU tensors it runs the plain
version (``ref.py``, the exact sequential recurrence, with autograd through
it); anything else raises, and so does a CUDA tensor in a form the kernels
do not take, before any launch.  A fake tensor (the dry run,
``launch/dryrun.py``) takes ``kernels/dry_run.py``'s shape-only ops, and
only a fake tensor does.

Under grad on the card (an input that requires grad) ``wkv`` runs
``WkvFn``: the forward kernel also saves the state before every
``CKPT_TOKENS``-th token, and the backward launches ``csrc/rwkv_scan_bwd.cu``
(``wkv_bwd``, counted in ``bwd_launches``): exp(logw) once, then a carry
kernel takes the state's cotangent across the chunk boundaries alone,
then a chunk kernel runs every chunk at once from its checkpoint and that
cotangent, one thread-block cluster per (batch, head,
``BWD_CHUNKS_PER_CTA`` chunks) whose ``BWD_CLUSTER[N]`` CTAs (groups of
value columns and rows) add their partial sums in order through
distributed shared memory; du's partials are added in order by a last
kernel.  No atomics, so two runs give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import build, dry_run
from repro_torch.kernels.rwkv_scan.ref import (checkpoints_ref, wkv_bwd_ref,
                                               wkv_ref)

launches = 0        # forward launches since the last reset (chip_smoke)
bwd_launches = 0    # backward launches (each one call of the kernels)
HEAD_SIZES = (8, 16, 32, 64)
ALIGN = 16          # bytes
CKPT_TOKENS = 16    # tokens between the forward's checkpoints
# the backward's chunk kernel: CTAs of a cluster by head size, one per group
# of 8 (N 8) or 16 value columns (csrc/rwkv_scan_bwd.cu's dispatch), and
# the chunks a cluster walks (kPer there)
BWD_CLUSTER = {8: 1, 16: 1, 32: 2, 64: 4}
BWD_CHUNKS_PER_CTA = 4

_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_OCCUPANCY = ("carry_threads", "carry_smem_bytes", "carry_ctas_per_sm",
              "chunk_threads", "chunk_smem_bytes", "chunk_ctas_per_sm",
              "cluster", "max_active_clusters")


def _lib() -> ctypes.CDLL:
    lib = build.load("rwkv_scan")
    lib.helios_wkv6.argtypes = _ARGS
    lib.helios_wkv6.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("rwkv_scan_bwd")
    lib.helios_wkv6_bwd.argtypes = _BWD_ARGS
    lib.helios_wkv6_bwd.restype = ctypes.c_int
    lib.helios_wkv6_bwd_occupancy.argtypes = [ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int)]
    lib.helios_wkv6_bwd_occupancy.restype = ctypes.c_int
    return lib


def bwd_occupancy(N: int) -> dict:
    """The backward kernels at head size ``N`` on the current card: each
    one's threads, dynamic shared memory and resident CTAs an SM (carry,
    then chunk), the chunk kernel's cluster size and how many of its
    clusters the card holds at once (CUDA's occupancy calculator)."""
    lib = _bwd_lib()
    out = (ctypes.c_int * len(_OCCUPANCY))()
    build.check(lib, lib.helios_wkv6_bwd_occupancy(N, out), "wkv_bwd")
    return dict(zip(_OCCUPANCY, out))


def _check(r, k, v, logw, u, state) -> None:
    """Raise unless the CUDA kernels take these tensors as they are."""
    ts = [r, k, v, logw, u] + ([] if state is None else [state])
    if any(t.device != r.device for t in ts) or r.device.type != "cuda":
        raise ValueError("wkv: tensors on " + ", ".join(
            str(t.device) for t in ts) + "; all must be on one CUDA device "
            "(or all on the CPU)")
    _check_forms(r, k, v, logw, u, state)


def _check_forms(r, k, v, logw, u, state) -> None:
    """Raise unless the kernels take the tensors' shapes, dtypes and
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at an ``ALIGN``-byte aligned address (a copy where
    it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % ALIGN == 0 else t.clone()


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor | None = None):
    """r, k, v, logw: (B, T, H, N) float32; u: (H, N); state: (B, H, N, N)
    [key x value] or None (zeros).  Returns (y (B, T, H, N), final state
    (B, H, N, N)), float32; any T, no padding, so the final state is the
    state after token T - 1.  Differentiable in every input: on the card
    through ``WkvFn`` (the backward kernel), on the CPU through the plain
    version."""
    ts = (r, k, v, logw, u) if state is None else (r, k, v, logw, u, state)
    if all(t.device.type == "cpu" for t in ts):
        return wkv_ref(r, k, v, logw, u, state)
    if is_fake(r):
        return dry_run.wkv(r, k, v, logw, u, state)
    _check(r, k, v, logw, u, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return WkvFn.apply(r, k, v, logw, u, state)
    y, s_out, _ = _forward(r, k, v, logw, u, state, False)
    return y, s_out


def wkv_fwd(r, k, v, logw, u, state=None):
    """``(y, final state, checkpoints)``: ``wkv``'s outputs (no autograd
    record) and the state before every ``CKPT_TOKENS``-th token, (B, H,
    ceil(T / CKPT_TOKENS), N, N) float32 (``ref.checkpoints_ref``), what
    ``wkv_bwd`` needs on the card.  One forward launch on CUDA tensors, the
    plain versions on CPU tensors."""
    ts = (r, k, v, logw, u) if state is None else (r, k, v, logw, u, state)
    if all(t.device.type == "cpu" for t in ts):
        return (*wkv_ref(r, k, v, logw, u, state),
                checkpoints_ref(k, v, logw, state, CKPT_TOKENS))
    if is_fake(r):
        return dry_run.wkv_fwd(r, k, v, logw, u, state)
    _check(r, k, v, logw, u, state)
    return _forward(r, k, v, logw, u, state, True)


def wkv_bwd(r, k, v, logw, u, state, dy, dstate=None, *, ckpt=None):
    """The gradient of ``wkv(r, k, v, logw, u, state)`` given the
    cotangents ``dy`` of y and ``dstate`` of the final state (None: zeros):
    ``(dr, dk, dv, dlogw, du, dstate0)``, float32, du (H, N) summed over the
    batch, dstate0 the initial state's gradient.  On CUDA tensors the
    backward kernels, which read the forward's checkpoints ``ckpt``
    (``wkv_fwd``); on CPU tensors ``ref.wkv_bwd_ref`` (``ckpt`` unused)."""
    ts = (r, k, v, logw, u, dy) + tuple(
        t for t in (state, dstate) if t is not None)
    if all(t.device.type == "cpu" for t in ts):
        return wkv_bwd_ref(r, k, v, logw, u, state, dy, dstate)
    if is_fake(r):
        return dry_run.wkv_bwd(r, k, v, logw, u, state, dy, dstate, ckpt)
    _check(r, k, v, logw, u, state)
    if ckpt is None:
        raise ValueError("wkv_bwd: needs the forward's checkpoints on the "
                         "card (ckpt from wkv_fwd)")
    return tuple(_backward(r, k, v, logw, u, ckpt, _aligned(dy),
                           None if dstate is None else _aligned(dstate),
                           (True,) * 6))


class WkvFn(torch.autograd.Function):
    """K5 under autograd on the card: the forward kernel, saving its
    checkpoints, and the backward kernels.  Saves r, k, v, logw, u and the
    checkpoints (the initial state is the first); under
    ``torch.utils.checkpoint`` the forward is launched again inside the
    backward and saves its own.  An unused output's cotangent arrives as
    None: the final state's is then read as zeros by the kernel, y's
    becomes a zero tensor."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state):
        y, s_out, ckpt = _forward(r, k, v, logw, u, state, True)
        ctx.save_for_backward(r, k, v, logw, u, ckpt)
        ctx.set_materialize_grads(False)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, logw, u, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else _aligned(dy)
        if dstate is not None:
            dstate = _aligned(dstate)
        return tuple(_backward(r, k, v, logw, u, ckpt, dy, dstate,
                               ctx.needs_input_grad))


def _forward(r, k, v, logw, u, state, checkpoints: bool):
    """One forward launch on checked CUDA tensors (no autograd record):
    ``(y, final state, checkpoints or None)``."""
    global launches
    B, T, H, N = r.shape
    s_in = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
            if state is None else state)
    y = torch.empty_like(r)
    s_out = torch.empty_like(s_in)
    ckpt = (torch.empty((B, H, -(-T // CKPT_TOKENS), N, N),
                        dtype=torch.float32, device=r.device)
            if checkpoints else None)
    if B * H == 0:
        return y, s_out, ckpt
    lib = _lib()
    rc = lib.helios_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), s_in.data_ptr(), y.data_ptr(), s_out.data_ptr(),
        None if ckpt is None else ckpt.data_ptr(), B, T, H, N,
        torch.cuda.current_stream(r.device).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"wkv: no TMA descriptor for r/k/v/logw (CUresult "
                           f"{-rc}; 1000: the driver has no "
                           "cuTensorMapEncodeTiled)")
    build.check(lib, rc, "wkv")
    launches += 1
    return y, s_out, ckpt


def _backward(r, k, v, logw, u, ckpt, dy, dstate, needs):
    """One backward call (exp(logw), the carry, the chunk kernel, du's
    ordered sum) on checked CUDA tensors: ``[dr, dk, dv, dlogw, du,
    dstate0]``, None where ``needs`` (one flag each) is False."""
    global bwd_launches
    B, T, H, N = r.shape
    want = {"dy": (dy, r.shape), "ckpt": (ckpt, (B, H, -(-T // CKPT_TOKENS),
                                                  N, N))}
    if dstate is not None:
        want["dstate"] = (dstate, (B, H, N, N))
    for name, (t, shape) in want.items():
        if t.shape != shape or t.dtype != torch.float32 or \
                t.device != r.device or not t.is_contiguous() or \
                t.data_ptr() % ALIGN:
            raise ValueError(
                f"wkv_bwd: {name} {tuple(t.shape)} {t.dtype} on {t.device} "
                f"must be {shape} float32 on {r.device}, contiguous and "
                f"{ALIGN}-byte aligned")
    dev, f32 = r.device, torch.float32
    outs = [torch.empty_like(r) if n else None for n in needs[:4]]
    outs.append(torch.empty((H, N), dtype=f32, device=dev) if needs[4]
                else None)
    outs.append(torch.empty((B, H, N, N), dtype=f32, device=dev)
                if needs[5] else None)
    if B * H == 0:
        if outs[4] is not None:     # no batch: du sums nothing
            outs[4].zero_()
        return outs
    # G after every chunk (the checkpoints' size), du's partial per (batch,
    # cluster's group of chunks)
    n_chunks = -(-T // CKPT_TOKENS)
    gend = (torch.empty((B, H, n_chunks, N, N), dtype=f32, device=dev)
            if any(needs[:5]) else None)
    du_part = (torch.empty((B, -(-n_chunks // BWD_CHUNKS_PER_CTA), H, N),
                           dtype=f32, device=dev) if needs[4] else None)
    # exp(logw) once, over whole chunks (1 past T)
    w = (torch.empty((B, n_chunks * CKPT_TOKENS, H, N), dtype=f32,
                     device=dev) if T else None)

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _bwd_lib()
    dr, dk, dv, dlogw, du, ds0 = outs
    rc = lib.helios_wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), ckpt.data_ptr(), dy.data_ptr(), ptr(dstate), ptr(dr),
        ptr(dk), ptr(dv), ptr(dlogw), ptr(du), ptr(ds0), ptr(gend),
        ptr(du_part), ptr(w), B, T, H, N, BWD_CLUSTER[N], BWD_CHUNKS_PER_CTA,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"wkv_bwd: no TMA descriptor for r/k/v/logw/dy "
                           f"(CUresult {-rc}; 1000: the driver has no "
                           "cuTensorMapEncodeTiled)")
    build.check(lib, rc, "wkv_bwd")
    bwd_launches += 1
    return outs
