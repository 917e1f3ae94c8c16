"""Wrappers for the segment-sum kernel (K3) used by the GNN aggregators.

On CUDA tensors ``segment_sum`` launches ``csrc/segment_agg.cu`` and counts
the launch in ``launches`` and, by route, in ``route_launches``; on CPU
tensors it runs the plain version (``ref.py``); anything else raises.
``segment_mean`` is two sums, as in ``repro.kernels.segment_agg.ops``.

Routes (``pick_route``), one kernel each, chosen from the width alone:

  edges   D <= 4 (counts, degrees): lanes span edges, a segmented warp
          reduction over runs of equal ids, 32 edges per warp step;
  vec     rows of whole 16-byte units (f32 D % 4 == 0, bf16 D % 8 == 0)
          at a 16-byte aligned ``msgs``: lanes own 16-byte column units,
          runs of equal ids summed in registers, one vector RED per run;
  scalar  any other width: the same with one element per unit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_agg.ref import segment_sum_ref

ROUTES = ("edges", "vec", "scalar")
launches = 0    # kernel launches since the last reset (chip_smoke reads it)
route_launches = dict.fromkeys(ROUTES, 0)

_SM_WARPS = 132 * 32        # warps the rows routes aim to have work for

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = build.load("segment_agg")
    lib.helios_segment_sum.argtypes = _ARGS
    lib.helios_segment_sum.restype = ctypes.c_int
    return lib


def pick_route(dtype: torch.dtype, D: int, msgs_ptr: int) -> str:
    """The kernel route for messages of ``dtype`` and width ``D`` at
    address ``msgs_ptr``."""
    if D <= 4:
        return "edges"
    size = 4 if dtype == torch.float32 else 2
    if (D * size) % 16 == 0 and msgs_ptr % 16 == 0:
        return "vec"
    return "scalar"


def rows_tiling(route: str, dtype: torch.dtype, E: int, D: int):
    """(q, chunk) of a rows route: ``q`` column units per lane and pass (a
    power of two, at most 4 vectors or 8 scalars, no more than the row
    needs), ``chunk`` edges per warp work item, 2-64, sized so the grid
    has about ``_SM_WARPS`` items (small inputs are latency-bound: the
    most warps win there)."""
    units = D // (16 // (4 if dtype == torch.float32 else 2)) \
        if route == "vec" else D
    q = 1
    while q < (4 if route == "vec" else 8) and 32 * q < units:
        q *= 2
    passes = -(-units // (32 * q))
    chunk = -(-E * passes // _SM_WARPS)
    return q, min(64, max(2, chunk))


def segment_sum(msgs: torch.Tensor, seg_ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """msgs: (E, D) f32 or bf16; seg_ids: (E,) int32 or int64, any order;
    ids outside [0, n_segments) are dropped.  Returns (n_segments, D) f32
    sums (atomics: equal to a sequential sum within f32 rounding)."""
    global launches
    if msgs.device.type == "cpu" and seg_ids.device.type == "cpu":
        return segment_sum_ref(msgs, seg_ids, n_segments)
    if msgs.device.type != "cuda" or seg_ids.device != msgs.device:
        raise ValueError(f"segment_sum: msgs on {msgs.device} and seg_ids on "
                         f"{seg_ids.device}; both must be on one CUDA device "
                         "(or both on the CPU)")
    if msgs.dim() != 2 or seg_ids.shape != (msgs.shape[0],):
        raise ValueError(f"segment_sum: msgs {tuple(msgs.shape)} must be "
                         f"(E, D) and seg_ids {tuple(seg_ids.shape)} (E,)")
    if msgs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_sum: msgs dtype {msgs.dtype} is not "
                        "float32 or bfloat16")
    if seg_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_sum: seg_ids dtype {seg_ids.dtype} is not "
                        "int32 or int64")
    if not (msgs.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_sum: msgs and seg_ids must be contiguous")
    E, D = msgs.shape
    out = torch.zeros((n_segments, D), dtype=torch.float32,
                      device=msgs.device)
    if E == 0 or D == 0 or n_segments == 0:
        return out
    route = pick_route(msgs.dtype, D, msgs.data_ptr())
    q, chunk = (1, 32) if route == "edges" else \
        rows_tiling(route, msgs.dtype, E, D)
    lib = _lib()
    rc = lib.helios_segment_sum(
        msgs.data_ptr(), int(msgs.dtype == torch.bfloat16), seg_ids.data_ptr(),
        int(seg_ids.dtype == torch.int64), out.data_ptr(), E, D, n_segments,
        ROUTES.index(route), q, chunk,
        torch.cuda.current_stream(msgs.device).cuda_stream)
    build.check(lib, rc, "segment_sum")
    launches += 1
    route_launches[route] += 1
    return out


def segment_mean(msgs: torch.Tensor, seg_ids: torch.Tensor,
                 n_segments: int) -> torch.Tensor:
    s = segment_sum(msgs, seg_ids, n_segments)
    ones = torch.ones((msgs.shape[0], 1), dtype=msgs.dtype,
                      device=msgs.device)
    cnt = segment_sum(ones, seg_ids, n_segments)
    return s / torch.clamp(cnt, min=1.0)
