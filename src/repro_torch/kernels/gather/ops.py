"""Wrapper for the row-gather kernel (K2): ``out[i] = table[idx[i]]``.

On a CUDA tensor it launches ``csrc/gather.cu`` (a warp per pair of rows,
a repeated row loaded once) and counts the launch in ``launches`` and, by
use, in ``launches_by_use``; on a CPU tensor it runs the plain version
(``ref.py``); anything else raises.
Replaces ``repro.kernels.gather.ops.cache_gather``.

An index outside ``[0, N)`` gives a row of zeros, on the card and on the
CPU alike.  The reference differs there: ``jnp.take`` (its
``cache_gather`` and the cache's device-tier read) wraps -1 to the last
row and fills NaN from N up, and the model's ``h[src_pos]`` clamps to
``[0, N)``.  No path passes such an index (padded positions are 0, cache
slots are valid); the zero row is what a segment sum's backward needs for
a dropped id.

``gather_rows`` carries a gradient on both devices: its backward sums
``grad_out`` over ``idx`` into ``table.shape[0]`` rows with the segment-sum
wrapper (K3 on the card), which drops an index outside ``[0, N)``, the
adjoint of the zero row.  The Pallas kernel is forward-only; the
reference differentiates ``h[src_pos]`` through XLA.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather.ref import gather_rows_ref

launches = 0    # kernel launches since the last reset (chip_smoke reads it)
# ("forward" or "backward" (segment_sum's), table shape, number of
# indices) -> launches
launches_by_use: dict = {}
_count_lock = threading.Lock()     # the io pool's threads gather too

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = build.load("gather")
    lib.helios_gather_rows.argtypes = _ARGS
    lib.helios_gather_rows.restype = ctypes.c_int
    return lib


def _check_forms(table: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise unless the kernel takes (table, idx) as they are."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows: table {tuple(table.shape)} must be "
                         f"2-D and idx {tuple(idx.shape)} 1-D")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather_rows: idx dtype {idx.dtype} is not int32 "
                        "or int64")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows: table and idx must be contiguous")


def _gather(table: torch.Tensor, idx: torch.Tensor,
            backward: bool = False) -> torch.Tensor:
    """The forward rule on either device; ``backward`` counts a launch
    made for segment_sum's backward as such in ``launches_by_use``."""
    global launches
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_ref(table, idx)
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"gather_rows: table on {table.device} and idx on "
                         f"{idx.device}; both must be on one CUDA device "
                         "(or both on the CPU)")
    _check_forms(table, idx)
    B, D = idx.shape[0], table.shape[1]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    lib = _lib()
    rc = lib.helios_gather_rows(
        table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
        out.data_ptr(), B, table.shape[0], D * table.element_size(),
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(lib, rc, "gather_rows")
    use = ("backward" if backward else "forward", tuple(table.shape), B)
    with _count_lock:
        launches += 1
        launches_by_use[use] = launches_by_use.get(use, 0) + 1
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.dtype = table.shape[0], table.dtype
        return _gather(table, idx)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[0]:
            return None, None
        # imported here: the two wrapper modules are each other's backward
        from repro_torch.kernels.segment_agg.ops import _segment_sum
        (idx,) = ctx.saved_tensors
        grad = _segment_sum(grad_out.contiguous(), idx, ctx.n_rows,
                            backward=True)
        return grad.to(ctx.dtype), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (N, D) contiguous, any dtype; idx: (B,) int32 or int64 ->
    (B, D), bit-exact, a zero row where idx is outside [0, N).  B = 0
    gives (0, D).  Differentiable in ``table`` (see the module note)."""
    return _GatherRows.apply(table, idx)
