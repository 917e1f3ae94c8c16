"""Wrapper for the row-gather kernel (K2): ``out[i] = table[idx[i]]``.

On a CUDA tensor it launches ``csrc/gather.cu`` (a warp per pair of rows,
a repeated row loaded once) and counts the launch in ``launches``; on a
CPU tensor it runs the plain version (``ref.py``); anything else raises.
Replaces ``repro.kernels.gather.ops.cache_gather``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather.ref import gather_rows_ref

launches = 0    # kernel launches since the last reset (chip_smoke reads it)

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


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (N, D) contiguous, any dtype; idx: (B,) int32 or int64 in
    [0, N) -> (B, D), bit-exact.  B = 0 gives (0, D)."""
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
    launches += 1
    return out
