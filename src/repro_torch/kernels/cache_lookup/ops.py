"""Wrapper for the fused cache-lookup kernel (K1).

``fused_cache_lookup(ids, loc, slot, device_tier, host_tier)`` returns the
7-tuple of ``repro.kernels.cache_lookup`` (see ``csrc/cache_lookup.cu``):

  out        (B, D)  gathered rows; zeros at storage/remote positions
  first_idx  (B,)    index of the first occurrence of ids[i] in the batch
  miss_ids   (B,)    storage-tier ids, first occurrences, batch order
  miss_dest  (B,)    output row for each entry of miss_ids
  rem_ids    (B,)    remote-tier ids, first occurrences, batch order
  rem_dest   (B,)    output row for each entry of rem_ids
  counts     (2,)    [n_storage_unique, n_remote_unique]

all int32 but ``out``, lists padded with -1.  When ``device_tier`` lies on
a card the kernel runs there, reading the host tier in place from pinned
host memory, and the launch is counted in ``launches``; when it lies on the
CPU the plain version (``ref.py``) runs.  Empty tiers are padded with one
zero row, never selected (no id maps to an empty tier).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cache_lookup.ref import fused_lookup_ref

launches = 0    # kernel launches since the last reset (chip_smoke reads it)

_P = ctypes.c_void_p
_ARGS = [_P, ctypes.c_int32, _P, _P, ctypes.c_int32, _P, _P, ctypes.c_int64,
         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]


def _lib() -> ctypes.CDLL:
    lib = build.load("cache_lookup")
    lib.helios_fused_lookup.argtypes = _ARGS
    lib.helios_fused_lookup.restype = ctypes.c_int
    lib.helios_host_device_ptr.argtypes = [_P, ctypes.POINTER(_P)]
    lib.helios_host_device_ptr.restype = ctypes.c_int
    return lib


def _pad(tier: torch.Tensor, pinned: bool) -> torch.Tensor:
    if tier.shape[0]:
        return tier
    z = torch.zeros((1, tier.shape[1]), dtype=tier.dtype, device=tier.device)
    return z.pin_memory() if pinned else z


def fused_cache_lookup(ids: torch.Tensor, loc: torch.Tensor,
                       slot: torch.Tensor, device_tier: torch.Tensor,
                       host_tier: torch.Tensor,
                       out: torch.Tensor | None = None):
    """ids: (B,) ids in [0, N) (on the card an id outside gives a zero row
    and no miss, not a fault); loc/slot: (N,) tier tables; device_tier
    (n_dev, D); host_tier (n_host, D), a PINNED CPU tensor when
    ``device_tier`` is on a card.  ``out``, when given, is the (B, D)
    buffer the rows land in (returned as the first output)."""
    global launches
    on_card = device_tier.device.type == "cuda"
    device_tier = _pad(device_tier, False)
    host_tier = _pad(host_tier, on_card)
    if not on_card:
        if device_tier.device.type != "cpu" or ids.device.type != "cpu":
            raise ValueError(f"fused_cache_lookup: device tier on "
                             f"{device_tier.device}, ids on {ids.device}")
        res = fused_lookup_ref(ids, loc, slot, device_tier, host_tier)
        if out is not None:
            out.copy_(res[0])
            res = (out,) + res[1:]
        return res

    dev = device_tier.device
    for name, t in (("ids", ids), ("loc", loc), ("slot", slot)):
        if t.device != dev or t.dim() != 1:
            raise ValueError(f"fused_cache_lookup: {name} must be 1-D on "
                             f"{dev}, got {tuple(t.shape)} on {t.device}")
    if loc.shape != slot.shape:
        raise ValueError("fused_cache_lookup: loc and slot differ in shape")
    if host_tier.device.type != "cpu" or not host_tier.is_pinned():
        raise ValueError("fused_cache_lookup: the host tier must be a pinned "
                         "CPU tensor; the kernel reads it in place over PCIe")
    if host_tier.dtype != device_tier.dtype or \
            host_tier.shape[1] != device_tier.shape[1]:
        raise TypeError("fused_cache_lookup: tiers differ in dtype or width")
    if not (device_tier.is_contiguous() and host_tier.is_contiguous()):
        raise ValueError("fused_cache_lookup: tiers must be contiguous")
    ids, loc, slot = (t.to(torch.int32).contiguous() for t in (ids, loc, slot))
    B, D = ids.shape[0], device_tier.shape[1]
    if out is None:
        out = torch.empty((B, D), dtype=device_tier.dtype, device=dev)
    elif (out.shape != (B, D) or out.dtype != device_tier.dtype
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"fused_cache_lookup: out must be a contiguous "
                         f"({B}, {D}) {device_tier.dtype} tensor on {dev}")
    lists = torch.empty((6, B), dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    first_idx, flags, mid, mdst, rid, rdst = lists.unbind(0)
    if B == 0:
        return out, first_idx, mid, mdst, rid, rdst, counts
    lib = _lib()
    host_ptr = _P()
    build.check(lib, lib.helios_host_device_ptr(host_tier.data_ptr(),
                                                ctypes.byref(host_ptr)),
                "fused_cache_lookup: host tier device pointer")
    first_tab = torch.full((loc.shape[0],), B, dtype=torch.int32, device=dev)
    rc = lib.helios_fused_lookup(
        ids.data_ptr(), B, loc.data_ptr(), slot.data_ptr(), loc.shape[0],
        device_tier.data_ptr(), host_ptr.value, D * device_tier.element_size(),
        first_tab.data_ptr(), out.data_ptr(), first_idx.data_ptr(),
        flags.data_ptr(), mid.data_ptr(), mdst.data_ptr(), rid.data_ptr(),
        rdst.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "fused_cache_lookup")
    launches += 1
    return out, first_idx, mid, mdst, rid, rdst, counts
