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
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cache_lookup.ref import fused_lookup_ref

launches = 0    # kernel launches since the last reset (chip_smoke reads it)

TILE = 256              # batch positions per CTA (csrc/cache_lookup.cu kTile)
_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_ARGS = [_P, ctypes.c_int, _I32, _P, _P, _I32, _P, _P, ctypes.c_int64,
         _P, _P, ctypes.c_uint32, ctypes.c_uint32, _P, _P, _P, _P, _I32,
         _P, _P, _P, _P, _P, _P, _P, _P, _P]
_FIRST_EPOCH = 0xFFFFFFFE   # all-ones (0xFFFFFFFF) marks a never-used slot


def _lib() -> ctypes.CDLL:
    lib = build.load("cache_lookup")
    lib.helios_fused_lookup.argtypes = _ARGS
    lib.helios_fused_lookup.restype = ctypes.c_int
    lib.helios_host_device_ptr.argtypes = [_P, ctypes.POINTER(_P)]
    lib.helios_host_device_ptr.restype = ctypes.c_int
    return lib


def table_capacity(B: int) -> int:
    """Slots of the dedup hash table for a batch of B: the smallest power
    of two of at least 2B (and 1024), so linear probing stays short."""
    return max(1024, 1 << max(0, 2 * B - 1).bit_length())


def host_ctas(B: int) -> int:
    """CTAs that copy the host-tier rows: one per 64 positions, at most one
    per SM (1,056 warps, a 4 KB row in flight on each over PCIe)."""
    return max(1, min(132, -(-B // 64)))


class _Table:
    """The dedup hash table of one (device, stream): keys and positions
    tagged with an epoch that decreases by one per call, so no call resets
    it; plus the host-list count each call leaves at 0.  A call that fails
    between launches drops the table (``_tables.pop``).  ``_lock`` keeps
    one call's three launches together on the stream: a second thread's
    call in between would take the first call's slots and host list."""

    def __init__(self, dev: torch.device, cap: int):
        self.keys = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        self.vals = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        self.host_count = torch.zeros(1, dtype=torch.int32, device=dev)
        self.epoch = _FIRST_EPOCH + 1

    def next_epoch(self) -> int:
        self.epoch -= 1
        if self.epoch == 0:             # after 2^32 - 2 calls: start over
            self.keys.fill_(-1)
            self.vals.fill_(-1)
            self.epoch = _FIRST_EPOCH
        return self.epoch


_tables: dict = {}
_lock = threading.Lock()


def _table(dev: torch.device, stream: int, B: int) -> _Table:
    key = (dev.index, stream)
    t = _tables.get(key)
    if t is None or t.keys.shape[0] < table_capacity(B):
        t = _tables[key] = _Table(dev, table_capacity(B))
    return t


def _pad(tier: torch.Tensor, pinned: bool) -> torch.Tensor:
    if tier.shape[0]:
        return tier
    z = torch.zeros((1, tier.shape[1]), dtype=tier.dtype, device=tier.device)
    return z.pin_memory() if pinned else z


def fused_cache_lookup(ids: torch.Tensor, loc: torch.Tensor,
                       slot: torch.Tensor, device_tier: torch.Tensor,
                       host_tier: torch.Tensor,
                       out: torch.Tensor | None = None):
    """ids: (B,) ids in [0, N) (an id outside gives a zero row, first_idx
    its own position and no miss); loc/slot: (N,) tier tables; device_tier
    (n_dev, D); host_tier (n_host, D), a PINNED CPU tensor when
    ``device_tier`` is on a card.  ``out``, when given, is the (B, D)
    buffer the rows land in (returned as the first output).  On the card
    ids may be int32 or int64 and loc/slot are read as int32."""
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
    # no copy where the tables are int32 already (the cache keeps them so)
    # and the ids int32 or int64
    loc, slot = (t.to(torch.int32).contiguous() for t in (loc, slot))
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int64)
    ids = ids.contiguous()
    B, D = ids.shape[0], device_tier.shape[1]
    if out is None:
        out = torch.empty((B, D), dtype=device_tier.dtype, device=dev)
    elif (out.shape != (B, D) or out.dtype != device_tier.dtype
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"fused_cache_lookup: out must be a contiguous "
                         f"({B}, {D}) {device_tier.dtype} tensor on {dev}")
    n_tiles = -(-B // TILE)
    lists = torch.empty((8, B), dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    first_idx, flags, mid, mdst, rid, rdst, slot_of, host_list = \
        lists.unbind(0)
    if B == 0:
        return out, first_idx, mid, mdst, rid, rdst, counts.zero_()
    lib = _lib()
    host_ptr = _P()
    build.check(lib, lib.helios_host_device_ptr(host_tier.data_ptr(),
                                                ctypes.byref(host_ptr)),
                "fused_cache_lookup: host tier device pointer")
    stream = torch.cuda.current_stream(dev).cuda_stream
    tile_counts = torch.empty(n_tiles, dtype=torch.int64, device=dev)
    with _lock:
        tab = _table(dev, stream, B)
        rc = lib.helios_fused_lookup(
            ids.data_ptr(), int(ids.dtype == torch.int64), B, loc.data_ptr(),
            slot.data_ptr(), loc.shape[0], device_tier.data_ptr(),
            host_ptr.value, D * device_tier.element_size(),
            tab.keys.data_ptr(), tab.vals.data_ptr(), tab.keys.shape[0] - 1,
            tab.next_epoch(), tab.host_count.data_ptr(), slot_of.data_ptr(),
            host_list.data_ptr(), tile_counts.data_ptr(), host_ctas(B),
            out.data_ptr(), first_idx.data_ptr(), flags.data_ptr(),
            mid.data_ptr(), mdst.data_ptr(), rid.data_ptr(), rdst.data_ptr(),
            counts.data_ptr(), stream)
        if rc:
            _tables.pop((dev.index, stream), None)
    build.check(lib, rc, "fused_cache_lookup")
    launches += 1
    return out, first_idx, mid, mdst, rid, rdst, counts
