"""Plain PyTorch version of the fused cache-lookup kernel (K1).

Same contract as ``repro.kernels.cache_lookup`` (see ``ops.py``):
fixed-shape padded outputs, first-occurrence dedup by a scatter-min into an
N-sized table, compacted storage/remote miss lists in batch order.  An id
outside [0, N) gives a zero row, its own position as first occurrence and
no miss, as on the card.  The
host tier may lie on the CPU (pinned) while everything else is on a card:
its rows are gathered where they live and moved to the output's device.
"""
from __future__ import annotations

import torch


def fused_lookup_ref(ids, loc, slot, device_tier, host_tier):
    dev = device_tier.device
    ids = ids.to(device=dev, dtype=torch.int64)
    B = ids.shape[0]
    pos = torch.arange(B, dtype=torch.int32, device=dev)
    ok = (ids >= 0) & (ids < loc.shape[0])
    safe = torch.where(ok, ids, 0)

    first_tab = torch.full((loc.shape[0],), B, dtype=torch.int32, device=dev)
    first_tab.scatter_reduce_(0, safe[ok], pos[ok], reduce="amin")
    first_idx = torch.where(ok, first_tab[safe], pos)
    is_first = first_idx == pos

    tier = torch.where(ok, loc[safe].to(torch.int32), -1)
    slots = slot[safe].to(torch.int64)
    drows = device_tier[torch.where(tier == 0, slots, 0)]
    hsl = torch.where(tier == 1, slots, 0).to(host_tier.device)
    hrows = host_tier[hsl].to(device=dev, dtype=device_tier.dtype)
    out = torch.where((tier == 0)[:, None], drows,
                      torch.where((tier == 1)[:, None], hrows,
                                  torch.zeros_like(drows)))

    ids32 = ids.to(torch.int32)

    def compact(mask):
        key = torch.where(mask, pos, B)
        order = torch.argsort(key, stable=True)  # valid entries keep order
        valid = key[order] < B
        ids_c = torch.where(valid, ids32[order], -1)
        dest_c = torch.where(valid, pos[order], -1)
        return ids_c, dest_c, mask.sum().to(torch.int32)

    miss_ids, miss_dest, n_miss = compact((tier == 2) & is_first)
    rem_ids, rem_dest, n_rem = compact((tier == 3) & is_first)
    counts = torch.stack([n_miss, n_rem])
    return out, first_idx, miss_ids, miss_dest, rem_ids, rem_dest, counts
