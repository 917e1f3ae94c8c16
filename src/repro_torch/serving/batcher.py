"""Micro-batcher: coalesce admitted requests into one IO submission.

Concurrent requests over a skewed graph share neighborhoods, so the
batcher (1) samples each request's blocks (padded to the sampler's static
shapes, as in the reference), (2) takes the UNION of
node ids across every request in the micro-batch, and (3) hands the server
one deduplicated id set to plan/gather exactly once.  Per-request feature
matrices are then scatter-gathered out of the unique row block — the
DiskGNN-style batched-packing trick applied across requests instead of
across mini-batch epochs.

PyTorch port of ``repro.serving.batcher``: the gathered rows are a tensor
on the cache's device, and the per-request expansion out of the unique row
block runs there through the K2 row-gather kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.gnn.sampling import MiniBatch, NeighborSampler
from repro_torch.kernels.gather.ops import gather_rows


def pad_seeds(seeds: np.ndarray, batch_size: int,
              n_vertices: int) -> np.ndarray:
    """Pad a unique seed set to ``batch_size`` with distinct filler ids.

    The sampler's static shapes are a function of seed count, so every
    request is padded to the server's configured request size.  Fillers are
    the smallest VALID vertex ids not already in ``seeds`` (cheap,
    deterministic, unique, and < ``n_vertices`` — both the sampler's
    without-replacement contract and its id range hold).
    """
    seeds = np.asarray(seeds, np.int64)
    if len(seeds) > batch_size:
        raise ValueError(f"request has {len(seeds)} seeds > "
                         f"request_batch_size={batch_size}")
    if batch_size > n_vertices:
        raise ValueError(f"cannot pad to {batch_size} unique seeds on a "
                         f"{n_vertices}-vertex graph")
    need = batch_size - len(seeds)
    if not need:
        return seeds
    candidates = np.arange(min(batch_size + len(seeds), n_vertices))
    filler = np.setdiff1d(candidates, seeds)[:need]
    return np.concatenate([seeds, filler])


@dataclass
class MicroBatch:
    requests: list                  # admitted ServeRequests, packed order
    minibatches: list               # per-request sampled MiniBatch
    unique_ids: np.ndarray          # sorted union of all padded node ids
    scatter: list                   # per-request: nodes -> unique_ids index
    n_valid: list                   # per-request real (unpadded) seed count
    unique_per_request: list        # per-request unique node ids (computed
                                    # once; reused by all dedup accounting)

    @property
    def n_edges(self) -> int:
        return sum(len(b.src_pos) for mb in self.minibatches
                   for b in mb.blocks)

    @property
    def rows_requested(self) -> int:
        """Unique rows per request — the counterfactual fetch volume had
        each request been served alone (within-request dedup only), so the
        dedup-savings metrics isolate CROSS-request coalescing."""
        return sum(len(u) for u in self.unique_per_request)


class MicroBatcher:
    """Builds a deduplicated ``MicroBatch`` from admitted requests."""

    def __init__(self, sampler: NeighborSampler, batch_size: int):
        self.sampler = sampler
        self.batch_size = batch_size

    def build(self, requests: list) -> MicroBatch:
        n_v = self.sampler.g.n_vertices
        mbs: list[MiniBatch] = [
            self.sampler.sample(pad_seeds(r.seeds, self.batch_size, n_v))
            for r in requests]
        per_request = [np.unique(mb.nodes) for mb in mbs]
        uniq = (np.unique(np.concatenate(per_request)) if per_request
                else np.empty(0, np.int64))
        scatter = [np.searchsorted(uniq, mb.nodes) for mb in mbs]
        return MicroBatch(requests, mbs, uniq, scatter,
                          [len(r.seeds) for r in requests], per_request)

    def gather(self, cache, micro: MicroBatch, dedup: bool = True):
        """Fetch the micro-batch's features through the cache's split-phase
        API — the same plan/gather/stats path the trainer pipelines.

        With ``dedup`` the union id set is gathered exactly once and
        per-request feature matrices are scattered back out of the unique
        row block; the ablation path gathers per request.  Either way the
        batch reaches the cache's fused lookup (``ServerConfig.
        fused_lookup``), which collapses any residual duplicates before
        the miss list hits the IO engines.  Returns
        ``(feats, n_device, n_host, n_storage, rows_fetched, storage_virt)``
        so the server can do virtual-time and dedup accounting; misses
        count BOTH un-cached tiers (local storage and remote peers) and
        ``storage_virt`` is the miss-path virtual seconds the tickets
        actually resolved with — ``max`` of the storage and remote legs,
        which run on parallel engine queues (``PendingGather.io_virt``).
        """
        if dedup:
            pending = cache.submit_planned(micro.unique_ids)
            rows = cache.complete_planned(pending)
            feats = [gather_rows(rows, torch.from_numpy(sc).to(rows.device))
                     for sc in micro.scatter]
            return (feats, pending.n_device,
                    pending.n_host, pending.n_storage + pending.n_remote,
                    len(micro.unique_ids), pending.io_virt)
        feats, n_dev, n_host, n_sto, t_sto = [], 0, 0, 0, 0.0
        for mb in micro.minibatches:
            pending = cache.submit_planned(mb.nodes)
            feats.append(cache.complete_planned(pending))
            n_dev += pending.n_device
            n_host += pending.n_host
            n_sto += pending.n_storage + pending.n_remote
            t_sto += pending.io_virt
        return feats, n_dev, n_host, n_sto, micro.rows_requested, t_sto
