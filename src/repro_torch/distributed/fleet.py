"""Serving fleet: R inference replicas over shared storage.

``ServingFleet`` runs R ``GNNInferenceServer`` replicas against ONE
shared feature store (each replica owns its private cache tiers + IO
engine) behind a power-of-two-choices router: every request samples two
distinct replicas and joins the one with the shorter scheduler queue —
the classic load-balancing result that turns O(log R / log log R) max
queue imbalance into O(log log R) at the cost of two queue-depth probes.

Cross-replica embedding coherence is owner-writes + version-based
invalidation:

  * every row has ONE owner replica (consistent-hash over replica ids);
    ``write_embeddings`` routes each row's update to its owner's cache,
    which writes THROUGH to the shared store (fleet replicas run the
    ``writethrough`` policy so storage is current the moment the write
    ticket lands);
  * the fleet bumps a global version counter per written row (the same
    ``MutableTierTable`` machinery the write-back path uses) and queues
    the ids for every OTHER replica;
  * before a replica next serves, the router settles its queued
    invalidations: ids whose global version moved past the replica's
    applied snapshot get their cached tier copies refreshed from storage
    (``HeteroCache.invalidate_rows``); ids already current are skipped —
    the version check is what makes redundant invalidations free.

A stale replica therefore serves at most the requests routed to it
BEFORE the owner's write completed — never a torn or half-applied row.

PyTorch port of ``repro.distributed.fleet``.  ``ServerConfig.device``
(default ``"cuda"``) places every replica; all replicas live in one
process on that one device and serve ONE set of parameter tensors, drawn
as the port's server draws them (a seeded ``torch.Generator``) unless
``params`` is given (``gnn.models.params_from_numpy`` carries the
reference's across).  The router is the reference's numpy code, so routes
match it for the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.iostack import keep_last_writer
from repro_torch.core.writeback import MutableTierTable
from repro_torch.distributed.partition import ConsistentHashPartition
from repro_torch.gnn.graph import CSRGraph
from repro_torch.gnn.models import init_gnn_params
from repro_torch.obs import trace as _trace
from repro_torch.serving.scheduler import INTERACTIVE, PriorityClass
from repro_torch.serving.service import GNNInferenceServer, ServerConfig


class PowerOfTwoRouter:
    """Two random probes, join the shorter queue (ties -> lower index)."""

    def __init__(self, n_replicas: int, seed: int = 0):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.n = n_replicas
        self.rng = np.random.default_rng(seed)
        self.route_counts = np.zeros(n_replicas, np.int64)

    def pick(self, depths) -> int:
        if self.n == 1:
            choice = 0
        else:
            a, b = self.rng.choice(self.n, size=2, replace=False)
            a, b = int(min(a, b)), int(max(a, b))
            choice = a if depths[a] <= depths[b] else b
        self.route_counts[choice] += 1
        return choice


class ServingFleet:
    """R replicas + router + owner-writes/version-invalidate coherence."""

    def __init__(self, graph: CSRGraph, store, n_replicas: int = 2,
                 cfg: ServerConfig | None = None, seed: int = 0,
                 params=None):
        cfg = cfg if cfg is not None else ServerConfig()
        # resolved first: no card for device="cuda" raises before any
        # replica's engine thread starts
        device = resolve_device(cfg.device)
        if store.writable:
            # fleet coherence needs owner writes visible to peers via the
            # shared store the moment the ticket lands; every other knob
            # (including fused_lookup — each replica's cache runs the fused
            # dedup plan over its own loc/slot tables) rides through
            cfg = dataclasses.replace(cfg, write_policy="writethrough")
        self.cfg = cfg
        self.store = store
        # one parameter set on the device, shared by every replica
        if params is None:
            params = init_gnn_params(torch.Generator().manual_seed(cfg.seed),
                                     cfg.model, store.row_dim, cfg.hidden,
                                     graph.n_classes, device=device)
        self.params = params
        self.replicas = [GNNInferenceServer(graph, store, cfg, params=params)
                         for _ in range(n_replicas)]
        self.router = PowerOfTwoRouter(n_replicas, seed=seed)
        # row -> owner replica (stable under fleet resize: hash ring)
        self.ownership = ConsistentHashPartition(store.n_rows, n_replicas,
                                                 seed=seed)
        # global write-version authority + per-replica applied snapshots
        self.versions = MutableTierTable(store.n_rows)
        self._applied = [np.zeros(store.n_rows, np.int64)
                         for _ in range(n_replicas)]
        self._pending_inval: list[list] = [[] for _ in range(n_replicas)]
        self.invalidated_rows = 0
        self.embedding_writes = 0

    # -- routing ---------------------------------------------------------
    def queue_depths(self) -> list:
        return [len(r.scheduler) for r in self.replicas]

    def submit(self, seeds: np.ndarray,
               klass: PriorityClass = INTERACTIVE):
        """Route one request power-of-two-choices; returns
        ``(future, replica_index)``."""
        i = self.router.pick(self.queue_depths())
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            tr.instant("fleet.route", track=f"replica{i}", cat="fleet",
                       args={"replica": i, "seeds": len(seeds),
                             "klass": klass.name})
        self._settle_invalidations(i)
        return self.replicas[i].submit(seeds, klass), i

    def flush(self):
        """Drain every replica's queue; returns per-replica stats."""
        for i, r in enumerate(self.replicas):
            self._settle_invalidations(i)
            r.flush()
        return [r.stats for r in self.replicas]

    # -- coherence -------------------------------------------------------
    def write_embeddings(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Owner-writes: each row's update lands at its owner replica's
        cache (write-through to the shared store), the global version
        bumps, and every other replica is queued an invalidation.
        ``rows`` is host numpy, as the reference takes it."""
        ids = np.asarray(ids)
        rows = np.asarray(rows, self.store.dtype)
        ids, rows = keep_last_writer(ids, rows)
        if not len(ids):
            return
        owner = self.ownership.owner_of(ids)
        for w in range(len(self.replicas)):
            m = owner == w
            if not m.any():
                continue
            wids = ids[m]
            self.replicas[w].cache.write_planned(wids, rows[m])
            self.versions.bump_version(wids)
            # the owner's own tiers/store are current as of this write
            self._applied[w][wids] = self.versions.versions(wids)
            for peer in range(len(self.replicas)):
                if peer != w:
                    self._pending_inval[peer].append(wids)
        self.embedding_writes += 1

    def _settle_invalidations(self, i: int) -> int:
        """Apply replica ``i``'s queued invalidations whose global version
        moved past its applied snapshot; skip already-current ids."""
        if not self._pending_inval[i]:
            return 0
        ids = np.unique(np.concatenate(self._pending_inval[i]))
        self._pending_inval[i] = []
        stale = ids[self.versions.versions(ids) > self._applied[i][ids]]
        if not len(stale):
            return 0
        n, _ = self.replicas[i].cache.invalidate_rows(stale)
        self._applied[i][stale] = self.versions.versions(stale)
        self.invalidated_rows += n
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            tr.instant("fleet.invalidate", track=f"replica{i}", cat="fleet",
                       args={"replica": i, "rows": n})
        return n

    # -- lifecycle -------------------------------------------------------
    def close(self):
        for r in self.replicas:
            r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
