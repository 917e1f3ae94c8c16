"""Row-ownership partitioning for multi-worker scale-out.

Splits the graph's feature rows across N simulated workers, each owning a
private ``FeatureStore`` (its own shard set).  Two ownership maps:

  * ``ConsistentHashPartition`` — virtual-node hash ring.  Ownership is a
    pure function of the row id and ring seed, so adding/removing a worker
    only remaps the rows on the affected ring arcs (~1/N of the keyspace),
    never a global reshuffle.
  * ``DegreeBalancedPartition`` — greedy largest-first bin packing on
    degree mass, so each worker serves a comparable share of the *traffic*
    (power-law graphs concentrate most gathers on few hot vertices; equal
    row counts would leave one worker serving most requests).

``PartitionedFeatureStore`` materialises one worker-local store per
partition plus global->local row maps, and keeps a whole-fleet
``read_rows``/``write_rows`` convenience view so single-node code (tests,
checkpoint streaming) can treat the fleet as one logical store.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core.iostack import FeatureStore, keep_last_writer


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic avalanche hash over int64 ids (vectorised)."""
    z = (x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class ConsistentHashPartition:
    """Virtual-node consistent-hash ring over row ids.

    Each worker projects ``n_vnodes`` points onto a 64-bit ring; a row is
    owned by the worker of the first ring point at or after the row's
    hash.  Ownership of any given row survives fleet resizing except on
    the arcs adjacent to the changed worker's vnodes.
    """

    def __init__(self, n_rows: int, n_workers: int, n_vnodes: int = 64,
                 seed: int = 0):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n_rows, self.n_workers = n_rows, n_workers
        ring_pts, ring_own = [], []
        for w in range(n_workers):
            pts = _splitmix64(np.arange(n_vnodes, dtype=np.int64)
                              + (w + 1) * 0x10001 + seed * 0x7F4A7C15)
            ring_pts.append(pts)
            ring_own.append(np.full(n_vnodes, w, np.int64))
        pts = np.concatenate(ring_pts)
        own = np.concatenate(ring_own)
        order = np.argsort(pts, kind="stable")
        self._ring = pts[order]
        self._ring_owner = own[order]
        h = _splitmix64(np.arange(n_rows, dtype=np.int64))
        idx = np.searchsorted(self._ring, h, side="left")
        idx[idx == len(self._ring)] = 0         # wrap past the last vnode
        self.owner = self._ring_owner[idx]

    def owner_of(self, ids: np.ndarray) -> np.ndarray:
        return self.owner[np.asarray(ids)]

    def rows_of(self, worker: int) -> np.ndarray:
        return np.where(self.owner == worker)[0]


class DegreeBalancedPartition:
    """Greedy largest-first packing of degree mass onto N workers."""

    def __init__(self, degrees: np.ndarray, n_workers: int):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        degrees = np.asarray(degrees, np.float64)
        self.n_rows, self.n_workers = len(degrees), n_workers
        self.owner = np.empty(self.n_rows, np.int64)
        # hottest rows placed first onto the least-loaded worker; ties
        # break by worker id so the map is deterministic
        order = np.argsort(-degrees, kind="stable")
        load = np.zeros(n_workers, np.float64)
        count = np.zeros(n_workers, np.int64)
        for i in order:
            w = int(np.lexsort((np.arange(n_workers), count, load))[0])
            self.owner[i] = w
            load[w] += degrees[i] + 1.0     # +1: zero-degree rows still
            count[w] += 1                   # spread across the fleet

    def owner_of(self, ids: np.ndarray) -> np.ndarray:
        return self.owner[np.asarray(ids)]

    def rows_of(self, worker: int) -> np.ndarray:
        return np.where(self.owner == worker)[0]


def make_partition(kind: str, n_rows: int, n_workers: int,
                   degrees: np.ndarray | None = None, seed: int = 0):
    """``hash`` -> ConsistentHashPartition, ``degree`` -> DegreeBalanced."""
    if kind == "degree":
        if degrees is None:
            raise ValueError("degree-balanced partition needs degrees")
        return DegreeBalancedPartition(degrees, n_workers)
    if kind == "hash":
        return ConsistentHashPartition(n_rows, n_workers, seed=seed)
    raise ValueError(f"unknown partition kind {kind!r}")


class PartitionedFeatureStore:
    """N worker-local ``FeatureStore``s under one global row space.

    Worker ``w`` owns the rows ``partition.rows_of(w)`` and stores them
    contiguously (global order) in its own shard set under
    ``root/worker_{w}``.  ``to_local`` maps global ids to
    ``(owner, local_row)`` pairs; the whole-fleet ``read_rows`` /
    ``write_rows`` views make the fleet interchangeable with one logical
    store for geometry-agnostic callers.
    """

    def __init__(self, root: str, n_rows: int, row_dim: int, partition,
                 dtype=np.float32, n_shards: int = 4, create: bool = False,
                 rng_seed: int | None = None, writable: bool = False):
        if partition.n_rows != n_rows:
            raise ValueError(f"partition covers {partition.n_rows} rows, "
                             f"store has {n_rows}")
        self.n_rows, self.row_dim = n_rows, row_dim
        self.dtype = np.dtype(dtype)
        self.row_bytes = self.row_dim * self.dtype.itemsize
        self.writable = writable
        self.partition = partition
        self.n_workers = partition.n_workers
        self.owner = partition.owner_of(np.arange(n_rows))
        self.worker_rows = [np.where(self.owner == w)[0]
                            for w in range(self.n_workers)]
        # local row index of every global id within its owner's store
        self.local_index = np.empty(n_rows, np.int64)
        for w, rows in enumerate(self.worker_rows):
            self.local_index[rows] = np.arange(len(rows))
        seeding = create and rng_seed is not None
        self.stores = []
        for w, rows in enumerate(self.worker_rows):
            path = os.path.join(root, f"worker_{w}")
            st = FeatureStore(path, len(rows), row_dim, dtype=dtype,
                              n_shards=n_shards, create=create,
                              writable=writable or seeding)
            if seeding and len(rows):
                # rows carry GLOBAL-seeded content so a partitioned fleet
                # holds bit-identical data no matter how many workers split
                # it — the cross-mode consistency gates rely on that
                st.write_rows(np.arange(len(rows)),
                              reference_rows(rows, row_dim, rng_seed,
                                             self.dtype), dedupe=False)
                st.flush()
                if not writable:        # reopen at the requested mode
                    st = FeatureStore(path, len(rows), row_dim, dtype=dtype,
                                      n_shards=n_shards, writable=False)
            self.stores.append(st)

    # -- global <-> local ------------------------------------------------
    def to_local(self, ids: np.ndarray):
        ids = np.asarray(ids)
        return self.owner[ids], self.local_index[ids]

    def owner_of(self, ids: np.ndarray) -> np.ndarray:
        return self.owner[np.asarray(ids)]

    # -- whole-fleet logical-store view ----------------------------------
    def read_rows(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        own, loc = self.to_local(ids)
        out = np.empty((len(ids), self.row_dim), self.dtype)
        for w in range(self.n_workers):
            m = own == w
            if m.any():
                out[m] = self.stores[w].read_rows(loc[m])
        return out

    def write_rows(self, ids: np.ndarray, rows: np.ndarray,
                   dedupe: bool = True) -> None:
        if not self.writable:
            raise PermissionError("partitioned store opened read-only; "
                                  "pass writable=True to enable writes")
        ids = np.asarray(ids)
        rows = np.asarray(rows, self.dtype)
        if dedupe:
            ids, rows = keep_last_writer(ids, rows)
        own, loc = self.to_local(ids)
        for w in range(self.n_workers):
            m = own == w
            if m.any():
                self.stores[w].write_rows(loc[m], rows[m], dedupe=False)

    def flush(self) -> None:
        for st in self.stores:
            st.flush()


def reference_rows(ids: np.ndarray, row_dim: int, rng_seed: int,
                   dtype=np.float32) -> np.ndarray:
    """Globally-seeded row content: row ``i`` is the same no matter which
    worker (or how many workers) stores it.  One independent Philox stream
    per row keyed on (seed, id) — O(k) in the rows requested."""
    dtype = np.dtype(dtype)
    out = np.empty((len(ids), row_dim), dtype)
    for j, gid in enumerate(np.asarray(ids)):
        rng = np.random.default_rng([rng_seed, int(gid)])
        out[j] = rng.standard_normal(row_dim).astype(dtype)
    return out
