"""Write-back bookkeeping for mutable cache tiers.

The read-only cache could treat eviction as free because a cached row was
always a *copy* of storage.  The moment rows mutate in place (trainable
embeddings, MoE expert state), a cached row can be the ONLY current copy:
``MutableTierTable`` tracks which resident rows are dirty (ahead of
storage) and a monotonically-increasing per-row version, so the cache can

  * flush dirty rows through one batched ``submit_write`` ticket before a
    demotion drops the tier copy (flush-on-demote),
  * expose a ``flush()`` barrier for epoch/checkpoint boundaries, and
  * let placement policies bias demotion away from dirty rows (a dirty
    demotion costs a storage write a clean demotion does not).

Thread-safe: the cache's refresh lock serializes structural changes, but
gathers and pipeline operators may inspect dirty state concurrently.
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.iostack import JOURNAL_FILE


@dataclass
class WriteResult:
    """One ``write_planned()``: where the written rows landed."""
    rows: int = 0                       # unique rows written (last-writer-wins)
    device_rows: int = 0                # updated in the HBM tier
    host_rows: int = 0                  # updated in the DRAM tier
    through_rows: int = 0               # written straight to storage
    virtual_s: float = 0.0              # storage write-ticket time


@dataclass
class FlushResult:
    """One ``flush()`` barrier (or flush-on-demote leg)."""
    rows: int = 0
    bytes: int = 0
    virtual_s: float = 0.0


class MutableTierTable:
    """Per-row dirty bits + versions for the mutable cache tiers.

    A row is *dirty* when its freshest value lives in a cache tier and
    storage is stale; versions count successful writes per row, so
    read-your-writes violations show up as version regressions in tests.
    """

    def __init__(self, n_rows: int):
        self.n_rows = n_rows
        self._dirty = np.zeros(n_rows, bool)
        self._version = np.zeros(n_rows, np.int64)
        self._lock = threading.Lock()

    # -- mutation (called under the cache's refresh lock) -----------------
    def mark_dirty(self, ids: np.ndarray) -> None:
        if len(ids):
            with self._lock:
                self._dirty[ids] = True
                np.add.at(self._version, ids, 1)

    def bump_version(self, ids: np.ndarray) -> None:
        """Version bump without dirtying — write-through rows: storage is
        current, but the write still happened."""
        if len(ids):
            with self._lock:
                np.add.at(self._version, ids, 1)

    def clear_dirty(self, ids: np.ndarray) -> None:
        if len(ids):
            with self._lock:
                self._dirty[ids] = False

    def clear_dirty_if_version(self, ids: np.ndarray,
                               versions: np.ndarray) -> int:
        """Version-checked dirty clear for SPLIT-PHASE flush completion:
        only rows whose version still matches the snapshot taken at flush
        SUBMIT time are cleared.  A row re-written while its flush ticket
        was in flight is dirty *again* with a newer value — clearing it
        unconditionally would silently drop that value at the next flush
        barrier.  Returns the number of rows actually cleared."""
        if not len(ids):
            return 0
        with self._lock:
            ok = self._version[ids] == versions
            self._dirty[ids[ok]] = False
            return int(ok.sum())

    # -- inspection -------------------------------------------------------
    def is_dirty(self, ids: np.ndarray) -> np.ndarray:
        with self._lock:
            return self._dirty[ids]

    def dirty_ids(self) -> np.ndarray:
        with self._lock:
            return np.where(self._dirty)[0]

    @property
    def n_dirty(self) -> int:
        with self._lock:
            return int(self._dirty.sum())

    def dirty_mask(self) -> np.ndarray:
        """Snapshot of the dirty bitmap (copy: safe to hand to policies)."""
        with self._lock:
            return self._dirty.copy()

    def versions(self, ids: np.ndarray) -> np.ndarray:
        with self._lock:
            return self._version[ids].copy()


class WriteCombiner:
    """Write-combining buffer for flush-on-demote.

    Consecutive ``refresh()``/prefetch demotions often evict a handful of
    dirty rows each — paying one storage ticket per tiny batch squanders
    the striped engine's range coalescing.  The combiner buffers those
    rows' values (it becomes the FRESHEST holder once the tier copy
    drops) and releases them as ONE batched ticket when ``min_rows``
    accumulate or a flush barrier drains it.  While a row sits here its
    dirty bit stays set — storage is still stale — and gathers overlay
    the buffered value over the (stale) storage read.

    Merging is last-writer-wins by row id; ``drop()`` removes entries a
    newer write-through superseded.  Thread-safe.
    """

    def __init__(self, min_rows: int = 256):
        self.min_rows = min_rows
        self._ids = np.empty(0, np.int64)
        self._rows: np.ndarray | None = None
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ids)

    @property
    def ready(self) -> bool:
        """Enough buffered rows to justify one combined ticket."""
        with self._lock:
            return len(self._ids) >= self.min_rows

    def add(self, ids: np.ndarray, rows: np.ndarray) -> None:
        ids = np.asarray(ids)
        if not len(ids):
            return
        with self._lock:
            if self._rows is None or not len(self._ids):
                self._ids, self._rows = ids.copy(), np.array(rows, copy=True)
            else:
                from repro_torch.core.iostack import keep_last_writer
                self._ids, self._rows = keep_last_writer(
                    np.concatenate([self._ids, ids]),
                    np.concatenate([self._rows, rows]))

    def lookup(self, ids: np.ndarray):
        """Overlay for a gather/admission of ``ids``: ``(mask, rows)``
        where ``rows`` are the buffered values for ``ids[mask]`` — or
        ``None`` when nothing matches.  Buffered values are fresher than
        storage by construction."""
        with self._lock:
            if self._rows is None or not len(self._ids):
                return None
            mask = np.isin(ids, self._ids)
            if not mask.any():
                return None
            sorter = np.argsort(self._ids, kind="stable")
            at = sorter[np.searchsorted(self._ids[sorter], ids[mask])]
            return mask, self._rows[at].copy()

    def take(self):
        """Pop everything buffered (for the combined ticket); the caller
        owns flushing the returned ``(ids, rows)``."""
        with self._lock:
            ids, rows = self._ids, self._rows
            self._ids, self._rows = np.empty(0, np.int64), None
            return ids, rows

    def drop(self, ids: np.ndarray) -> np.ndarray:
        """Remove entries a newer write superseded (write-through made
        storage current, or a promotion made a tier the freshest holder).
        Returns the ids actually removed."""
        with self._lock:
            if not len(self._ids):
                return np.empty(0, np.int64)
            keep = ~np.isin(self._ids, ids)
            dropped = self._ids[~keep]
            self._ids = self._ids[keep]
            if self._rows is not None:
                self._rows = self._rows[keep]
            return dropped


_JOURNAL_MAGIC = b"HELJ1\n"


class FlushJournal:
    """Write-intent redo journal for crash-consistent flush barriers.

    The flush path is submit -> shard writes land out of order ->
    complete -> ``store.flush()``.  A crash anywhere in that window can
    tear the barrier: some shards programmed, some not, and the dirty
    bits that said which rows were in flight died with the process.  The
    journal closes the window REDO-style:

      * ``record(ids, rows)`` durably stages the full barrier payload
        (atomic tmp+fsync+rename — the journal itself can't tear: either
        the complete entry exists or the old state does) BEFORE the
        first shard write is submitted,
      * ``commit()`` removes it only after ``store.flush()`` made every
        row durable,
      * ``recover(store)`` on restart replays a pending barrier (rewrites
        ALL journalled rows — idempotent, last-writer-wins deduped at
        record time) or discards a torn/corrupt journal entry, since a
        tear can only happen before ``record`` returned, i.e. before any
        shard write was issued.

    The payload is checksummed, so torn-write detection on the journal
    file itself is part of restore.
    """

    def __init__(self, root: str):
        self.path = os.path.join(root, JOURNAL_FILE)

    def record(self, ids: np.ndarray, rows: np.ndarray) -> None:
        ids = np.ascontiguousarray(np.asarray(ids, np.int64))
        rows = np.ascontiguousarray(rows)
        id_b, row_b = ids.tobytes(), rows.tobytes()
        hdr = {"n": int(len(ids)), "row_dim": int(rows.shape[1]),
               "dtype": rows.dtype.name,
               "crc": zlib.crc32(row_b, zlib.crc32(id_b)) & 0xFFFFFFFF}
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_JOURNAL_MAGIC)
            f.write((json.dumps(hdr) + "\n").encode())
            f.write(id_b)
            f.write(row_b)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)      # atomic: all-or-nothing intent

    def commit(self) -> None:
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass                        # already committed / never recorded

    def pending(self):
        """``None`` (no journal), ``("ok", ids, rows)`` (intact barrier to
        replay) or ``("torn", None, None)`` (corrupt/torn entry)."""
        try:
            with open(self.path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        try:
            if not blob.startswith(_JOURNAL_MAGIC):
                raise ValueError("bad magic")
            body = blob[len(_JOURNAL_MAGIC):]
            nl = body.index(b"\n")
            hdr = json.loads(body[:nl])
            n, dim = int(hdr["n"]), int(hdr["row_dim"])
            dt = np.dtype(hdr["dtype"])
            payload = body[nl + 1:]
            id_nb = n * 8
            if len(payload) != id_nb + n * dim * dt.itemsize:
                raise ValueError("truncated payload")
            if zlib.crc32(payload) & 0xFFFFFFFF != hdr["crc"]:
                raise ValueError("crc mismatch")
            ids = np.frombuffer(payload[:id_nb], np.int64)
            rows = np.frombuffer(payload[id_nb:], dt).reshape(n, dim)
            return "ok", ids, rows
        except (ValueError, KeyError, json.JSONDecodeError):
            return "torn", None, None

    def recover(self, store) -> dict:
        """Replay-or-discard on restart; returns what happened."""
        st = self.pending()
        if st is None:
            return {"action": "none"}
        state, ids, rows = st
        if (state != "ok" or rows.shape[1] != store.row_dim
                or rows.dtype != store.dtype):
            # torn journal = crash BEFORE record() returned, so no shard
            # write of this barrier was ever issued: discarding is safe
            self.commit()
            return {"action": "discarded"}
        store.write_rows(ids.copy(), np.array(rows), dedupe=False)
        store.flush()
        self.commit()
        return {"action": "replayed", "rows": int(len(ids))}
