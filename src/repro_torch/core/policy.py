"""Pluggable cache-placement policies (paper §3.2; Ginex-informed).

The heterogeneous cache asks its policy three questions: where should rows
live *now* (``placement_scores``), has the answer changed enough to act on
(``refresh_due``), and — continuously — what is the workload actually
touching (``record``, fed from the unified gather path).  Placement itself
is mechanical: rank rows by score, top ``device_rows`` to HBM, next
``host_rows`` to DRAM, rest stay on storage (``placement``).

Policies:
  * StaticPresamplePolicy — the original one-shot pre-sampling placement
    (extracted from ``hotness``): scores are frozen at construction, no
    refresh is ever due.
  * OnlineDecayPolicy     — decayed-count (EWMA) hotness over the live
    access stream with hysteresis: resident rows get a score boost so a
    challenger must be clearly hotter to trigger migration, and refreshes
    are only due every ``refresh_every`` recorded batches.
  * OracleOfflinePolicy   — Ginex-style offline upper bound: it is handed
    the full future access trace and places by the access counts of the
    *upcoming* window at every window boundary.
  * BeladyOraclePolicy    — Belady's MIN per-access bound: re-places before
    every batch by exact next-use distance; upper-bounds the windowed
    oracle and measures the headroom its cadence leaves.

Policies also see the write-back dirty bitmap at placement time
(``placement_scores(loc, dirty=...)``): demoting a dirty row costs a flush
write, so the online policy boosts dirty residents by ``write_bias``.
"""
from __future__ import annotations

import threading
from typing import Protocol, runtime_checkable

import numpy as np


def placement(hotness: np.ndarray, device_rows: int, host_rows: int,
              base_loc: np.ndarray | None = None):
    """Rank-by-hotness placement: returns (loc, slot) arrays.

    loc[i]  in {0: device, 1: host, 2: storage, 3: remote peer}
    slot[i] = index within its tier (storage/remote addressed by row id).
    """
    order = np.argsort(-np.asarray(hotness), kind="stable")
    return tables_from_sets(len(hotness), order[:device_rows],
                            order[device_rows:device_rows + host_rows],
                            base_loc=base_loc)


def tables_from_sets(n_rows: int, dev_ids: np.ndarray,
                     host_ids: np.ndarray,
                     base_loc: np.ndarray | None = None):
    """(loc, slot) translation tables for explicit tier membership, where
    ``dev_ids[s]`` / ``host_ids[s]`` is the row held in tier slot ``s``.
    ``base_loc`` gives the un-cached tier of every row (2 = local storage;
    3 = remote peer under scale-out); default all-storage."""
    loc = (np.full(n_rows, 2, np.int8) if base_loc is None
           else np.asarray(base_loc, np.int8).copy())
    slot = np.arange(n_rows, dtype=np.int64)   # storage: slot == row id
    loc[dev_ids] = 0
    slot[dev_ids] = np.arange(len(dev_ids))
    loc[host_ids] = 1
    slot[host_ids] = np.arange(len(host_ids))
    return loc, slot


def patch_tables(loc: np.ndarray, slot: np.ndarray, ids: np.ndarray,
                 new_loc: np.ndarray, new_slot: np.ndarray):
    """O(k)-scatter copy-on-write patch of the (loc, slot) tables.

    The swap primitive for promotions/demotions touching ``k`` rows: the
    tables are memcpy'd (in-flight gathers keep their snapshot) and only
    the ``k`` changed entries are rewritten, instead of rebuilding both
    tables from the full tier membership lists the way
    ``tables_from_sets`` does."""
    loc2, slot2 = loc.copy(), slot.copy()
    loc2[ids] = new_loc
    slot2[ids] = new_slot
    return loc2, slot2


@runtime_checkable
class CachePolicy(Protocol):
    """What ``HeteroCache`` needs from a placement policy."""

    name: str

    def initial_scores(self) -> np.ndarray:
        """Hotness scores for the construction-time placement."""
        ...

    def record(self, ids: np.ndarray) -> None:
        """Observe one gathered batch of row ids (the live access stream)."""
        ...

    def refresh_due(self) -> bool:
        """Should the cache re-derive placement now?"""
        ...

    def placement_scores(self, loc: np.ndarray | None = None,
                         dirty: np.ndarray | None = None):
        """Current scores (``None`` = keep placement).  ``loc`` is the live
        location table so the policy can favour residents (hysteresis);
        ``dirty`` is the write-back dirty bitmap so demoting a row that
        costs a flush write needs a clearly hotter challenger."""
        ...

    def refreshed(self) -> None:
        """Notification that the cache applied a refresh."""
        ...

    def prefetch_candidates(self, loc: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` storage-resident row ids predicted to turn hot,
        ranked hottest-first — the cache pulls these BEFORE they are
        requested (``HeteroCache.maybe_prefetch``).  Empty = nothing to
        prefetch."""
        ...


class StaticPresamplePolicy:
    """Frozen pre-sampling placement — the original cache behavior."""

    name = "static"

    def __init__(self, hotness: np.ndarray):
        self._scores = np.asarray(hotness, np.float64)

    def initial_scores(self) -> np.ndarray:
        return self._scores.copy()

    def record(self, ids: np.ndarray) -> None:
        pass

    def refresh_due(self) -> bool:
        return False

    def placement_scores(self, loc: np.ndarray | None = None,
                         dirty: np.ndarray | None = None) -> np.ndarray:
        return self._scores.copy()

    def refreshed(self) -> None:
        pass

    def prefetch_candidates(self, loc: np.ndarray, k: int) -> np.ndarray:
        return np.empty(0, np.int64)    # frozen scores predict no movers


class OnlineDecayPolicy:
    """EWMA/decayed-count hotness from the live access stream.

    Per recorded batch every score decays by ``0.5 ** (1 / half_life)`` and
    touched rows gain one count, so the score is an exponentially-weighted
    access frequency with a ``half_life``-batch memory.  ``hysteresis``
    multiplies resident (cached) scores by ``1 + hysteresis`` at placement
    time: a challenger must beat an incumbent by that margin before the
    cache migrates, which stops near-tie rows from thrashing between
    tiers.  A refresh is only proposed every ``refresh_every`` batches.

    Every per-batch operation is O(k) in the rows TOUCHED, never O(n_rows):
    decay is lazy (scores carry a per-row timestamp and pay their deferred
    decay on next touch, so recording a batch multiplies k entries instead
    of the whole array), and the prefetch trend tracks only the rows
    recorded since the last check — an untouched row can only decay, so it
    can never have a rising trend and needs no inspection.  Only
    ``placement_scores`` — the refresh-cadence call that must rank ALL
    rows — materialises a dense array.
    """

    name = "online"

    def __init__(self, n_rows: int, init_scores: np.ndarray | None = None,
                 half_life: float = 16.0, refresh_every: int = 8,
                 hysteresis: float = 0.1, write_bias: float = 0.25):
        if refresh_every < 1:
            raise ValueError("refresh_every must be >= 1")
        self._w = (np.zeros(n_rows, np.float64) if init_scores is None
                   else np.asarray(init_scores, np.float64).copy())
        if len(self._w) != n_rows:
            raise ValueError("init_scores length != n_rows")
        self.n_rows = n_rows
        self.decay = 0.5 ** (1.0 / half_life)
        self.refresh_every = refresh_every
        self.hysteresis = hysteresis
        self.write_bias = write_bias
        self._since_refresh = 0
        self._t = 0                     # recorded-batch counter (time base)
        self._ts = np.zeros(n_rows, np.int64)   # per-row last-touch time
        # prefetch trend state: per-row score value/time at its last trend
        # check, plus the set of rows touched since — delta against the
        # check-time score is the TREND that predicts rows turning hot
        self._trend_val = self._w.copy()
        self._trend_t = np.zeros(n_rows, np.int64)
        self._check_t = 0               # time of the last prefetch check
        self._touched_mask = np.zeros(n_rows, bool)
        self._touched: list = []
        self._lock = threading.Lock()

    def _score_at(self, ids: np.ndarray, t: int) -> np.ndarray:
        """Lazily-decayed scores of ``ids`` evaluated at time ``t``."""
        return self._w[ids] * self.decay ** (t - self._ts[ids])

    def initial_scores(self) -> np.ndarray:
        return self._w * self.decay ** (self._t - self._ts)

    def record(self, ids: np.ndarray) -> None:
        ids = np.asarray(ids)
        with self._lock:
            self._t += 1
            # settle each touched row's deferred decay, then count the
            # accesses: O(k), the untouched tail decays implicitly
            self._w[ids] = self._score_at(ids, self._t)
            self._ts[ids] = self._t
            np.add.at(self._w, ids, 1.0)
            fresh = ids[~self._touched_mask[ids]]
            if len(fresh):
                fresh = np.unique(fresh)
                self._touched_mask[fresh] = True
                self._touched.append(fresh)
            self._since_refresh += 1

    def refresh_due(self) -> bool:
        return self._since_refresh >= self.refresh_every

    def placement_scores(self, loc: np.ndarray | None = None,
                         dirty: np.ndarray | None = None) -> np.ndarray:
        with self._lock:
            # dense materialisation — refresh cadence only, never per batch
            s = self._w * self.decay ** (self._t - self._ts)
        if loc is not None and self.hysteresis:
            s[loc < 2] *= 1.0 + self.hysteresis
        if dirty is not None and self.write_bias:
            # dirty-aware demotion: evicting a dirty row costs a flush
            # write a clean eviction does not, so a challenger must beat a
            # dirty incumbent by an extra margin before migration pays
            s[dirty] *= 1.0 + self.write_bias
        return s

    def refreshed(self) -> None:
        with self._lock:
            self._since_refresh = 0

    def prefetch_candidates(self, loc: np.ndarray, k: int) -> np.ndarray:
        """Storage/remote-resident rows whose decayed-count score ROSE
        since the last prefetch check, hottest trend first.  A rising EWMA
        flags a row turning hot while its absolute score is still below the
        cached incumbents — prefetching it hides the cold misses it would
        take to climb the ranking by itself.  Untouched rows only decay and
        never qualify, so only the touched set is inspected: O(k log k) in
        the rows recorded since the last check, independent of n_rows."""
        with self._lock:
            if not self._touched:
                self._check_t = self._t     # refs still decay to this check
                return np.empty(0, np.int64)
            cand = np.unique(np.concatenate(self._touched))
            self._touched_mask[cand] = False
            self._touched = []
            # both sides of the delta evaluate against the PREVIOUS check:
            # the stored trend value decays forward to that check time,
            # reproducing exactly the dense-snapshot delta the O(n_rows)
            # implementation computed
            ref = (self._trend_val[cand]
                   * self.decay ** (self._check_t - self._trend_t[cand]))
            cur = self._score_at(cand, self._t)
            delta = cur - ref
            self._trend_val[cand] = cur
            self._trend_t[cand] = self._t
            self._check_t = self._t
        m = (delta > 0) & (loc[cand] >= 2)
        cand, delta = cand[m], delta[m]
        if len(cand) > k:
            top = np.argpartition(-delta, k - 1)[:k]
            cand, delta = cand[top], delta[top]
        return cand[np.argsort(-delta, kind="stable")]


class OracleOfflinePolicy:
    """Offline-optimal upper bound (after Ginex's provably-optimal cache):
    the policy is handed the complete future access trace and, at every
    ``window``-batch boundary, places by the counts of the *next* window —
    placement that no online policy can beat on the same cadence."""

    name = "oracle"

    def __init__(self, n_rows: int, trace, window: int = 8):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.n_rows = n_rows
        self.trace = [np.asarray(t) for t in trace]
        self.window = window
        self._cursor = 0
        self._due = False
        self._lock = threading.Lock()

    def _window_counts(self, start: int) -> np.ndarray:
        counts = np.zeros(self.n_rows, np.float64)
        for batch in self.trace[start:start + self.window]:
            np.add.at(counts, batch, 1.0)
        return counts

    def initial_scores(self) -> np.ndarray:
        return self._window_counts(0)

    def record(self, ids: np.ndarray) -> None:
        with self._lock:
            self._cursor += 1
            if self._cursor % self.window == 0:
                self._due = True

    def refresh_due(self) -> bool:
        return self._due and self._cursor < len(self.trace)

    def placement_scores(self, loc: np.ndarray | None = None,
                         dirty: np.ndarray | None = None):
        counts = self._window_counts(self._cursor)
        return counts if counts.any() else None

    def refreshed(self) -> None:
        with self._lock:
            self._due = False

    def prefetch_candidates(self, loc: np.ndarray, k: int) -> np.ndarray:
        """Exact upcoming-window knowledge: the storage rows the next
        ``window`` batches will touch, hottest first — the upper bound no
        trend heuristic can beat."""
        counts = self._window_counts(self._cursor)
        cand = np.where((counts > 0) & (loc >= 2))[0]
        if not len(cand):
            return cand
        return cand[np.argsort(-counts[cand], kind="stable")[:k]]


class BeladyOraclePolicy:
    """Belady's MIN as a placement policy: the exact per-access upper bound.

    Where ``OracleOfflinePolicy`` summarizes the next ``window`` batches
    into counts at window boundaries, Belady re-places before EVERY batch
    by next-use distance — the rows used soonest are the hottest, rows
    never used again score zero.  For a cache re-ranked each step this is
    the provably optimal eviction order, so its hit rate upper-bounds the
    windowed oracle (and every online policy) on the same trace; the gap
    between the two oracles is the headroom the windowed cadence leaves on
    the table.

    Next-use lookup is a CSR over per-row occurrence lists with a cursor
    that only moves forward, so the whole trace costs O(total accesses)
    amortized, not O(n_rows x n_batches).
    """

    name = "belady"

    def __init__(self, n_rows: int, trace):
        self.n_rows = n_rows
        self.trace = [np.unique(np.asarray(t)) for t in trace]
        t_idx = np.concatenate([np.full(len(u), t, np.int64)
                                for t, u in enumerate(self.trace)]) \
            if self.trace else np.empty(0, np.int64)
        r_idx = (np.concatenate(self.trace) if self.trace
                 else np.empty(0, np.int64))
        order = np.lexsort((t_idx, r_idx))
        self._occ_t = t_idx[order]                      # batch index, sorted
        r_sorted = r_idx[order]                         # by (row, batch)
        self._start = np.searchsorted(r_sorted, np.arange(n_rows))
        self._end = np.searchsorted(r_sorted, np.arange(n_rows), side="right")
        self._ptr = self._start.copy()                  # per-row cursor
        self._cursor = 0
        self._lock = threading.Lock()

    def _next_use(self) -> np.ndarray:
        """Per-row distance (in batches) to the next access at the current
        cursor; +inf when the row is never used again.  Pointers advance
        monotonically — each occurrence is skipped at most once, ever."""
        c = self._cursor
        ptr, end, occ = self._ptr, self._end, self._occ_t
        n = len(occ)
        if n == 0:                      # empty trace: nothing is ever used
            return np.full(self.n_rows, np.inf)
        while True:
            lag = (ptr < end) & (occ[np.minimum(ptr, n - 1)] < c)
            if not lag.any():
                break
            ptr[lag] += 1
        nxt = np.full(self.n_rows, np.inf)
        live = ptr < end
        nxt[live] = occ[np.minimum(ptr, n - 1)][live] - c
        return nxt

    def initial_scores(self) -> np.ndarray:
        return 1.0 / (1.0 + self._next_use())

    def record(self, ids: np.ndarray) -> None:
        with self._lock:
            self._cursor += 1

    def refresh_due(self) -> bool:
        return self._cursor < len(self.trace)           # re-place EVERY batch

    def placement_scores(self, loc: np.ndarray | None = None,
                         dirty: np.ndarray | None = None):
        with self._lock:
            return 1.0 / (1.0 + self._next_use())

    def refreshed(self) -> None:
        pass

    def prefetch_candidates(self, loc: np.ndarray, k: int) -> np.ndarray:
        """Storage rows with a finite next use, soonest first."""
        with self._lock:
            nxt = self._next_use()
        cand = np.where(np.isfinite(nxt) & (loc >= 2))[0]
        if not len(cand):
            return cand
        return cand[np.argsort(nxt[cand], kind="stable")[:k]]


def make_policy(kind: str, n_rows: int,
                presample: np.ndarray | None = None, trace=None,
                refresh_every: int = 8, half_life: float = 16.0,
                hysteresis: float = 0.1) -> CachePolicy:
    """Policy factory shared by the trainer, the server, and benchmarks."""
    if kind == "static":
        return StaticPresamplePolicy(
            np.zeros(n_rows) if presample is None else presample)
    if kind == "online":
        return OnlineDecayPolicy(n_rows, init_scores=presample,
                                 half_life=half_life,
                                 refresh_every=refresh_every,
                                 hysteresis=hysteresis)
    if kind == "oracle":
        if trace is None:
            raise ValueError("oracle policy requires the full access trace")
        return OracleOfflinePolicy(n_rows, trace, window=refresh_every)
    if kind == "belady":
        if trace is None:
            raise ValueError("belady policy requires the full access trace")
        return BeladyOraclePolicy(n_rows, trace)
    raise ValueError(f"unknown cache policy {kind!r} "
                     "(expected static | online | oracle | belady)")
