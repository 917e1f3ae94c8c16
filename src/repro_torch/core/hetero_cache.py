"""GPU-managed heterogeneous cache (paper §3.2).

Three tiers: device HBM (hottest rows, ~2 TB/s), host DRAM (second-hottest
rows + all topology, PCIe-fed), storage shards (everything, via the async
IO stack).  Placement is owned by a pluggable ``core.policy`` policy —
static pre-sampling by default, online decayed-count or offline-oracle on
request — and the tiers are *mutable*: ``refresh()`` promotes/demotes rows
between device/host/storage through the existing ``AsyncIOEngine``
tickets, so migration rides the same bounded IO stack as gathers and can
be scheduled on the pipeline's io resource to hide under device compute.

Gathers are split-phase so the trainer's operator pipeline and the serving
micro-batcher share ONE code path and ONE stats accounting site:

    pending = cache.submit_planned(ids)    # plan + async storage submit
    cache.lookup_planned(pending)          # host + device tier gathers
    rows = cache.complete_planned(pending) # wait IO, account, feed policy

``gather`` is the fused convenience form.  Lookup is device-parallel: the
location/slot translation tables are snapshotted per request batch, so a
concurrent refresh (which swaps fresh tables/tier arrays rather than
mutating in place) never corrupts an in-flight gather — the three tier
gathers are issued storage first (longest latency), then host, then
device, exactly the paper's overlap ordering.

PyTorch port of ``repro.core.hetero_cache``.  The device tier is a tensor
on the cache's ``device``; the host tier is a CPU tensor, pinned when that
device is a card, so the fused lookup kernel reads it in place over PCIe.
The fused lookup (``fused_backend="kernel"``, the default) is the K1 kernel
(``kernels/cache_lookup``): one call does lookup, dedup, the device- and
host-tier row copies straight into the output tensor, and the compacted
miss lists.  Every other device-tier read (the ``host`` backend, the
``fused=False`` ablation, refresh, demote, write paths) is the K2 row
gather (``kernels/gather``).  Storage and remote misses land through the
unchanged IO engines in a host staging buffer (pinned on a card); one
host-to-device copy and one index copy then place them, and
``complete_planned`` returns a tensor on the cache's device.
"""
from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.iostack import (AsyncIOEngine, FeatureStore,
                                      StreamClass, keep_last_writer)
from repro_torch.core.policy import (CachePolicy, StaticPresamplePolicy,
                                     patch_tables, tables_from_sets)
from repro_torch.core.simulator import (DEFAULT_ENVELOPE, HardwareEnvelope,
                                        dram_gather_time, hbm_gather_time,
                                        pcie_time)
from repro_torch.core.writeback import (FlushJournal, FlushResult,
                                        MutableTierTable, WriteCombiner,
                                        WriteResult)
from repro_torch.kernels.cache_lookup.ops import fused_cache_lookup
from repro_torch.kernels.gather.ops import gather_rows
from repro_torch.obs import trace as _trace


def _traced(name):
    """Wrap a cache method in an obs span (track ``cache``).  Engine
    submissions made inside the method parent to this span via the
    tracer's thread-local stack, so ticket/service spans stitch back to
    the cache phase that issued them.  Disabled cost: one global load,
    one flag check, one extra frame."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *a, **kw):
            tr = _trace.TRACER
            if tr is None or not tr.enabled:
                return fn(self, *a, **kw)
            with tr.span(name, track="cache", cat="cache"):
                return fn(self, *a, **kw)
        return wrapper
    return deco


@dataclass
class CacheStats:
    device_hits: int = 0
    host_hits: int = 0
    storage_misses: int = 0
    remote_hits: int = 0                # rows resolved from a peer's store
    virtual_device_s: float = 0.0
    virtual_host_s: float = 0.0
    virtual_storage_s: float = 0.0
    virtual_remote_s: float = 0.0
    wall_s: float = 0.0
    batches: int = 0
    # tier-migration accounting (refresh())
    refreshes: int = 0
    promotions: int = 0                 # rows moved to a faster tier
    demotions: int = 0                  # rows moved to a slower tier
    migrated_bytes: int = 0
    virtual_migrate_s: float = 0.0
    # policy-driven prefetch accounting (maybe_prefetch())
    prefetches: int = 0
    prefetched_rows: int = 0
    virtual_prefetch_s: float = 0.0
    # write-path accounting (write_planned()/flush())
    writes: int = 0                     # write_planned calls
    written_rows: int = 0               # unique rows updated
    write_through_rows: int = 0         # rows written straight to storage
    flushes: int = 0                    # explicit flush() barriers
    flushed_rows: int = 0               # dirty rows written back (incl. demote)
    virtual_write_s: float = 0.0        # write-through ticket time
    virtual_flush_s: float = 0.0        # flush + flush-on-demote ticket time
    # graceful degradation: prefetch rows suppressed because their shard
    # is marked degraded by the engine (demand gathers still serve them)
    degraded_skipped_rows: int = 0
    # congestion back-pressure: prefetch rows deferred because the engine's
    # demand-qwait watermark engaged (engine.throttled(PREFETCH) — see
    # docs/streams.md); the rows stay candidates for the next window
    throttled_skipped_rows: int = 0
    # locks the owning cache assigns (outer-to-inner order) so snapshot()
    # never reads a refresh()/complete_write mid-update
    _snap_locks: tuple = field(default=(), repr=False, compare=False)

    @property
    def hit_rate(self):
        total = (self.device_hits + self.host_hits + self.storage_misses
                 + self.remote_hits)
        return (self.device_hits + self.host_hits) / total if total else 0.0

    def virtual_batch_time(self, pipelined: bool) -> float:
        """Per-call data-path time: tiers overlap when pipelined."""
        ts = (self.virtual_device_s, self.virtual_host_s,
              self.virtual_storage_s, self.virtual_remote_s)
        return max(ts) if pipelined else sum(ts)

    def _values(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if not f.name.startswith("_")}

    def snapshot(self) -> "CacheStats":
        """Atomic point-in-time copy, taken under the owning cache's
        refresh + stats locks so a concurrent ``refresh()`` /
        ``complete_write`` is either fully in or fully out."""
        for lk in self._snap_locks:
            lk.acquire()
        try:
            return CacheStats(**self._values())
        finally:
            for lk in reversed(self._snap_locks):
                lk.release()

    # ``cache.stats`` stays a live attribute (every existing call site
    # reads fields off it directly); ``cache.stats()`` is the atomic
    # snapshot the observability layer and benches use
    __call__ = snapshot

    def delta(self, since: "CacheStats") -> "CacheStats":
        """Field-wise ``self - since`` over a fresh snapshot."""
        cur = self.snapshot()._values()
        base = since._values()
        return CacheStats(**{k: v - base[k] for k, v in cur.items()})

    def publish(self, prefix: str = "cache", registry=None) -> None:
        """Publish counters (plus hit rate) into the obs metrics registry
        as gauges, without changing the public fields."""
        from repro_torch.obs.metrics import REGISTRY
        reg = registry if registry is not None else REGISTRY
        snap = self.snapshot()
        for k, v in snap._values().items():
            reg.gauge(f"{prefix}.{k}").set(v)
        reg.gauge(f"{prefix}.hit_rate").set(snap.hit_rate)


@dataclass
class RefreshResult:
    """One ``refresh()``: how much moved and what it costs in virtual time.

    ``virtual_s`` is the TOTAL operator cost (migration + flush-on-demote)
    — what the pipeline charges; ``flush_virtual_s`` is the flush share,
    which the stats book under ``virtual_flush_s`` (not
    ``virtual_migrate_s``) so the per-category counters stay disjoint."""
    promotions: int = 0
    demotions: int = 0
    device_in: int = 0                  # rows newly resident in HBM
    host_in: int = 0                    # rows newly resident in DRAM
    moved_bytes: int = 0
    virtual_s: float = 0.0
    flushed: int = 0                    # dirty rows written back pre-demotion
    flush_virtual_s: float = 0.0        # share of virtual_s spent flushing


@dataclass
class PrefetchResult:
    """One ``maybe_prefetch()``: predicted-hot rows pulled ahead of use."""
    rows: int = 0
    tier: str = ""                      # "host" | "device"
    virtual_s: float = 0.0


class PendingPrefetch:
    """In-flight split-phase prefetch: the admission ticket is issued but
    the tier swap has not landed.  Lets the trainer keep one prefetch
    ticket in flight ACROSS batches (double-buffered cadence) instead of
    blocking inside the operator.  ``complete_prefetch`` revalidates
    against the live tables — a refresh landing mid-flight invalidates the
    stale admissions rather than corrupting the tiers."""

    __slots__ = ("ids", "tier", "victims", "victim_ids", "buf", "ticket",
                 "versions")

    def __init__(self, ids, tier, victims, victim_ids, buf, ticket,
                 versions=None):
        self.ids = ids
        self.tier = tier
        self.victims = victims          # slot indices in the target tier
        self.victim_ids = victim_ids    # row ids those slots held at issue
        self.buf = buf
        self.ticket = ticket
        self.versions = versions        # write versions of ids at issue


class PendingWrite:
    """In-flight split-phase write: the tier updates landed at submit time
    (gathers already observe the new values), only the storage
    write-through ticket is still in flight.  ``complete_write`` harvests
    the ticket and finalizes the accounting; until then the cache keeps
    the handle registered so a ``flush()`` barrier can complete it before
    declaring storage durable."""

    __slots__ = ("result", "ticket", "done", "_lk")

    def __init__(self, result, ticket):
        self.result = result            # WriteResult (virtual_s grows at
        self.ticket = ticket            # completion); ticket may be None
        self.done = ticket is None
        self._lk = threading.Lock()


class PendingFlush:
    """In-flight flush/flush-on-demote ticket: the written values were
    snapshotted into the ticket at submit, so the tier copies may drop
    immediately; completion clears dirty bits ONLY for rows whose version
    still matches the submit-time snapshot (a row re-written mid-flight
    is dirty again with a newer value and must stay dirty)."""

    __slots__ = ("ids", "versions", "ticket", "virt", "done", "_lk")

    def __init__(self, ids, versions, ticket):
        self.ids = ids
        self.versions = versions
        self.ticket = ticket
        self.virt = 0.0
        self.done = False
        self._lk = threading.Lock()


class PendingEpochFlush:
    """In-flight epoch/checkpoint barrier: the combined dirty-row ticket
    was submitted (phase 1); ``flush_complete`` waits it — plus every
    other split-phase write still in flight — and then msyncs the shard
    memmaps (phase 2).  Lets the trainer overlap the barrier write with
    the next batches instead of stalling the epoch boundary."""

    __slots__ = ("pf", "rows", "bytes")

    def __init__(self, pf, rows, nbytes):
        self.pf = pf                    # PendingFlush | None (nothing dirty)
        self.rows = rows
        self.bytes = nbytes


class PendingGather:
    """In-flight split-phase gather: tier plan + table/tier snapshot.

    The snapshot pins the translation tables and tier arrays this gather
    planned against; ``refresh()`` swaps fresh arrays in, so the pending
    gather stays internally consistent no matter when migration lands.
    """

    __slots__ = ("ids", "plan", "out", "ticket", "rticket", "device_tier",
                 "host_tier", "t0", "done", "storage_virt", "remote_virt",
                 "wc_patch", "occ", "dup_fill", "stage", "stage_dest",
                 "_looked", "_dev_rows", "_lk")

    def __init__(self, ids, plan, out, ticket, device_tier, host_tier,
                 wc_patch=None, rticket=None, occ=None, dup_fill=None,
                 stage=None, stage_dest=None):
        self.ids = ids
        self.plan = plan
        self.out = out                  # (n_out, D) tensor, cache's device
        # host staging buffer the engines land storage + remote misses in
        # (rows 0..n-1), and the output rows they belong at
        self.stage = stage
        self.stage_dest = stage_dest
        self.ticket = ticket
        self.rticket = rticket          # remote-tier ticket (peer gather)
        self.device_tier = device_tier
        self.host_tier = host_tier
        self.wc_patch = wc_patch        # (dests, rows) write-combiner overlay
        # fused-path extras: ``occ`` keeps OCCURRENCE tier counts (the plan
        # legs carry deduplicated IO lists, so stats stay comparable with
        # the host path), ``dup_fill`` = (dup_dest, first_dest) replicates
        # IO-landed rows into duplicate positions at completion
        self.occ = occ
        self.dup_fill = dup_fill
        self.t0 = time.perf_counter()
        self.done = False
        self.storage_virt = 0.0         # virtual s the ticket resolved with
        self.remote_virt = 0.0          # virtual s the remote leg resolved with
        self._looked = False
        self._dev_rows = None
        self._lk = threading.Lock()

    @property
    def n_device(self) -> int:
        return self.occ[0] if self.occ is not None else len(self.plan[0][0])

    @property
    def n_host(self) -> int:
        return self.occ[1] if self.occ is not None else len(self.plan[1][0])

    @property
    def n_storage(self) -> int:
        return self.occ[2] if self.occ is not None else len(self.plan[2][0])

    @property
    def n_remote(self) -> int:
        return self.occ[3] if self.occ is not None else len(self.plan[3][0])

    @property
    def io_virt(self) -> float:
        """Operator cost of the miss path: the storage and remote legs run
        on parallel engine queues, so the pipeline charges the slower."""
        return max(self.storage_virt, self.remote_virt)


def tier_rows(mode: str, n_vertices: int, device_frac: float,
              host_frac: float) -> tuple:
    """Per-mode cache tier sizing (shared by trainer and server):
    GIDS keeps a device-only BaM cache, CPU-managed systems a host-only
    staging buffer, ``helios-nocache`` ablates both."""
    dev_rows = int(n_vertices * device_frac)
    host_rows = int(n_vertices * host_frac)
    if mode == "helios-nocache":
        dev_rows = host_rows = 0
    if mode == "gids":
        host_rows = 0
    if mode == "cpu":
        dev_rows = 0
    return dev_rows, host_rows


class HeteroCache:
    """Policy-placed 3-tier feature cache with asynchronous tier migration
    and (over a writable store) write-back mutable tiers: ``write_planned``
    updates resident rows in place and marks them dirty, dirty rows flush
    to storage on demotion or at a ``flush()`` barrier, and placement sees
    dirtiness so demoting a row that costs a write needs a hotter
    challenger."""

    def __init__(self, store: FeatureStore, hotness: np.ndarray | None = None,
                 device_rows: int = 0, host_rows: int = 0,
                 io_engine: AsyncIOEngine | None = None,
                 env: HardwareEnvelope = DEFAULT_ENVELOPE,
                 policy: CachePolicy | None = None,
                 write_policy: str = "writeback",
                 write_combine_rows: int = 0,
                 remote_mask: np.ndarray | None = None,
                 fused: bool = True,
                 fused_backend: str = "kernel",
                 journal: bool = True,
                 device="cuda"):
        # resolved first: asking for a card where there is none raises
        # before any engine thread starts
        self.device = resolve_device(device)
        if write_policy not in ("writeback", "writethrough"):
            raise ValueError(f"unknown write_policy {write_policy!r} "
                             "(expected writeback | writethrough)")
        # fused lookup: plan + dedup + tier split in ONE pass, with
        # deduplicated storage/remote miss lists fed to the IO engine (the
        # paper's GPU-initiated IO).  ``fused=False`` keeps the host
        # plan() as an ablation.  Backends: "kernel" (default: the K1
        # kernel on a card, its plain version on the CPU) and "host"
        # (vectorized numpy, the reference package's default, which runs
        # no kernel for the lookup).
        backend = fused_backend
        if backend not in ("kernel", "host"):
            raise ValueError(f"unknown fused_backend {backend!r}")
        self.fused = fused
        self._fused_backend = backend
        self._fi_tls = threading.local()    # per-thread first-occurrence scratch
        self.store = store
        self.env = env
        self.write_policy = write_policy
        # mutable tiers need somewhere to flush to: dirty tracking only
        # exists over a writable store (read-only stores keep the PR-3
        # behavior exactly — eviction stays free)
        self.mut = MutableTierTable(store.n_rows) if store.writable else None
        # write-combining buffer: flush-on-demote batches smaller than
        # ``write_combine_rows`` accumulate here (one combined ticket
        # later) instead of paying a tiny storage ticket each; 0 disables
        self._wc = (WriteCombiner(write_combine_rows)
                    if write_combine_rows and self.mut is not None else None)
        # orders gather submission against combiner release: a gather
        # holds it across [overlay lookup -> storage submit] and the
        # flusher across [take -> submit_write], so a combined row either
        # overlays the gather or its write is queued before the gather's
        # read (per-shard FIFO finishes the argument) — without this, a
        # read slipping into the take->submit window would return stale
        # storage bytes with no overlay
        self._wc_io_lock = threading.Lock()
        # split-phase writes/flushes still in flight: the flush() barrier
        # completes these before it may declare storage durable
        self._inflight: list = []
        self._wr_lock = threading.Lock()
        # crash-consistent flush: a write-intent journal brackets every
        # flush barrier; a pending entry found here means the previous
        # process died mid-flush, so replay it BEFORE any tier loads read
        # (possibly torn) storage below
        self._journal = (FlushJournal(store.path)
                         if journal and store.writable
                         and hasattr(store, "path") else None)
        self.journal_recovery = {"action": "none"}
        if self._journal is not None:
            self.journal_recovery = self._journal.recover(store)
        self._owns_engine = io_engine is None
        self.io = io_engine or AsyncIOEngine(store, env=env)
        # fourth tier: rows whose un-cached home is a PEER's store (loc 3).
        # Derived from the engine's partition map when the cache sits on a
        # RemoteIOEngine (rows this worker doesn't own are remote), or
        # passed explicitly; single-node caches have no remote rows and
        # keep the 3-tier behavior bit-for-bit.
        if remote_mask is None and hasattr(self.io, "me") \
                and hasattr(store, "owner"):
            remote_mask = np.asarray(store.owner) != self.io.me
        self._base_loc = np.full(store.n_rows, 2, np.int8)
        if remote_mask is not None:
            remote_mask = np.asarray(remote_mask, bool)
            if len(remote_mask) != store.n_rows:
                raise ValueError("remote_mask length != store.n_rows")
            self._base_loc[remote_mask] = 3
        if policy is None:
            policy = StaticPresamplePolicy(
                np.zeros(store.n_rows) if hotness is None else hotness)
        self.policy = policy
        self.device_rows = min(device_rows, store.n_rows)
        self.host_rows = min(host_rows, store.n_rows - self.device_rows)
        scores = np.asarray(policy.initial_scores() if hotness is None
                            else hotness)
        if len(scores) != store.n_rows:
            raise ValueError("hotness length != store.n_rows")
        order = np.argsort(-scores, kind="stable")
        self._dev_ids = order[:self.device_rows]
        self._host_ids = order[self.device_rows:
                               self.device_rows + self.host_rows]
        self.loc, self.slot = tables_from_sets(store.n_rows, self._dev_ids,
                                               self._host_ids,
                                               base_loc=self._base_loc)
        # device tier: tensor on the device (HBM); host tier: CPU tensor,
        # pinned when the device is a card (the K1 kernel reads it in place)
        self._pinned = self.device.type == "cuda"
        self.device_tier = self._to_device(
            store.read_rows(self._dev_ids) if len(self._dev_ids)
            else np.zeros((0, store.row_dim), store.dtype))
        self.host_tier = self._to_host(
            store.read_rows(self._host_ids) if len(self._host_ids)
            else np.zeros((0, store.row_dim), store.dtype))
        self.stats = CacheStats()
        self._table_lock = threading.Lock()     # table/tier swap + snapshot
        # int32 copies of loc/slot on the device for the K1 kernel, swapped
        # together with the host tables (only when they change)
        self._loc_dev = self._slot_dev = None
        self._set_tables(self.loc, self.slot)
        self._stats_lock = threading.Lock()     # one accounting site, many threads
        # reentrant: maybe_refresh() holds it across due-check + refresh()
        self._refresh_lock = threading.RLock()
        # snapshot order matches refresh()'s own acquire order (refresh
        # outer, stats inner) so stats() can never deadlock against it
        self.stats._snap_locks = (self._refresh_lock, self._stats_lock)

    # ------------------------------------------------------------------
    # tensor plumbing between numpy (tables, engines) and the tiers
    # ------------------------------------------------------------------
    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)

    def _to_host(self, rows: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(rows))
        return t.pin_memory() if self._pinned else t

    def _host_copy(self, tier: torch.Tensor) -> torch.Tensor:
        """Copy-on-write twin of the host tier (pinned like the original):
        in-flight gathers keep the old tensor."""
        return self._to_host(tier.numpy().copy())

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)

    def _device_rows(self, tier: torch.Tensor, slots: np.ndarray) -> np.ndarray:
        """Device-tier rows ``tier[slots]`` as host numpy, through K2."""
        return gather_rows(tier, self._index(slots)).cpu().numpy()

    def _device_set(self, slots: np.ndarray, rows: np.ndarray) -> torch.Tensor:
        """Copy-on-write device-tier update: a NEW tensor with ``rows`` at
        ``slots`` (the functional ``.at[].set`` of the reference)."""
        tier = self.device_tier.clone()
        tier[self._index(slots)] = self._to_device(
            np.asarray(rows, self.store.dtype))
        return tier

    def _set_tables(self, loc: np.ndarray, slot: np.ndarray) -> None:
        """Swap the translation tables (caller holds ``_table_lock``, or
        is the constructor) and their int32 device copies for K1."""
        self.loc, self.slot = loc, slot
        if self.fused and self._fused_backend == "kernel":
            self._loc_dev = torch.from_numpy(
                loc.astype(np.int32)).to(self.device)
            self._slot_dev = torch.from_numpy(
                slot.astype(np.int32)).to(self.device)

    # ------------------------------------------------------------------
    # split-phase gather: the ONE tier-plan/gather/stats code path
    # ------------------------------------------------------------------
    def plan(self, ids: np.ndarray, loc=None, slot=None):
        """Split a request batch by tier ->
        (dev, host, disk, remote) x (slot, dest)."""
        loc = self.loc if loc is None else loc
        slot = self.slot if slot is None else slot
        where = loc[ids]
        slots = slot[ids]
        dest = np.arange(len(ids))
        d = where == 0
        h = where == 1
        m = where == 2
        r = where == 3
        return ((slots[d], dest[d]), (slots[h], dest[h]),
                (ids[m], dest[m]), (ids[r], dest[r]))

    def _first_indices(self, ids: np.ndarray) -> np.ndarray:
        """First-occurrence index of every id within the batch, O(B) with a
        persistent per-thread scratch (no sort, the host analogue of the
        kernel's VPU compare).  Fancy assignment with duplicate indices
        keeps the LAST write, so scattering reversed positions leaves the
        smallest position per id."""
        scr = getattr(self._fi_tls, "scr", None)
        if scr is None:
            scr = self._fi_tls.scr = np.full(self.store.n_rows, -1, np.int64)
        pos = np.arange(len(ids))
        scr[ids[::-1]] = pos[::-1]
        fi = scr[ids]
        scr[ids] = -1                   # restore sentinel for the next batch
        return fi

    def _fused_plan_host(self, ids, loc, slot):
        """Fused plan, host backend: ONE vectorized pass does the tier
        lookup, duplicate collapse, and per-tier split; the storage/remote
        legs carry only FIRST occurrences (the deduplicated miss list the
        IO engines see)."""
        where = loc[ids]
        slots = slot[ids]
        dest = np.arange(len(ids))
        fi = self._first_indices(ids)
        is_first = fi == dest
        d = where == 0
        h = where == 1
        m = where == 2
        r = where == 3
        mf = m & is_first
        rf = r & is_first
        dup = ~is_first & (where >= 2)
        plan = ((slots[d], dest[d]), (slots[h], dest[h]),
                (ids[mf], dest[mf]), (ids[rf], dest[rf]))
        occ = (int(d.sum()), int(h.sum()), int(m.sum()), int(r.sum()))
        dup_fill = (dest[dup], fi[dup]) if dup.any() else None
        return plan, occ, dup_fill

    def _fused_plan_kernel(self, ids, loc, loc_dev, slot_dev, device_tier,
                           host_tier, out):
        """Fused plan, kernel backend: the whole phase — lookup, dedup,
        device+host tier gather straight into ``out``, and compacted
        miss-list emission — is one K1 call (see kernels/cache_lookup/).
        Its outputs come back to the host in ONE copy (the engines submit
        from the host); that is the gather's one device sync."""
        B = len(ids)
        ids_dev = torch.from_numpy(
            np.ascontiguousarray(ids, np.int32)).to(self.device)
        _, fi, mid, mdst, rid, rdst, cnt = fused_cache_lookup(
            ids_dev, loc_dev, slot_dev, device_tier, host_tier, out=out)
        host = torch.cat([cnt, fi, mid, mdst, rid, rdst]).cpu().numpy()
        nm, nr = int(host[0]), int(host[1])
        fi, mid, mdst, rid, rdst = (host[2 + k * B:2 + (k + 1) * B]
                                    .astype(np.int64) for k in range(5))
        where = loc[ids]
        dest = np.arange(B)
        dup = (fi != dest) & (where >= 2)
        empty = np.empty(0, np.int64)
        plan = ((empty, empty), (empty, empty),
                (mid[:nm], mdst[:nm]), (rid[:nr], rdst[:nr]))
        occ = (int((where == 0).sum()), int((where == 1).sum()),
               int((where == 2).sum()), int((where == 3).sum()))
        dup_fill = (dest[dup], fi[dup]) if dup.any() else None
        return plan, occ, dup_fill

    @_traced("cache.gather.submit")
    def submit_planned(self, ids: np.ndarray,
                       n_rows: int | None = None) -> PendingGather:
        """Phase 1: snapshot tables, split by tier (fused lookup by
        default: dedup collapses duplicate ids so the miss list the IO
        engine sees carries each row once), and fire the storage
        submission (longest latency first — paper ordering).  ``n_rows``
        pads the output buffer (trainer batches are shape-padded)."""
        with self._table_lock:
            loc, slot = self.loc, self.slot
            device_tier, host_tier = self.device_tier, self.host_tier
            loc_dev, slot_dev = self._loc_dev, self._slot_dev
        D = self.store.row_dim
        n_out = len(ids) if n_rows is None else n_rows
        dup_fill = occ = None
        kernel = (self.fused and len(ids) > 0
                  and self._fused_backend == "kernel")
        if kernel:
            # K1 writes every row of out[:len(ids)]; only padding is zeroed
            out = torch.empty((n_out, D), dtype=device_tier.dtype,
                              device=self.device)
            out[len(ids):].zero_()
            plan, occ, dup_fill = self._fused_plan_kernel(
                ids, loc, loc_dev, slot_dev, device_tier, host_tier,
                out[:len(ids)])
        else:
            out = torch.zeros((n_out, D), dtype=device_tier.dtype,
                              device=self.device)
            if not self.fused or len(ids) == 0:
                plan = self.plan(ids, loc, slot)
            else:
                plan, occ, dup_fill = self._fused_plan_host(ids, loc, slot)
        sids, sdest = plan[2]
        rids, rdest = plan[3]
        # storage rows land in stage[:len(sids)], remote rows after them;
        # complete_planned moves the stage to the device in one copy
        stage = stage_dest = None
        if len(sids) or len(rids):
            stage = self._to_host(np.empty((len(sids) + len(rids), D),
                                           self.store.dtype))
            stage_dest = np.concatenate([sdest, rdest])
        stage_np = stage.numpy() if stage is not None else None
        s_at = np.arange(len(sids))
        r_at = np.arange(len(sids), len(sids) + len(rids))
        # write-combiner overlay, captured at SUBMIT time: a buffered row
        # is fresher than storage.  The lookup and the storage submit sit
        # under ONE lock shared with the combiner's take->submit_write, so
        # either the entry is still buffered (overlay patches it) or the
        # combined write was queued before this read on its shard and
        # per-shard FIFO makes the read observe it.  The remote leg goes
        # out FIRST — it has the longest latency (paper's overlap order),
        # and its rows share the overlay (a combined row is fresher than
        # the owner's store too)
        wc_patch = None
        rticket = ticket = None
        if self._wc is not None and (len(sids) or len(rids)):
            with self._wc_io_lock:
                if len(self._wc):
                    mids = np.concatenate([rids, sids])
                    mdest = np.concatenate([rdest, sdest])
                    hit = self._wc.lookup(mids)
                    if hit is not None:
                        mask, rows = hit
                        wc_patch = (mdest[mask], rows)
                if len(rids):
                    rticket = self.io.submit(rids, stage_np, r_at,
                                             tag="remote")
                if len(sids):
                    ticket = self.io.submit(sids, stage_np, s_at)
        else:
            if len(rids):
                rticket = self.io.submit(rids, stage_np, r_at, tag="remote")
            if len(sids):
                ticket = self.io.submit(sids, stage_np, s_at)
        pg = PendingGather(ids, plan, out, ticket, device_tier, host_tier,
                           wc_patch, rticket=rticket, occ=occ,
                           dup_fill=dup_fill, stage=stage,
                           stage_dest=stage_dest)
        if kernel:
            # the kernel already gathered the device+host tiers into the
            # output buffer — phase 2 has nothing left to do
            pg._looked = True
        return pg

    @_traced("cache.gather.lookup")
    def lookup_planned(self, pg: PendingGather) -> None:
        """Phase 2: host-tier gather into the buffer + device-tier gather
        issue (K2 on the device tier).  Idempotent."""
        with pg._lk:
            if pg._looked:
                return
            (dslot, _), (hslot, hdest) = pg.plan[0], pg.plan[1]
            if len(hslot):
                pg.out[self._index(hdest)] = self._to_device(
                    pg.host_tier.numpy()[hslot])
            if len(dslot):
                pg._dev_rows = gather_rows(pg.device_tier,
                                           self._index(dslot))
            pg._looked = True

    @_traced("cache.gather.complete")
    def complete_planned(self, pg: PendingGather) -> torch.Tensor:
        """Phase 3: wait out the storage ticket, land the staged misses
        and the device rows, account stats ONCE, and feed the access
        stream to the policy.  Returns the rows as a tensor on the cache's
        device."""
        self.lookup_planned(pg)
        virt_sto = virt_rem = 0.0
        if pg.rticket is not None:
            _, virt_rem = pg.rticket.wait()
        if pg.ticket is not None:
            _, virt_sto = pg.ticket.wait()
        with pg._lk:
            if pg.done:
                return pg.out
            if pg.stage is not None:
                # one host-to-device copy of every landed miss, then one
                # index copy to the rows they belong at
                pg.out[self._index(pg.stage_dest)] = pg.stage.to(
                    self.device, non_blocking=True)
            if pg._dev_rows is not None:
                pg.out[self._index(pg.plan[0][1])] = pg._dev_rows
            if pg.wc_patch is not None:
                # buffered write-combiner values override the (stale)
                # storage rows the ticket just landed
                dests, rows = pg.wc_patch
                pg.out[self._index(dests)] = self._to_device(rows)
            if pg.dup_fill is not None:
                # fused dedup issued each missed row once; replicate the
                # landed (and overlay-patched) row into duplicate slots
                dd, ds = pg.dup_fill
                pg.out[self._index(dd)] = gather_rows(pg.out,
                                                      self._index(ds))
            pg.storage_virt = virt_sto
            pg.remote_virt = virt_rem
            pg.done = True

        rb = self.store.row_bytes
        n_dev, n_host = pg.n_device, pg.n_host
        n_sto, n_rem = pg.n_storage, pg.n_remote
        with self._stats_lock:
            st = self.stats
            st.device_hits += n_dev
            st.host_hits += n_host
            st.storage_misses += n_sto
            st.remote_hits += n_rem
            st.virtual_device_s += hbm_gather_time(n_dev * rb, self.env)
            st.virtual_host_s += (dram_gather_time(n_host * rb, self.env)
                                  + pcie_time(n_host * rb, self.env))
            # the virtual seconds the tickets actually resolved with — NOT
            # a recompute of ArrayModel.read_time at full queue depth — so
            # cache stats agree with engine stats in every mode: the async
            # engine's striped/coalesced time, the sync engine's collapsed
            # queue depth, and the CPU engine's staging overhead all land
            # here unchanged; the remote leg books its own tier
            st.virtual_storage_s += virt_sto
            st.virtual_remote_s += virt_rem
            st.wall_s += time.perf_counter() - pg.t0
            st.batches += 1
        self.policy.record(pg.ids)
        return pg.out

    def gather(self, ids: np.ndarray) -> np.ndarray:
        """Fetch feature rows for ``ids`` through the hierarchy (fused
        split-phase gather)."""
        return self.complete_planned(self.submit_planned(ids))

    # ------------------------------------------------------------------
    # write path: mutable tiers, write-back dirty tracking, flush barrier
    # ------------------------------------------------------------------
    @_traced("cache.write")
    def write_planned(self, ids: np.ndarray, rows: np.ndarray,
                      wait: bool = True):
        """Update feature rows through the tier hierarchy (SPLIT-PHASE).

        Resident rows are updated IN PLACE in their tier (host DRAM scatter;
        device HBM functional update swapped atomically) and, under the
        default ``writeback`` policy, marked dirty — storage is deferred to
        flush-on-demote or an explicit ``flush()``.  Storage-resident rows
        always write through (``submit_write``), so a gather after a write
        returns the new value no matter where the row lives
        (read-your-writes; the engine's per-shard FIFO makes this hold even
        while the write ticket is still in flight).  The ``writethrough``
        ablation also pushes every cached write to storage immediately.
        Duplicate ids resolve last-writer-wins in batch order.

        With ``wait=False`` the storage ticket stays IN FLIGHT and a
        ``PendingWrite`` is returned — complete it with ``complete_write``
        (or let the next ``flush()`` barrier do it), so storage writes hide
        under device compute instead of blocking the caller.
        """
        if self.mut is None:
            raise PermissionError("write_planned needs a writable "
                                  "FeatureStore (writable=True)")
        ids = np.asarray(ids)
        rows = np.asarray(rows, self.store.dtype)
        if rows.shape != (len(ids), self.store.row_dim):
            raise ValueError(f"rows shape {rows.shape} != "
                             f"({len(ids)}, {self.store.row_dim})")
        ids, rows = keep_last_writer(ids, rows)
        res = WriteResult(rows=len(ids))
        if not len(ids):
            return res if wait else PendingWrite(res, None)
        with self._refresh_lock:
            lc = self.loc[ids]
            # m = un-cached rows: local storage (2) AND remote-owned (3).
            # Remote rows write through the engine, which stripes by owner
            # — owner-writes: the one durable copy lives at the owner
            d, h, m = lc == 0, lc == 1, lc >= 2
            if h.any():
                # copy-on-write, same snapshot discipline as refresh(): an
                # in-flight gather pinned the OLD array, so scattering into
                # it in place could hand that gather a torn row (half
                # pre-write, half post-write) — build aside, swap atomically
                host_tier = self._host_copy(self.host_tier)
                host_tier.numpy()[self.slot[ids[h]]] = rows[h]
                with self._table_lock:
                    self.host_tier = host_tier
            if d.any():
                device_tier = self._device_set(self.slot[ids[d]], rows[d])
                with self._table_lock:
                    self.device_tier = device_tier
            res.device_rows, res.host_rows = int(d.sum()), int(h.sum())
            through = (m if self.write_policy == "writeback"
                       else np.ones(len(ids), bool))
            ticket = None
            if through.any():
                ticket = self.io.submit_write(ids[through], rows[through],
                                              tag="write")
                res.through_rows = int(through.sum())
            if self.write_policy == "writeback":
                self.mut.mark_dirty(ids[~m])
                self.mut.bump_version(ids[m])
                # the through ticket is the LAST write on its shards'
                # queues, so once it lands storage IS current for those
                # rows: any write-combiner entry (and any dirty bit left
                # by a still-in-flight demotion flush) is superseded
                self.mut.clear_dirty(ids[m])
            else:
                self.mut.bump_version(ids)
            if self._wc is not None and through.any():
                self._wc.drop(ids[through])
            with self._stats_lock:
                st = self.stats
                st.writes += 1
                st.written_rows += len(ids)
                st.write_through_rows += res.through_rows
            pw = PendingWrite(res, ticket)
            if ticket is not None:
                with self._wr_lock:
                    self._inflight.append(pw)
        if wait:
            return self.complete_write(pw)
        return pw

    @_traced("cache.write.complete")
    def complete_write(self, pw: PendingWrite) -> WriteResult:
        """Harvest a split-phase write: wait out (or reap) the storage
        ticket and book its virtual seconds.  Idempotent; safe to call
        from a different pipeline batch than the one that submitted."""
        with pw._lk:
            if pw.done:
                return pw.result
            _, virt = pw.ticket.wait()
            pw.result.virtual_s += virt
            pw.done = True
        with self._wr_lock:
            if pw in self._inflight:
                self._inflight.remove(pw)
        with self._stats_lock:
            self.stats.virtual_write_s += virt
        return pw.result

    def apply_delta(self, ids: np.ndarray, delta: np.ndarray,
                    wait: bool = True):
        """Read-modify-write: add ``delta`` to the CURRENT value of each row
        and write the sum back through ``write_planned``.

        This is the right primitive for gradient updates under the deep
        pipeline: an absolute ``write_planned(ids, stale_gather - lr*g)``
        from a concurrent batch would silently revert another batch's
        update to a shared hot row (lost update), whereas deltas re-read
        the live value under the refresh lock so updates COMPOSE no matter
        how batches interleave.  Duplicate ids contribute their summed
        delta.  Storage-resident rows pay a real RMW read ticket before
        the write-through.  ``wait=False`` split-phases the write-back leg
        (returns a ``PendingWrite``); the RMW read itself must resolve
        before the sum can be formed, so only the write hides."""
        if self.mut is None:
            raise PermissionError("apply_delta needs a writable "
                                  "FeatureStore (writable=True)")
        ids = np.asarray(ids)
        delta = np.asarray(delta, self.store.dtype)
        if delta.shape != (len(ids), self.store.row_dim):
            raise ValueError(f"delta shape {delta.shape} != "
                             f"({len(ids)}, {self.store.row_dim})")
        if len(ids) == 0:
            return WriteResult() if wait else PendingWrite(WriteResult(), None)
        uniq, inv = np.unique(ids, return_inverse=True)
        summed = np.zeros((len(uniq), self.store.row_dim), self.store.dtype)
        np.add.at(summed, inv, delta)
        with self._refresh_lock:                # RLock: write_planned re-enters
            cur = np.empty((len(uniq), self.store.row_dim), self.store.dtype)
            lc, sl = self.loc[uniq], self.slot[uniq]
            h, d, m = lc == 1, lc == 0, lc >= 2
            if h.any():
                cur[h] = self.host_tier.numpy()[sl[h]]
            if d.any():
                cur[d] = self._device_rows(self.device_tier, sl[d])
            rmw_virt = 0.0
            if m.any():
                _, rmw_virt = self.io.submit(uniq[m], cur, m.nonzero()[0],
                                             tag="rmw").wait()
                if self._wc is not None and len(self._wc):
                    # write-combiner entries are fresher than the storage
                    # rows the RMW read just returned
                    hit = self._wc.lookup(uniq[m])
                    if hit is not None:
                        mask, rows = hit
                        cur[m.nonzero()[0][mask]] = rows
            out = self.write_planned(uniq, cur + summed, wait=wait)
            # the RMW read rides res.virtual_s so the pipeline charges it
            # to the writing operator; the engine already booked it on the
            # READ side (virtual_io_s), keeping cache write stats == engine
            # write stats exactly
            res = out if wait else out.result
            res.virtual_s += rmw_virt
            return out

    def _snapshot_inflight(self, cls=None) -> list:
        with self._wr_lock:
            return [p for p in self._inflight
                    if cls is None or isinstance(p, cls)]

    def _resident_values(self, ids: np.ndarray) -> np.ndarray:
        """CURRENT tier values of resident ``ids`` (caller holds the
        refresh lock; tables must still map the rows)."""
        rows = np.empty((len(ids), self.store.row_dim), self.store.dtype)
        lc, sl = self.loc[ids], self.slot[ids]
        h = lc == 1
        if h.any():
            rows[h] = self.host_tier.numpy()[sl[h]]
        d = lc == 0
        if d.any():
            rows[d] = self._device_rows(self.device_tier, sl[d])
        return rows

    def _write_back_submit(self, ids: np.ndarray, rows: np.ndarray,
                           tag: str) -> PendingFlush:
        """SUBMIT one batched write-back ticket for ``ids``/``rows``.  The
        values ride in the ticket (snapshotted), so the caller may drop
        the tier copies immediately; the version snapshot makes the
        completion-side dirty clear revalidate against mid-flight writes."""
        pf = PendingFlush(ids, self.mut.versions(ids),
                          self.io.submit_write(ids, rows, tag=tag))
        with self._wr_lock:
            self._inflight.append(pf)
        return pf

    def complete_write_back(self, pf: PendingFlush) -> float:
        """COMPLETE a flush/flush-on-demote ticket: wait it out, clear
        dirty bits for rows whose version still matches the submit-time
        snapshot (rows re-written mid-flight stay dirty — their newer
        value must survive to the next barrier), book stats.  Idempotent."""
        with pf._lk:
            if pf.done:
                return pf.virt
            _, virt = pf.ticket.wait()
            self.mut.clear_dirty_if_version(pf.ids, pf.versions)
            pf.virt = virt
            pf.done = True
        with self._wr_lock:
            if pf in self._inflight:
                self._inflight.remove(pf)
        with self._stats_lock:
            self.stats.flushed_rows += len(pf.ids)
            self.stats.virtual_flush_s += virt
        return virt

    def _flush_demoted(self, ids: np.ndarray) -> tuple:
        """Flush-on-demote, split-phase: of ``ids`` (rows about to lose
        their cached copy), write back the dirty ones.  Small batches are
        absorbed by the write-combining buffer (one coalesced ticket once
        ``write_combine_rows`` accumulate) instead of paying a tiny ticket
        each; larger batches submit their ticket immediately and only
        resolve inline when the engine already completed it (sync modes).
        Returns ``(n_flushed, inline_virt)`` — async tickets book their
        virtual seconds at completion, so ``inline_virt`` is 0 for them."""
        if self.mut is None or not len(ids):
            return 0, 0.0
        dirty = ids[self.mut.is_dirty(ids)]
        if not len(dirty):
            return 0, 0.0
        rows = self._resident_values(dirty)
        if self._wc is not None and len(dirty) < self._wc.min_rows:
            # the combiner becomes the freshest holder (rows stay dirty);
            # gathers overlay these values over stale storage reads
            self._wc.add(dirty, rows)
            virt = 0.0
            if self._wc.ready:
                with self._wc_io_lock:      # atomic take->submit vs gathers
                    wids, wrows = self._wc.take()
                    pf = self._write_back_submit(wids, wrows,
                                                 tag="flush-combine")
                if pf.ticket.poll():
                    virt = self.complete_write_back(pf)
            return len(dirty), virt
        pf = self._write_back_submit(dirty, rows, tag="flush-demote")
        if pf.ticket.poll():            # sync engines resolve at submit
            return len(dirty), self.complete_write_back(pf)
        return len(dirty), 0.0

    @_traced("cache.flush.submit")
    def flush_submit(self) -> "PendingEpochFlush | None":
        """Phase 1 of the epoch/checkpoint barrier: settle outstanding
        flush-on-demote tickets (their version-checked completion decides
        what is STILL dirty), then submit ONE batched ticket carrying
        every remaining dirty row — write-combiner contents at their
        buffered values, residents at their tier values.  Returns a handle
        for ``flush_complete``; None when the store is read-only."""
        if self.mut is None:
            return None
        with self._refresh_lock:
            for p in self._snapshot_inflight(PendingFlush):
                self.complete_write_back(p)
            with self._wc_io_lock:          # atomic take->submit vs gathers
                wc_ids = np.empty(0, np.int64)
                wc_rows = None
                if self._wc is not None:
                    wc_ids, wc_rows = self._wc.take()
                dirty = self.mut.dirty_ids()
                resident = dirty[self.loc[dirty] < 2]
                ids = np.concatenate([wc_ids, resident])
                pf = None
                if len(ids):
                    rows = np.empty((len(ids), self.store.row_dim),
                                    self.store.dtype)
                    if len(wc_ids):
                        rows[:len(wc_ids)] = wc_rows
                    if len(resident):
                        rows[len(wc_ids):] = self._resident_values(resident)
                    if self._journal is not None:
                        # durable write intent BEFORE the first shard
                        # write can tear: a crash anywhere in the
                        # submit->msync window replays this barrier on
                        # the next open
                        self._journal.record(ids, rows)
                    pf = self._write_back_submit(ids, rows, tag="flush")
            return PendingEpochFlush(pf, len(ids),
                                     len(ids) * self.store.row_bytes)

    @_traced("cache.flush.complete")
    def flush_complete(self, ef: "PendingEpochFlush | None") -> FlushResult:
        """Phase 2 of the barrier: complete the barrier ticket AND every
        split-phase write still in flight, then push the shard memmaps to
        storage.  After this returns, storage alone reconstructs every
        value written before ``flush_submit``."""
        if self.mut is None or ef is None:
            return FlushResult()
        virt = self.complete_write_back(ef.pf) if ef.pf is not None else 0.0
        # in-flight write-through tickets landed in the memmaps the moment
        # their shards serviced them, but the durability barrier must WAIT
        # them out before msync — and late flush-on-demote tickets too
        for p in self._snapshot_inflight():
            if isinstance(p, PendingWrite):
                self.complete_write(p)
            else:
                self.complete_write_back(p)
        # the durability barrier runs even with nothing dirty:
        # write-through rows landed in the memmaps without an msync,
        # and the barrier is what makes THEM crash-safe too
        self.store.flush()
        if self._journal is not None:
            # every journalled row is durable: retire the write intent
            self._journal.commit()
        with self._stats_lock:
            self.stats.flushes += 1
        return FlushResult(ef.rows, ef.bytes, virt)

    def flush(self, wait: bool = True):
        """Epoch/checkpoint barrier (fused split-phase): write back EVERY
        dirty row through one batched ticket (the striped engine splits it
        per shard and coalesces dirty runs into sequential writes), then
        msync the shard memmaps.  ``wait=False`` returns the
        ``PendingEpochFlush`` with the barrier ticket in flight — complete
        it with ``flush_complete`` once the overlapped compute is done."""
        ef = self.flush_submit()
        if ef is None:
            return FlushResult()
        if wait:
            return self.flush_complete(ef)
        return ef

    @property
    def n_dirty(self) -> int:
        return self.mut.n_dirty if self.mut is not None else 0

    # ------------------------------------------------------------------
    # asynchronous tier migration
    # ------------------------------------------------------------------
    @_traced("cache.refresh")
    def refresh(self, scores: np.ndarray) -> RefreshResult:
        """Re-derive placement from ``scores`` and migrate the differences.

        Incoming rows are staged from their fastest current holder — host
        rows promoted to HBM copy over PCIe, everything else rides one
        batched ticket per tier through the async IO engine — then fresh
        translation tables and tier arrays are swapped in atomically.
        In-flight gathers keep their snapshot of the old arrays, so
        migration never tears a concurrent lookup.
        """
        if len(scores) != self.store.n_rows:
            raise ValueError("scores length != store.n_rows")
        with self._refresh_lock:
            order = np.argsort(-np.asarray(scores), kind="stable")
            new_dev = order[:self.device_rows]
            new_host = order[self.device_rows:
                             self.device_rows + self.host_rows]
            old_loc, old_slot = self.loc, self.slot
            cur_dev, cur_host = self._dev_ids, self._host_ids

            dev_keep = np.isin(cur_dev, new_dev, assume_unique=True)
            dev_free = np.where(~dev_keep)[0]
            dev_in = np.setdiff1d(new_dev, cur_dev, assume_unique=True)
            host_keep = np.isin(cur_host, new_host, assume_unique=True)
            host_free = np.where(~host_keep)[0]
            host_in = np.setdiff1d(new_host, cur_host, assume_unique=True)

            rb = self.store.row_bytes
            res = RefreshResult(device_in=len(dev_in), host_in=len(host_in))
            if len(dev_in) or len(host_in):
                # flush-on-demote: rows losing their LAST cached copy (not
                # merely changing tier) write their current value back
                # through one batched ticket BEFORE the swap drops it —
                # dirty data must never be evicted into oblivion
                flush_virt = 0.0
                if self.mut is not None:
                    out_ids = np.concatenate([cur_dev[~dev_keep],
                                              cur_host[~host_keep]])
                    if len(out_ids):
                        stay = np.isin(out_ids,
                                       np.concatenate([new_dev, new_host]))
                        res.flushed, flush_virt = \
                            self._flush_demoted(out_ids[~stay])
                        res.flush_virtual_s = flush_virt
                # admissions to HBM: promote from DRAM when resident there,
                # otherwise pull through the storage stack
                dev_buf = np.empty((len(dev_in), self.store.row_dim),
                                   self.store.dtype)
                from_host = old_loc[dev_in] == 1
                if from_host.any():
                    dev_buf[from_host] = \
                        self.host_tier.numpy()[old_slot[dev_in[from_host]]]
                miss = np.where(~from_host)[0]
                # admissions to DRAM: demotions copy back from HBM
                host_buf = np.empty((len(host_in), self.store.row_dim),
                                    self.store.dtype)
                from_dev = old_loc[host_in] == 0
                if from_dev.any():
                    host_buf[from_dev] = self._device_rows(
                        self.device_tier, old_slot[host_in[from_dev]])
                miss_h = np.where(~from_dev)[0]
                # every storage-tier admission — both destinations — rides
                # ONE ticket: the striped engine splits it by shard and
                # coalesces each shard's offsets into sequential ranges, so
                # migration IO rides those ranges even when adjacent rows
                # split between the device and host tiers (two tickets
                # would break the runs at the tier boundary)
                adm_ids = np.concatenate([dev_in[miss], host_in[miss_h]])
                virt_adm = 0.0
                if len(adm_ids):
                    adm_buf = np.empty((len(adm_ids), self.store.row_dim),
                                       self.store.dtype)
                    _, virt_adm = self.io.submit(adm_ids, adm_buf,
                                                 tag="refresh").wait()
                    if self._wc is not None and len(self._wc):
                        # write-combined rows: storage is stale, the
                        # buffered value is the row — the promoted tier
                        # copy becomes the freshest holder (still dirty),
                        # so the combiner entry is superseded
                        hit = self._wc.lookup(adm_ids)
                        if hit is not None:
                            wmask, wvals = hit
                            adm_buf[wmask] = wvals
                            self._wc.drop(adm_ids[wmask])
                    dev_buf[miss] = adm_buf[:len(miss)]
                    host_buf[miss_h] = adm_buf[len(miss):]

                # copy-on-refresh: build NEW tables/tiers, swap atomically
                new_dev_ids = cur_dev.copy()
                new_dev_ids[dev_free] = dev_in
                new_host_ids = cur_host.copy()
                new_host_ids[host_free] = host_in
                device_tier = self.device_tier
                if len(dev_in):
                    device_tier = self._device_set(dev_free, dev_buf)
                host_tier = self.host_tier
                if len(host_in):
                    host_tier = self._host_copy(host_tier)
                    host_tier.numpy()[host_free] = host_buf
                loc, slot = tables_from_sets(self.store.n_rows, new_dev_ids,
                                             new_host_ids,
                                             base_loc=self._base_loc)

                # tier-to-tier copies cross PCIe; storage admissions cost
                # what their ticket actually resolved with (ticket-resolved
                # time, same accounting rule as complete_planned)
                virt = pcie_time((int(from_host.sum())
                                  + int(from_dev.sum())) * rb, self.env)
                virt += virt_adm + flush_virt
                res.promotions = int((loc < old_loc).sum())
                res.demotions = int((loc > old_loc).sum())
                res.moved_bytes = (len(dev_in) + len(host_in)) * rb
                res.virtual_s = virt

                with self._table_lock:
                    self._set_tables(loc, slot)
                    self.device_tier, self.host_tier = device_tier, host_tier
                    self._dev_ids, self._host_ids = new_dev_ids, new_host_ids

            with self._stats_lock:
                st = self.stats
                st.refreshes += 1
                st.promotions += res.promotions
                st.demotions += res.demotions
                st.migrated_bytes += res.moved_bytes
                # flush-on-demote seconds already landed in virtual_flush_s
                # (inside _write_back) — book only the migration share here
                # so the per-category counters never double-count
                st.virtual_migrate_s += res.virtual_s - res.flush_virtual_s
            return res

    def maybe_refresh(self) -> RefreshResult | None:
        """Ask the policy whether placement should change; migrate if so.
        Scheduled as the ``cache_refresh`` pipeline operator (io resource)
        so migration hides under device compute.  The due-check is
        re-validated under the refresh lock: concurrent operators (deep
        pipeline, 2 io workers) must not both act on one due signal and
        double-migrate from stale scores."""
        pol = self.policy
        if pol is None or not pol.refresh_due():
            return None
        with self._refresh_lock:
            if not pol.refresh_due():       # another operator got here first
                return None
            dirty = self.mut.dirty_mask() if self.mut is not None else None
            scores = pol.placement_scores(self.loc, dirty=dirty)
            if scores is None:
                return None
            res = self.refresh(scores)
            pol.refreshed()
        return res

    # ------------------------------------------------------------------
    # policy-driven prefetch: hide the FIRST miss, not just steady state
    # ------------------------------------------------------------------
    @_traced("cache.prefetch.submit")
    def maybe_prefetch(self, k: int | None = None,
                       wait: bool = True):
        """Ask the policy for predicted-hot storage rows (rising score
        trend) and pull them into the cache BEFORE they are requested.
        ``refresh()`` fixes steady-state placement; prefetch hides the cold
        first miss the steady state can never see.  Scheduled as the
        ``prefetch`` pipeline operator on the io resource so the pull hides
        under device compute.  ``wait=False`` returns a ``PendingPrefetch``
        whose admission ticket is in flight — complete it later with
        ``complete_prefetch`` (double-buffered cadence: the trainer issues
        batch i+1's ticket before waiting on batch i's)."""
        fn = getattr(self.policy, "prefetch_candidates", None)
        if fn is None:
            return None
        if k is None:
            k = max(1, (self.host_rows or self.device_rows) // 8)
        with self._refresh_lock:
            cand = fn(self.loc, k)
            if cand is None or not len(cand):
                return None
            return self.prefetch_rows(cand, wait=wait)

    def prefetch_rows(self, ids: np.ndarray, wait: bool = True):
        """Admit ``ids`` (storage-resident, ranked hottest-first) into the
        fastest tier with capacity — host DRAM when present, else device —
        evicting the coldest current residents.  The admission read is one
        batched ticket, so the striped engine coalesces it into sequential
        per-shard ranges like refresh migration.  With ``wait=False`` the
        ticket is issued and a ``PendingPrefetch`` returned; the tier swap
        happens in ``complete_prefetch``."""
        with self._refresh_lock:
            ids = np.asarray(ids)
            ids = ids[self.loc[ids] >= 2]           # storage/remote-resident
            if self.mut is not None and len(ids):
                # demoted-dirty rows (write-combined or mid-flush) await a
                # write-back: a storage prefetch racing that write could
                # admit pre-write bytes, so they are not prefetchable
                ids = ids[~self.mut.is_dirty(ids)]
            deg = getattr(self.io, "degraded_shards", None)
            if deg is not None and len(ids):
                # graceful degradation: optional traffic (prefetch) to a
                # repeatedly-failing shard is suspended — demand gathers
                # keep serving it with retries, and the suppression is
                # stats-visible instead of raising
                d = deg()
                if len(d):
                    drop = np.isin(self.io.shard_of(ids), d)
                    if drop.any():
                        with self._stats_lock:
                            self.stats.degraded_skipped_rows += \
                                int(drop.sum())
                        ids = ids[~drop]
            thr = getattr(self.io, "throttled", None)
            if thr is not None and len(ids) and thr(StreamClass.PREFETCH):
                # congestion back-pressure: the engine's demand-qwait
                # watermark is engaged, so optional prefetch admission
                # defers entirely this window — demand and write-back
                # traffic keep the queues, and the skip is stats-visible
                # (rows stay candidates once the watermark releases)
                with self._stats_lock:
                    self.stats.throttled_skipped_rows += len(ids)
                return None
            _, first = np.unique(ids, return_index=True)
            ids = ids[np.sort(first)]               # dedupe, keep ranking
            tier = ("host" if self.host_rows
                    else ("device" if self.device_rows else None))
            if tier is None or not len(ids):
                return None
            cap = self.host_rows if tier == "host" else self.device_rows
            ids = ids[:min(len(ids), cap)]          # caller ranked by trend
            cur = self._host_ids if tier == "host" else self._dev_ids
            dirty = self.mut.dirty_mask() if self.mut is not None else None
            scores = self.policy.placement_scores(self.loc, dirty=dirty)
            if scores is None:
                victims = np.arange(len(cur) - len(ids), len(cur))
            else:
                # pair hottest candidates against coldest residents and
                # admit only where the newcomer OUTSCORES the incumbent
                # (refresh's admission criterion, applied early to the
                # trend-flagged rows; hysteresis boosts the residents) — a
                # marginally-rising cold row must never evict a genuinely
                # hot resident and manufacture future misses
                s = np.asarray(scores)
                ids = ids[np.argsort(-s[ids], kind="stable")]
                vict = np.argsort(s[cur], kind="stable")[:len(ids)]
                win = s[ids] > s[cur[vict]]
                ids, victims = ids[win], vict[win]
                if not len(ids):
                    return None
            buf = np.empty((len(ids), self.store.row_dim), self.store.dtype)
            pp = PendingPrefetch(ids, tier, victims, cur[victims].copy(), buf,
                                 self.io.submit(ids, buf, tag="prefetch"),
                                 versions=(self.mut.versions(ids)
                                           if self.mut is not None else None))
        if wait:
            return self.complete_prefetch(pp)
        return pp

    @_traced("cache.prefetch.complete")
    def complete_prefetch(self, pp: PendingPrefetch) -> PrefetchResult | None:
        """Land an in-flight prefetch: wait out the admission ticket, then
        swap the admitted rows in.  Admissions are revalidated against the
        live tables — rows a concurrent refresh already admitted, and
        victim slots whose resident changed mid-flight, are dropped rather
        than applied stale."""
        _, virt = pp.ticket.wait()
        with self._refresh_lock:
            cur = self._host_ids if pp.tier == "host" else self._dev_ids
            ok = (self.loc[pp.ids] >= 2) & (cur[pp.victims] == pp.victim_ids)
            if pp.versions is not None:
                # a write_planned that landed mid-flight (write-through on a
                # storage row bumps its version) makes the prefetched buffer
                # STALE — admitting it would shadow the newer value with
                # pre-write bytes (read-your-writes violation)
                ok &= self.mut.versions(pp.ids) == pp.versions
            ids, victims, buf = pp.ids[ok], pp.victims[ok], pp.buf[ok]
            k = len(ids)
            flush_virt = 0.0
            if k:
                # flush-on-demote: evicted victims may hold dirty values
                _, flush_virt = self._flush_demoted(cur[victims])
                # copy-on-prefetch, same snapshot discipline as refresh():
                # new tables/tier arrays built aside, swapped atomically.
                # O(k) table patch: admitted rows point at their new slots,
                # evicted victims fall back to their base tier (local
                # storage or remote peer) addressed by row id — no full
                # rebuild from the tier membership lists
                evicted = cur[victims]
                new_ids = cur.copy()
                new_ids[victims] = ids
                tier_code = 1 if pp.tier == "host" else 0
                loc, slot = patch_tables(
                    self.loc, self.slot,
                    np.concatenate([evicted, ids]),
                    np.concatenate([self._base_loc[evicted],
                                    np.full(k, tier_code, np.int8)]),
                    np.concatenate([evicted, victims]))
                if pp.tier == "host":
                    tier_arr = self._host_copy(self.host_tier)
                    tier_arr.numpy()[victims] = buf
                    with self._table_lock:
                        self._set_tables(loc, slot)
                        self.host_tier = tier_arr
                        self._host_ids = new_ids
                else:
                    tier_arr = self._device_set(victims, buf)
                    with self._table_lock:
                        self._set_tables(loc, slot)
                        self.device_tier = tier_arr
                        self._dev_ids = new_ids
            with self._stats_lock:
                st = self.stats
                st.prefetches += 1
                st.prefetched_rows += k
                # the flush share already landed in virtual_flush_s (inside
                # _write_back); book only the admission read here, but
                # return the TOTAL operator cost so the pipeline charges
                # the flush write to the prefetch operator that caused it
                st.virtual_prefetch_s += virt
            # rows=0 when every admission was invalidated mid-flight — the
            # ticket's IO seconds were still spent, so the result carries
            # them for the operator's virtual cost instead of returning
            # None and charging the pipeline nothing
            return PrefetchResult(k, pp.tier, virt + flush_virt)

    # ------------------------------------------------------------------
    # cross-replica coherence: refresh stale cached copies in place
    # ------------------------------------------------------------------
    @_traced("cache.invalidate")
    def invalidate_rows(self, ids: np.ndarray) -> tuple:
        """Refresh this cache's RESIDENT copies of ``ids`` from the backing
        store — another replica (the rows' owner) rewrote them, so any
        tier copy held here is stale.  Fresh values land through the same
        copy-on-write/atomic-swap discipline as writes; non-resident ids
        cost nothing (their next gather reads current storage anyway).
        Returns ``(rows_refreshed, virtual_s)`` of the re-read ticket."""
        with self._refresh_lock:
            ids = np.unique(np.asarray(ids))
            res = ids[self.loc[ids] < 2]
            if not len(res):
                return 0, 0.0
            buf = np.empty((len(res), self.store.row_dim), self.store.dtype)
            _, virt = self.io.submit(res, buf, tag="invalidate").wait()
            lc, sl = self.loc[res], self.slot[res]
            h, d = lc == 1, lc == 0
            if h.any():
                host_tier = self._host_copy(self.host_tier)
                host_tier.numpy()[sl[h]] = buf[h]
                with self._table_lock:
                    self.host_tier = host_tier
            if d.any():
                device_tier = self._device_set(sl[d], buf[d])
                with self._table_lock:
                    self.device_tier = device_tier
            return len(res), virt

    # ------------------------------------------------------------------
    def close(self):
        """Settle split-phase writes still in flight (their tickets would
        otherwise strand unaccounted) and release any write-combined rows
        — the combiner holds the ONLY copy of demoted-dirty values, and
        pre-combiner flush-on-demote persisted them at demotion time, so
        discarding the buffer here would silently lose writes — then shut
        down the IO engine iff this cache created it; shared engines are
        closed by their owner (trainer/server)."""
        if self._wc is not None and len(self._wc):
            with self._wc_io_lock:
                wids, wrows = self._wc.take()
                if len(wids):
                    # registered in _inflight; the settle loop completes it
                    self._write_back_submit(wids, wrows, tag="flush-combine")
        for p in self._snapshot_inflight():
            if isinstance(p, PendingWrite):
                self.complete_write(p)
            else:
                self.complete_write_back(p)
        if self._owns_engine:
            self.io.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
