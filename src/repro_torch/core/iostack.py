"""Asynchronous storage IO stack (paper §3.1, TPU-adapted).

Helios's GPU-initiated NVMe stack has two properties we preserve exactly:

  1. *Thread-level parallel submission*: requests are batched and striped
     over N submission queues (one per storage shard = one per "SSD"), and a
     BOUNDED worker budget (the paper's "~30% of GPU cores") is enough to
     saturate the array, because workers only build/submit commands.
  2. *Decoupled asynchronous completion*: submission returns a ticket
     immediately; completions land on PER-SHARD completion queues serviced
     independently, so nothing blocks between submit and complete and the
     accelerator never idles on IO.  Tickets resolve the moment THEIR
     shards finish (virtual time = max over their own shards, never the
     global drain), ``IOTicket.poll``/``try_complete`` check without
     blocking, and a ``CompletionQueue`` harvests many in-flight tickets
     in completion order — one slow shard never gates an
     otherwise-finished ticket.

Engines:
  * AsyncIOEngine   — Helios (decoupled SQ/CQ, bounded workers)
  * SyncIOEngine    — GIDS/BaM baseline (submit blocks until completion;
                      the "warp" holds its executor slot for the whole IO)
  * CPUManagedEngine— Ginex/MariusGNN baseline (single-threaded staging)

Storage is memory-mapped shards; virtual IO time comes from the calibrated
``simulator`` so throughput ratios match the paper's hardware envelope.

CONGESTION CONTROL (docs/streams.md is the written contract): every SQE
batch carries a ``StreamClass`` and each shard's submission queue is a
``ShardScheduler`` — a strict-priority head (DEMAND > REMOTE_DEMAND) over
a weighted-fair bulk tail (WRITEBACK > CHECKPOINT > PREFETCH) instead of
FIFO, with read/write hazard tracking so reordering never breaks the
read-after-in-flight-write guarantee the split-phase write path relies
on.  Virtual time is queue-delay-aware: a batch submitted with
``v_submit`` completes at ``max(v_submit, shard_free) + service``, so a
ticket's virtual time models waiting behind earlier-scheduled batches,
not just its own service.  Demand-gather p99 queue delay crossing
``qwait_high_s`` engages back-pressure (``throttled()``) that the cache
and checkpoint streamer consult to throttle PREFETCH/CHECKPOINT
admission until the delay falls back under ``qwait_low_s``.
"""
from __future__ import annotations

import enum
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field, fields

import numpy as np

from repro_torch.core.simulator import (ArrayModel, DEFAULT_ENVELOPE,
                                  HardwareEnvelope, SSDModel)
from repro_torch.ft.chaos import (ChaosSchedule, DEFAULT_RETRY, FatalIOError,
                            RetryPolicy, serve_with_recovery)
from repro_torch.obs import trace as _trace

# write-intent journal the flush barrier parks in the store directory
# (see writeback.FlushJournal); named here because FeatureStore owns the
# directory layout and must drop a stale journal when re-creating
JOURNAL_FILE = "flush.journal"


# ---------------------------------------------------------------------------
# Stream classes: the QoS contract every engine's shard SQs implement
# ---------------------------------------------------------------------------

class StreamClass(enum.IntEnum):
    """Priority-ordered IO stream classes (lower value = higher priority).

    DEMAND and REMOTE_DEMAND are strict-priority: a queued demand batch is
    always scheduled before any bulk batch that has also arrived.  The
    bulk tail (WRITEBACK, CHECKPOINT, PREFETCH) shares leftover service
    weighted-fair by ``DEFAULT_CLASS_WEIGHTS``, so background streams make
    progress in proportion without starving each other.  The taxonomy,
    emitter map, and back-pressure watermarks are documented in
    docs/streams.md.
    """

    DEMAND = 0          # blocking gathers: trainer batches, serving misses
    REMOTE_DEMAND = 1   # peer-owned legs of a demand gather (remote tier)
    WRITEBACK = 2       # dirty-row flush/demote/write-through/combiner
    CHECKPOINT = 3      # embedding checkpoint streaming (save/restore)
    PREFETCH = 4        # policy prefetch + refresh tier migration


#: classes scheduled strict-priority ahead of the weighted-fair bulk tail
STRICT_CLASSES = (StreamClass.DEMAND, StreamClass.REMOTE_DEMAND)

#: weighted-fair shares for the bulk tail (normalized service / weight)
DEFAULT_CLASS_WEIGHTS = {StreamClass.WRITEBACK: 4.0,
                         StreamClass.CHECKPOINT: 2.0,
                         StreamClass.PREFETCH: 1.0}

#: submit ``tag`` -> stream class, for call sites that only pass a tag
#: (an explicit ``sclass=`` always wins; unknown tags default to DEMAND —
#: unlabelled traffic must never be silently deprioritized)
STREAM_TAGS = {
    "": StreamClass.DEMAND,
    "rmw": StreamClass.DEMAND,
    "invalidate": StreamClass.DEMAND,
    "remote": StreamClass.REMOTE_DEMAND,
    "write": StreamClass.WRITEBACK,
    "flush": StreamClass.WRITEBACK,
    "flush-demote": StreamClass.WRITEBACK,
    "flush-combine": StreamClass.WRITEBACK,
    "ckpt": StreamClass.CHECKPOINT,
    "prefetch": StreamClass.PREFETCH,
    "refresh": StreamClass.PREFETCH,
}


def stream_class_of(tag: str, sclass: StreamClass | None = None):
    """Resolve a submission's stream class: explicit ``sclass`` wins, else
    the tag map, else DEMAND."""
    if sclass is not None:
        return StreamClass(sclass)
    return STREAM_TAGS.get(tag, StreamClass.DEMAND)


# ---------------------------------------------------------------------------
# Storage tier: feature rows striped over N memory-mapped shards
# ---------------------------------------------------------------------------

class FeatureStore:
    """Row store striped round-robin over ``n_shards`` memmap files.

    Row ``i`` lives on shard ``i % n_shards`` at offset ``i // n_shards``,
    so hot (low-id) rows spread evenly over the array instead of piling up
    on shard 0 the way contiguous range partitioning would.
    """

    LAYOUT = "round-robin.v1"

    def _layout_tag(self) -> str:
        """Full geometry, not just the scheme: reopening with a different
        shard count/row count would silently permute rows otherwise."""
        return (f"{self.LAYOUT}/nshards={self.n_shards}"
                f"/nrows={self.n_rows}/rowdim={self.row_dim}"
                f"/dtype={self.dtype.name}")

    def __init__(self, path: str, n_rows: int, row_dim: int,
                 dtype=np.float32, n_shards: int = 12, create: bool = False,
                 rng_seed: int | None = None, writable: bool = False):
        self.n_rows, self.row_dim, self.n_shards = n_rows, row_dim, n_shards
        self.dtype = np.dtype(dtype)
        self.row_bytes = self.row_dim * self.dtype.itemsize
        self.writable = writable
        self.path = path        # sibling stores (optimizer state) derive
                                # their location from the feature store's
        os.makedirs(path, exist_ok=True)
        # layout marker: stores written under the old contiguous range
        # partitioning would otherwise reopen and silently permute rows
        marker = os.path.join(path, "LAYOUT")
        fresh = create or not os.path.exists(os.path.join(path, "shard_0.bin"))
        if not fresh:
            tag = (open(marker).read().strip()
                   if os.path.exists(marker) else "<missing>")
            if tag != self._layout_tag():
                raise ValueError(
                    f"feature store at {path} has layout {tag!r}, expected "
                    f"{self._layout_tag()!r}; recreate it with create=True")
        if create:
            # a freshly-created store must not inherit a crashed
            # predecessor's write-intent journal: replaying it would
            # scribble stale rows over the new table
            j = os.path.join(path, JOURNAL_FILE)
            if os.path.exists(j):
                os.remove(j)
        self.shards = []
        for s in range(n_shards):
            n_local = len(range(s, n_rows, n_shards))
            f = os.path.join(path, f"shard_{s}.bin")
            shape = (n_local, row_dim)
            if create or not os.path.exists(f):
                mm = np.lib.format.open_memmap(f, mode="w+", dtype=self.dtype,
                                               shape=shape)
                if rng_seed is not None and shape[0]:
                    rng = np.random.default_rng(rng_seed + s)
                    block = 1 << 14
                    for i in range(0, shape[0], block):
                        j = min(shape[0], i + block)
                        mm[i:j] = rng.standard_normal(
                            (j - i, row_dim)).astype(self.dtype)
                mm.flush()
            self.shards.append(np.lib.format.open_memmap(
                f, mode="r+" if writable else "r"))
        if fresh:
            with open(marker, "w") as fh:
                fh.write(self._layout_tag() + "\n")

    def locate(self, ids: np.ndarray):
        return ids % self.n_shards, ids // self.n_shards

    def read_rows(self, ids: np.ndarray) -> np.ndarray:
        """Raw synchronous gather (no timing model)."""
        sid, off = self.locate(ids)
        out = np.empty((len(ids), self.row_dim), self.dtype)
        for s in range(self.n_shards):
            m = sid == s
            if m.any():
                out[m] = self.shards[s][off[m]]
        return out

    def write_rows(self, ids: np.ndarray, rows: np.ndarray,
                   dedupe: bool = True) -> None:
        """Raw synchronous scatter (no timing model); duplicate ids resolve
        last-writer-wins in batch order.  Engine paths that already ran
        ``keep_last_writer`` at submit time pass ``dedupe=False`` to skip
        the second O(n log n) pass."""
        if not self.writable:
            raise PermissionError("feature store opened read-only; "
                                  "pass writable=True to enable the write path")
        if dedupe:
            ids, rows = keep_last_writer(np.asarray(ids), np.asarray(rows))
        sid, off = self.locate(ids)
        for s in range(self.n_shards):
            m = sid == s
            if m.any():
                self.shards[s][off[m]] = rows[m]

    def flush(self) -> None:
        """Durability barrier: push every shard's dirty pages to storage."""
        for mm in self.shards:
            mm.flush()


def keep_last_writer(ids: np.ndarray, rows: np.ndarray):
    """Deduplicate a write batch so each row id appears once, keeping the
    LAST occurrence (batch order is program order, so later writes win).
    Returns (ids, rows) aligned; deterministic regardless of how the engine
    later sorts or stripes the batch."""
    if len(ids) < 2:
        return ids, rows
    _, first_in_rev = np.unique(ids[::-1], return_index=True)
    last = len(ids) - 1 - first_in_rev
    last.sort()                       # preserve batch order among survivors
    return ids[last], rows[last]


# ---------------------------------------------------------------------------
# IO engines
# ---------------------------------------------------------------------------

@dataclass
class IOTicket:
    future: Future
    n_requests: int
    nbytes: int
    submit_wall: float
    tag: str = ""
    shards: int = 0                     # SQE batches this request striped over

    def wait(self):
        return self.future.result()

    def poll(self) -> bool:
        """Non-blocking completion check: True once every shard of THIS
        ticket has completed (other tickets' stragglers don't matter)."""
        return self.future.done()

    def try_complete(self):
        """Harvest without blocking: the resolved ``(data, virtual_s)``
        when the ticket is done, else ``None`` — the split-phase caller's
        poll loop primitive (a failed ticket re-raises here, exactly as
        ``wait()`` would)."""
        return self.future.result(timeout=0) if self.future.done() else None


class CompletionQueue:
    """Out-of-order harvest over many in-flight tickets.

    Tickets land here the moment THEIR shards complete, so a caller
    draining a multi-ticket batch pops them in completion order instead
    of blocking on whichever ticket happens to sit at the head of a FIFO
    wait loop — the decoupled-CQ half of the paper's stack, surfaced to
    callers (checkpoint streaming, flush barriers, benchmark harvests).
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._pending = 0
        self._lk = threading.Lock()

    def add(self, ticket: IOTicket) -> IOTicket:
        with self._lk:
            self._pending += 1
        # fires immediately if the ticket already resolved (sync engines)
        ticket.future.add_done_callback(lambda _f: self._q.put(ticket))
        return ticket

    @property
    def pending(self) -> int:
        """Tickets added but not yet popped (in flight OR ready)."""
        with self._lk:
            return self._pending

    def try_pop(self) -> IOTicket | None:
        """One finished ticket in completion order, or None."""
        try:
            tk = self._q.get_nowait()
        except queue.Empty:
            return None
        with self._lk:
            self._pending -= 1
        return tk

    def pop(self, timeout: float | None = None) -> IOTicket:
        """Block until ANY in-flight ticket finishes; first-done wins."""
        tk = self._q.get(timeout=timeout)
        with self._lk:
            self._pending -= 1
        return tk

    def harvest(self, block: bool = False) -> list:
        """Every currently-finished ticket, completion order.  With
        ``block=True`` and nothing ready, waits for the first completion
        (then still returns everything that finished by that point)."""
        out = []
        while True:
            tk = self.try_pop()
            if tk is None:
                break
            out.append(tk)
        if block and not out and self.pending:
            out.append(self.pop())
            while True:
                tk = self.try_pop()
                if tk is None:
                    break
                out.append(tk)
        return out

    def drain(self) -> list:
        """Pop every added ticket (blocking), completion order."""
        out = []
        while self.pending:
            out.append(self.pop())
        return out


@dataclass
class IOStats:
    requests: int = 0
    bytes: int = 0                      # useful payload bytes requested
    virtual_io_s: float = 0.0
    wall_submit_s: float = 0.0
    wall_complete_s: float = 0.0
    batches: int = 0
    # striped/coalesced read-path accounting
    shard_batches: int = 0              # per-shard SQE batches submitted
    ranges: int = 0                     # sequential range reads issued
    span_bytes: int = 0                 # bytes streamed incl. coalesce waste
    # write-path accounting (submit_write mirrors of the read fields)
    write_requests: int = 0
    write_bytes: int = 0                # useful payload bytes written
    virtual_write_s: float = 0.0
    write_batches: int = 0
    write_shard_batches: int = 0
    write_ranges: int = 0               # sequential range writes issued
    write_span_bytes: int = 0           # bytes streamed incl. coalesce waste
    # fault-recovery accounting (ChaosSchedule/RetryPolicy paths)
    retries: int = 0                    # failed service attempts retried
    timeouts: int = 0                   # of which: deadline-abandoned
    transient_errors: int = 0           # of which: transient faults
    fatal_errors: int = 0               # ops surfaced fatal on a ticket
    virtual_backoff_s: float = 0.0      # virtual seconds spent backing off
    hedged_reads: int = 0               # peer batches rerouted post-timeout
    degraded_events: int = 0            # streams newly marked degraded
    # congestion-control accounting (ShardScheduler + back-pressure)
    throttle_engaged: int = 0           # demand-p99 watermark crossings up
    throttle_released: int = 0          # hysteresis releases back down
    # per-stream-class breakdown: additive sub-dict keyed by StreamClass
    # NAME -> counter dict (requests/bytes/virt/qwait...).  Existing public
    # keys are untouched — snapshot()/delta() carry it alongside, and the
    # scalar fields above remain the class-summed totals
    by_class: dict = field(default_factory=dict, repr=False, compare=False)
    # engine lock, assigned by the owning engine so snapshot() is atomic
    # with respect to in-flight completions (excluded from repr/compare)
    _lock: object = field(default=None, repr=False, compare=False)

    def bw(self) -> float:
        return self.bytes / self.virtual_io_s if self.virtual_io_s else 0.0

    def write_bw(self) -> float:
        return (self.write_bytes / self.virtual_write_s
                if self.virtual_write_s else 0.0)

    # counters each by_class bucket carries (mirrors of the scalar fields)
    _CLASS_COUNTERS = ("requests", "bytes", "batches", "virtual_io_s",
                       "write_requests", "write_bytes", "write_batches",
                       "virtual_write_s", "qwait_virtual_s", "qwait_batches")

    def _bucket(self, name: str) -> dict:
        """Get-or-create the per-stream-class counter sub-dict.  Callers
        mutate it under the owning engine's lock, like the scalar fields."""
        d = self.by_class.get(name)
        if d is None:
            d = self.by_class[name] = dict.fromkeys(self._CLASS_COUNTERS, 0)
        return d

    def _values(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if not f.name.startswith("_") and f.name != "by_class"}

    def _copy(self) -> "IOStats":
        s = IOStats(**self._values())
        s.by_class = {c: dict(d) for c, d in self.by_class.items()}
        return s

    def snapshot(self) -> "IOStats":
        """Point-in-time copy, taken under the owning engine's lock (when
        attached) so no field pair straddles an in-flight completion."""
        lk = self._lock
        if lk is not None:
            with lk:
                return self._copy()
        return self._copy()

    def delta(self, since: "IOStats") -> "IOStats":
        """Field-wise ``self - since`` over a fresh snapshot — what benches
        use instead of hand-subtracting counter dicts.  The ``by_class``
        sub-dict subtracts bucket-wise (missing buckets count as zero)."""
        cur = self.snapshot()
        base = since._values()
        out = IOStats(**{k: v - base.get(k, 0)
                         for k, v in cur._values().items()})
        for c in cur.by_class.keys() | since.by_class.keys():
            a = cur.by_class.get(c, {})
            b = since.by_class.get(c, {})
            out.by_class[c] = {k: a.get(k, 0) - b.get(k, 0)
                               for k in a.keys() | b.keys()}
        return out

    def publish(self, prefix: str = "io", registry=None) -> None:
        """Publish every counter (plus derived bandwidths) into the obs
        metrics registry as gauges, without touching the public fields.
        Per-class buckets publish under ``<prefix>.class.<CLASS>.<key>``."""
        from repro_torch.obs.metrics import REGISTRY
        reg = registry if registry is not None else REGISTRY
        snap = self.snapshot()
        for k, v in snap._values().items():
            reg.gauge(f"{prefix}.{k}").set(v)
        reg.gauge(f"{prefix}.bw").set(self.bw())
        reg.gauge(f"{prefix}.write_bw").set(self.write_bw())
        for c, d in snap.by_class.items():
            for k, v in d.items():
                reg.gauge(f"{prefix}.class.{c}.{k}").set(v)


def coalesce_offsets(offsets: np.ndarray, gap: int):
    """Sort shard-local row offsets and merge near-adjacent rows into
    sequential ranges.

    Two consecutive sorted offsets join one range when at most ``gap`` rows
    lie unrequested between them (the waste rows are read and discarded —
    bounded read amplification buys sequential access).  Returns
    ``(order, bounds)`` where ``offsets[order]`` is sorted and
    ``bounds[i]:bounds[i+1]`` delimits range ``i`` within the sorted array.
    Duplicate offsets always share a range.
    """
    order = np.argsort(offsets, kind="stable")
    so = offsets[order]
    if len(so) == 0:
        return order, np.zeros(1, np.int64)
    brk = np.where(np.diff(so) > gap + 1)[0] + 1
    bounds = np.concatenate(([0], brk, [len(so)]))
    return order, bounds


ADAPTIVE_GAP = "adaptive"               # coalesce_gap sentinel


def pick_coalesce_gap(offsets: np.ndarray, max_gap: int = 64,
                      amp_cap: float = 1.5) -> int:
    """Per-batch coalesce gap from observed offset density.

    Joining two runs separated by ``d-1`` unrequested rows costs ``d-1``
    waste rows; a dense hot-head batch has many tiny inter-offset gaps, so
    a big gap buys long sequential runs almost for free, while a uniform
    tail batch would pay unbounded read amplification for the same gap.
    Picks the LARGEST gap (<= ``max_gap``) whose total amplification stays
    under ``amp_cap`` x the useful rows: waste is summed over exactly the
    joins that gap would perform, so the bound is exact, not heuristic.
    """
    n = len(offsets)
    if n < 2:
        return 0
    waste = np.diff(np.sort(offsets)) - 1
    waste = waste[(waste > 0) & (waste <= max_gap)]
    if not len(waste):
        return 0                        # only adjacent/duplicate rows: any
    waste.sort()                        # gap coalesces them waste-free
    cum = np.cumsum(waste)
    budget = (amp_cap - 1.0) * n
    # cost(g) = total waste of every join with per-join waste <= g; feasible
    # gaps are the unique waste values whose cumulative cost fits the budget
    uniq, first = np.unique(waste, return_index=True)
    last = np.append(first[1:], len(waste)) - 1
    ok = cum[last] <= budget
    return int(uniq[ok][-1]) if ok.any() else 0


def _overlaps(a: np.ndarray, b: np.ndarray) -> bool:
    """True when two SORTED int arrays share any value (hazard check)."""
    if not len(a) or not len(b):
        return False
    i = np.searchsorted(a, b)
    i[i == len(a)] = len(a) - 1
    return bool((a[i] == b).any())


class _SQE:
    """One shard submission-queue entry (a class-tagged batch)."""

    __slots__ = ("seq", "kind", "sclass", "v_submit", "offs", "offs_sorted",
                 "payload", "comp", "t_enq", "v_start")

    def __init__(self, kind, offs, payload, comp, t_enq, sclass, v_submit):
        self.kind = kind                # "r" read | "w" write
        self.offs = offs
        self.offs_sorted = np.sort(offs)
        self.payload = payload
        self.comp = comp
        self.t_enq = t_enq
        self.sclass = sclass
        self.v_submit = v_submit        # virtual arrival (None = legacy)
        self.seq = -1                   # assigned by the scheduler
        self.v_start = 0.0              # assigned at pop


class ShardScheduler:
    """Class-aware submission queue for ONE shard (or one remote peer).

    Replaces the per-shard FIFO ``queue.Queue``: batches queue FIFO within
    their ``StreamClass``, and the scheduler picks which class's head to
    service next — strict priority for DEMAND/REMOTE_DEMAND, weighted-fair
    (least normalized service, ``weights``) across the bulk tail, or pure
    arrival order with ``policy="fifo"`` (the congestion-bench baseline).

    HAZARDS: reordering across classes must not break the shard's
    read-after-in-flight-write guarantee, so a head is only schedulable
    when no earlier-enqueued batch conflicts with it (offset overlap where
    at least one side is a write).  The globally-oldest queued batch never
    has an earlier conflict, so at least one head is always schedulable —
    the scheduler cannot deadlock, and within one class FIFO order is
    preserved exactly.

    QUEUE-DELAY-AWARE VIRTUAL TIME: the shard keeps a virtual busy-until
    clock ``v_free``.  A batch submitted with a virtual arrival stamp
    ``v_submit`` starts at ``max(v_free, v_submit)`` and pushes ``v_free``
    by its service time, so its completion models waiting behind every
    earlier-scheduled batch at this shard (and the scheduler is
    event-driven: a head that has not virtually arrived yet is not chosen
    while an arrived one exists).  Batches without ``v_submit`` are priced
    as arriving exactly when the shard frees up — zero modeled queue
    delay, the pre-congestion-control accounting, so existing callers see
    identical virtual times.
    """

    def __init__(self, policy: str = "wfq", weights: dict | None = None):
        if policy not in ("wfq", "fifo"):
            raise ValueError(f"unknown scheduler policy {policy!r}")
        self.policy = policy
        self.weights = dict(DEFAULT_CLASS_WEIGHTS)
        if weights:
            self.weights.update(weights)
        self._q = {c: deque() for c in StreamClass}
        self._pending = {}              # seq -> _SQE, ascending-seq order
        self._n_writes = 0
        self._seq = 0
        self.v_free = 0.0               # virtual time the shard frees up
        self._served = dict.fromkeys(StreamClass, 0.0)
        self._lk = threading.Lock()

    def put(self, sqe: _SQE) -> None:
        with self._lk:
            sqe.seq = self._seq
            self._seq += 1
            self._q[sqe.sclass].append(sqe)
            self._pending[sqe.seq] = sqe
            if sqe.kind == "w":
                self._n_writes += 1

    def _blocked(self, e: _SQE) -> bool:
        """An earlier-enqueued, not-yet-serviced batch conflicts with
        ``e`` (RAW/WAR/WAW at offset granularity)."""
        if e.kind == "r" and self._n_writes == 0:
            return False                # read-only backlog: nothing to hit
        for p in self._pending.values():        # ascending seq
            if p.seq >= e.seq:
                return False
            if p.kind == "r" and e.kind == "r":
                continue
            if _overlaps(p.offs_sorted, e.offs_sorted):
                return True
        return False

    def _vs(self, e: _SQE) -> float:
        return e.v_submit if e.v_submit is not None else self.v_free

    def pop(self) -> _SQE | None:
        """Choose and dequeue the next batch (None when empty).  Called
        under the shard's service lock, so at most one batch of this shard
        is in service and ``v_free`` is stable until ``complete()``."""
        with self._lk:
            heads = [q[0] for q in self._q.values() if q]
            if not heads:
                return None
            free = [h for h in heads if not self._blocked(h)]
            # event-driven "now": never idle while an arrived batch waits,
            # never pull a future arrival ahead of the virtual clock
            now = max(self.v_free, min(self._vs(h) for h in free))
            cands = [h for h in free if self._vs(h) <= now]
            if self.policy == "fifo":
                best = min(cands, key=lambda h: (self._vs(h), h.seq))
            else:
                strict = [h for h in cands if h.sclass in STRICT_CLASSES]
                if strict:
                    best = min(strict, key=lambda h: (h.sclass, h.seq))
                else:
                    best = min(cands, key=lambda h: (
                        self._served[h.sclass] / self.weights.get(h.sclass,
                                                                  1.0),
                        h.seq))
            self._q[best.sclass].popleft()
            best.v_start = max(self.v_free, self._vs(best))
            return best

    def complete(self, e: _SQE, svc_virt: float):
        """Book a serviced batch: advance the shard's virtual clock, charge
        the class's fair-share account, release its hazards.  Returns
        ``(v_start, v_end, qwait_virtual)``."""
        with self._lk:
            v_end = e.v_start + svc_virt
            self.v_free = v_end
            self._served[e.sclass] += svc_virt
            del self._pending[e.seq]
            if e.kind == "w":
                self._n_writes -= 1
        q = e.v_start - e.v_submit if e.v_submit is not None else 0.0
        return e.v_start, v_end, q

    def __len__(self) -> int:
        with self._lk:
            return len(self._pending)


def _sched_init(eng, n_streams: int, sched: str, class_weights,
                qwait_high_s, qwait_low_s, sched_log: bool) -> list:
    """Shared congestion-control state for the striped engines (local
    shards and remote peers alike): per-stream schedulers, per-class qwait
    histograms, the demand-delay window, and the back-pressure hysteresis
    state.  Returns the scheduler list."""
    eng.sched = sched
    eng.qwait_high_s = qwait_high_s
    eng.qwait_low_s = (qwait_low_s if qwait_low_s is not None else
                       (qwait_high_s / 2.0 if qwait_high_s is not None
                        else None))
    eng.sched_log = sched_log
    eng.sched_events = []               # (stream, class, seq, vs, v0, v1, k)
    eng._qwait_hist = {}                # class name -> obs Histogram
    eng._demand_win = deque(maxlen=64)  # recent demand qwaits (virtual s)
    eng._throttle_on = False
    return [ShardScheduler(sched, class_weights) for _ in range(n_streams)]


def _note_qwait(eng, stream: int, sqe: _SQE, v_start: float, v_end: float,
                qwait_v: float) -> None:
    """Book one scheduled batch's queue delay: per-class stats bucket +
    histogram, the optional scheduling log, and the demand-p99 watermark
    (back-pressure engages when p99 over the recent window crosses
    ``qwait_high_s`` and releases under ``qwait_low_s`` — deterministic
    given the completion sequence)."""
    name = sqe.sclass.name
    flip = None
    with eng._lock:
        b = eng.stats._bucket(name)
        b["qwait_virtual_s"] += qwait_v
        b["qwait_batches"] += 1
        if eng.sched_log:
            eng.sched_events.append((stream, name, sqe.seq, sqe.v_submit,
                                     v_start, v_end, sqe.kind))
        h = eng._qwait_hist.get(name)
        if h is None:
            from repro_torch.obs.metrics import Histogram
            h = eng._qwait_hist[name] = Histogram(f"io.qwait.{name}")
        if (eng.qwait_high_s is not None and sqe.v_submit is not None
                and sqe.sclass in STRICT_CLASSES):
            win = eng._demand_win
            win.append(qwait_v)
            p99 = sorted(win)[int(0.99 * (len(win) - 1))]
            if not eng._throttle_on and p99 > eng.qwait_high_s:
                eng._throttle_on = True
                eng.stats.throttle_engaged += 1
                flip = ("io.throttle.engage", p99)
            elif eng._throttle_on and p99 < eng.qwait_low_s:
                eng._throttle_on = False
                eng.stats.throttle_released += 1
                flip = ("io.throttle.release", p99)
    h.observe(qwait_v)
    if flip is not None:
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            tr.instant(flip[0], track="congestion", cat="io",
                       args={"demand_p99_v": flip[1], "stream": stream})


class _ShardedCompletion:
    """Aggregates per-shard completions of one striped request batch.

    Shards progress in parallel, so the batch's virtual IO time is the MAX
    over its per-shard service times (bounded below by the PCIe crossing of
    everything streamed); stats land exactly once, when the last shard
    completes and before the ticket's future resolves.

    PARTIAL-TICKET COMPLETION: a shard that fails (fatal-taxonomy CQE)
    doesn't void the others — every remaining shard still services, its
    data lands in the caller's buffer and its virtual time/ranges are
    booked, and only then does the ticket resolve with the first
    exception, annotated with ``completed_shards``/``failed_shards`` so
    callers can see the partial extent.
    """

    __slots__ = ("engine", "fut", "data", "pending", "max_virt", "ranges",
                 "span_bytes", "wall", "exc", "done_shards",
                 "failed_shards", "kind", "_lk", "t0w", "psid", "tag",
                 "sclass", "qwait_virt")

    def __init__(self, engine, fut: Future, data, pending: int,
                 kind: str = "r"):
        self.engine = engine
        self.fut = fut
        self.data = data                # returned payload (None if caller
        self.pending = pending          # supplied its own out buffer)
        self.max_virt = 0.0
        self.ranges = 0
        self.span_bytes = 0
        self.wall = 0.0
        self.exc: BaseException | None = None
        self.done_shards = 0
        self.failed_shards = 0
        self.kind = kind                # "r" read | "w" write
        self._lk = threading.Lock()
        self.t0w = 0.0                  # tracing: submit wall time (abs)
        self.psid = None                # tracing: submit span id (parent)
        self.tag = ""
        self.sclass = StreamClass.DEMAND
        self.qwait_virt = 0.0           # summed modeled queue delay

    def shard_done(self, virt: float, n_ranges: int, span_bytes: int,
                   wall: float, qwait: float = 0.0):
        with self._lk:
            self.max_virt = max(self.max_virt, virt)
            self.ranges += n_ranges
            self.span_bytes += span_bytes
            self.wall += wall
            self.qwait_virt += qwait
            self.done_shards += 1
            self.pending -= 1
            last = self.pending == 0
        if last:
            self._finalize()

    def shard_fail(self, exc: BaseException):
        with self._lk:
            if self.exc is None:        # first failure names the ticket
                self.exc = exc
            self.failed_shards += 1
            self.pending -= 1
            last = self.pending == 0
        if last:
            self._finalize()

    def _finalize(self):
        eng = self.engine
        virt = max(self.max_virt, self.span_bytes / eng.env.pcie_bw)
        with eng._lock:
            b = eng.stats._bucket(self.sclass.name)
            if self.kind == "w":
                eng.stats.virtual_write_s += virt
                eng.stats.wall_complete_s += self.wall
                eng.stats.write_ranges += self.ranges
                eng.stats.write_span_bytes += self.span_bytes
                b["virtual_write_s"] += virt
            else:
                eng.stats.virtual_io_s += virt
                eng.stats.wall_complete_s += self.wall
                eng.stats.ranges += self.ranges
                eng.stats.span_bytes += self.span_bytes
                b["virtual_io_s"] += virt
        tr = _trace.TRACER
        if tr is not None and tr.enabled and self.t0w:
            tr.record(f"io.ticket.{'write' if self.kind == 'w' else 'read'}",
                      self.t0w, time.perf_counter(), track="tickets",
                      cat="io", parent=self.psid,
                      args={"virt_s": virt, "ranges": self.ranges,
                            "span_bytes": self.span_bytes,
                            "shards": self.done_shards,
                            "failed_shards": self.failed_shards,
                            "tag": self.tag, "sclass": self.sclass.name,
                            "qwait_virt_s": self.qwait_virt})
        if self.exc is not None:
            self.exc.completed_shards = self.done_shards
            self.exc.failed_shards = self.failed_shards
            self.fut.set_exception(self.exc)
        else:
            self.fut.set_result((self.data, virt))


def _recover_op(eng, stream: int, kind: str, time_fn, io_fn,
                hedge: bool = False):
    """One engine service op under the engine's fault schedule + retry
    policy, with retry/backoff/degradation accounting booked into the
    engine's ``IOStats``.  With no chaos and no deadline this is the
    zero-overhead clean path.  Returns ``(virt, payload, counters)``;
    fatal-taxonomy faults book ``fatal_errors`` and re-raise.

    Degradation tracking: every failed attempt grows the stream's
    consecutive-failure streak, a clean (retry-free) op resets it, and a
    streak crossing ``eng.degrade_after`` marks the stream degraded
    (``eng.degraded_shards()``) until it recovers — what the cache uses
    to suspend prefetch/checkpoint traffic to a misbehaving shard.
    """
    if eng.chaos is None and eng.retry.deadline_s is None:
        payload = io_fn(None)
        return time_fn(0, False), payload, None

    def next_seq():
        with eng._lock:
            v = eng._chaos_seq[stream]
            eng._chaos_seq[stream] = v + 1
            return v

    def bump_streak(n: int):
        was = eng._fail_streak[stream] >= eng.degrade_after
        eng._fail_streak[stream] += n
        if not was and eng._fail_streak[stream] >= eng.degrade_after:
            eng.stats.degraded_events += 1

    try:
        payload, virt, rec = serve_with_recovery(
            eng._fault, eng.retry, stream, kind, next_seq, time_fn,
            io_fn, hedge=hedge,
            jitter_seed=eng.chaos.seed if eng.chaos is not None else 0)
    except FatalIOError as e:
        rec = getattr(e, "recovery", None)
        with eng._lock:
            st = eng.stats
            st.fatal_errors += 1
            if rec is not None:
                st.retries += rec.retries
                st.timeouts += rec.timeouts
                st.transient_errors += rec.transient
                st.virtual_backoff_s += rec.backoff_s
            bump_streak((rec.retries if rec is not None else 0) + 1)
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            tr.instant(f"ft.fatal.{kind}", track=f"s{stream}", cat="ft",
                       args={"stream": stream,
                             "retries": rec.retries if rec else 0})
        raise
    with eng._lock:
        st = eng.stats
        if rec.retries:
            st.retries += rec.retries
            st.timeouts += rec.timeouts
            st.transient_errors += rec.transient
            st.virtual_backoff_s += rec.backoff_s
            bump_streak(rec.retries)
        else:
            eng._fail_streak[stream] = 0
        if rec.hedged:
            st.hedged_reads += 1
    if rec.retries or rec.hedged:
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            if rec.retries:
                tr.instant(f"ft.retry.{kind}", track=f"s{stream}", cat="ft",
                           args={"stream": stream, "retries": rec.retries,
                                 "timeouts": rec.timeouts,
                                 "transient": rec.transient,
                                 "backoff_s": rec.backoff_s})
            if rec.hedged:
                tr.instant(f"ft.hedge.{kind}", track=f"s{stream}", cat="ft",
                           args={"stream": stream,
                                 "extra_virt_s": rec.extra_virt_s})
    return virt, payload, rec


class AsyncIOEngine:
    """Helios: decoupled thread-level submission + async completion.

    ``submit()`` splits each request batch by storage shard and enqueues ONE
    SQE batch per shard onto that shard's submission queue, so shards
    progress in parallel under the bounded worker budget — the paper's
    thread-level parallel striping over per-SSD SQs.  Inside each shard's
    service loop, requested rows are sorted by offset and near-adjacent rows
    (``coalesce_gap`` unrequested rows or fewer between them) merge into
    sequential memmap range reads, turning random feature misses into
    streamed ranges (DiskGNN's batched-read lever).  The ticket aggregates
    per-shard completions; its virtual time is the max over shards, bounded
    below by the PCIe crossing.

    ``worker_budget`` is the fraction of the executor's cores granted to the
    IO stack (paper: 32 thread blocks ~= 30%); queue depth per shard follows
    the NVMe queue model.  ``striped=False`` keeps the legacy single-queue
    path (one worker executes the whole multi-shard read serially, 4K-random
    cost model) as an ablation baseline.
    """

    def __init__(self, store: FeatureStore, worker_budget: float = 0.3,
                 total_workers: int = 8,
                 env: HardwareEnvelope = DEFAULT_ENVELOPE,
                 striped: bool = True, coalesce_gap: int | str = 8,
                 max_coalesce_gap: int = 64, amp_cap: float = 1.5,
                 chaos: ChaosSchedule | None | str = "env",
                 retry: RetryPolicy | None = None,
                 degrade_after: int = 3,
                 sched: str = "wfq", class_weights: dict | None = None,
                 qwait_high_s: float | None = None,
                 qwait_low_s: float | None = None,
                 sched_log: bool = False):
        self.store = store
        self.env = env
        self.model = ArrayModel(store.n_shards, env)
        self.n_workers = max(1, int(round(worker_budget * total_workers)))
        self.worker_budget = worker_budget
        self.striped = striped
        # coalesce_gap="adaptive" re-picks the gap per shard batch from the
        # observed offset density (pick_coalesce_gap): dense hot-head batches
        # get long runs, uniform tails stay at gap 0 instead of paying
        # unbounded read amplification
        self.adaptive_gap = coalesce_gap == ADAPTIVE_GAP
        self.coalesce_gap = 0 if self.adaptive_gap else int(coalesce_gap)
        self.max_coalesce_gap = max_coalesce_gap
        self.amp_cap = amp_cap
        # fault injection + bounded-retry recovery: ``chaos="env"`` picks
        # up HELIOS_CHAOS (how the CI chaos leg faults every engine in
        # the e2e suite), None disables injection explicitly
        self.chaos = ChaosSchedule.from_env() if chaos == "env" else chaos
        self.retry = retry if retry is not None else DEFAULT_RETRY
        self.degrade_after = degrade_after
        # per-stream service-attempt counters (chaos determinism) and
        # consecutive-failure streaks (degraded-shard marking); the
        # legacy whole-batch path consults stream 0
        self._chaos_seq = [0] * store.n_shards
        self._fail_streak = [0] * store.n_shards
        # exceptions raised OUTSIDE a service call (ticket aggregation,
        # CQ reap): never silently lost with the worker thread
        self.worker_errors: list = []
        self._ssd = SSDModel(env, chaos=self.chaos)
        self._fault = self._ssd.fault
        self._sq: queue.Queue = queue.Queue()       # legacy whole-batch queue
        # legacy path: one service lock so the whole-batch FIFO stays a
        # genuinely serial stream even with several workers alive — the
        # ablation's documented semantics, and the ordering guarantee the
        # split-phase write path relies on (a read submitted after a write
        # must observe it)
        self._legacy_lk = threading.Lock()
        # striped path: one class-aware submission scheduler per shard + a
        # ready queue of shard tokens (one per SQE batch) that the bounded
        # workers pop; the scheduler replaces the former FIFO queue.Queue
        # (strict priority for demand, weighted-fair bulk, hazard-checked —
        # see ShardScheduler and docs/streams.md)
        self._schedulers = _sched_init(self, store.n_shards, sched,
                                       class_weights, qwait_high_s,
                                       qwait_low_s, sched_log)
        self._ready: queue.Queue = queue.Queue()
        self._paused = False            # pause()/resume(): stage arrivals
        # one completion queue per shard: a serviced SQE batch posts its
        # CQE here and the servicing worker reaps it into the ticket, so
        # each shard's completions progress independently of every other
        # shard's backlog (out-of-order ticket completion)
        self._cqs = [queue.Queue() for _ in range(store.n_shards)]
        # per-shard service locks: each shard's SQ drains FIFO through ONE
        # worker at a time (shards still progress in parallel with each
        # other), which is what makes a read submitted after an in-flight
        # split-phase write to the same shard observe that write
        self._shard_lk = [threading.Lock() for _ in range(store.n_shards)]
        self.stats = IOStats()
        self._lock = threading.Lock()
        self.stats._lock = self._lock   # atomic IOStats.snapshot()
        self._stop = False
        target = self._worker if striped else self._worker_legacy
        self._threads = [threading.Thread(target=target, daemon=True)
                         for _ in range(self.n_workers)]
        for t in self._threads:
            t.start()

    # -- submission (returns immediately: nothing waits on the device) ----
    def submit(self, ids: np.ndarray, out: np.ndarray | None = None,
               dest: np.ndarray | None = None, tag: str = "",
               cq: CompletionQueue | None = None,
               sclass: StreamClass | None = None,
               v_submit: float | None = None) -> IOTicket:
        fut: Future = Future()
        t0 = time.perf_counter()
        ids = np.asarray(ids)
        nbytes = len(ids) * self.store.row_bytes
        sc = stream_class_of(tag, sclass)
        if not self.striped:
            self._sq.put(("r", ids, out, dest, fut, t0, sc))
            tk = IOTicket(fut, len(ids), nbytes,
                          time.perf_counter() - t0, tag, shards=1)
            with self._lock:
                self.stats.requests += len(ids)
                self.stats.bytes += nbytes
                self.stats.wall_submit_s += tk.submit_wall
                self.stats.batches += 1
                b = self.stats._bucket(sc.name)
                b["requests"] += len(ids)
                b["bytes"] += nbytes
                b["batches"] += 1
            if cq is not None:
                cq.add(tk)
            return tk

        # striped: split the batch by shard, one SQE batch per shard
        buf = out
        if buf is None:
            buf = np.empty((len(ids), self.store.row_dim), self.store.dtype)
        dest_idx = (np.asarray(dest) if dest is not None
                    else np.arange(len(ids)))
        sid, off = self.store.locate(ids)
        comp = _ShardedCompletion(self, fut, buf if out is None else None, 0)
        comp.sclass = sc
        batches = []
        for s in range(self.store.n_shards):
            m = sid == s
            if m.any():
                batches.append((s, off[m], dest_idx[m]))
        tk = IOTicket(fut, len(ids), nbytes, 0.0, tag, shards=len(batches))
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            comp.t0w = t0
            comp.tag = tag
            comp.psid = tr.current()
        if not batches:                 # empty request: resolve immediately
            fut.set_result((buf if out is None else None, 0.0))
        else:
            comp.pending = len(batches)
            for s, offs, d in batches:
                self._schedulers[s].put(
                    _SQE("r", offs, (d, buf), comp, t0, sc, v_submit))
                self._ready.put(s)
        tk.submit_wall = time.perf_counter() - t0
        if tr is not None and tr.enabled:
            tr.record("io.submit.read", t0, time.perf_counter(),
                      track="submit", cat="io", parent=comp.psid,
                      args={"rows": len(ids), "shards": len(batches),
                            "tag": tag, "sclass": sc.name})
        with self._lock:
            self.stats.requests += len(ids)
            self.stats.bytes += nbytes
            self.stats.wall_submit_s += tk.submit_wall
            self.stats.batches += 1
            self.stats.shard_batches += len(batches)
            b = self.stats._bucket(sc.name)
            b["requests"] += len(ids)
            b["bytes"] += nbytes
            b["batches"] += 1
        if cq is not None:
            cq.add(tk)
        return tk

    def submit_write(self, ids: np.ndarray, rows: np.ndarray,
                     tag: str = "",
                     cq: CompletionQueue | None = None,
                     sclass: StreamClass | None = None,
                     v_submit: float | None = None) -> IOTicket:
        """``submit()`` mirror for the WRITE path: per-shard striped SQE
        write batches, range-coalesced sequential writes, one aggregating
        ticket.  Duplicate ids resolve last-writer-wins BEFORE striping, so
        the outcome is deterministic no matter how shards reorder.  The
        ticket resolves with ``(None, virtual_seconds)``."""
        if not self.store.writable:
            raise PermissionError("submit_write on a read-only FeatureStore; "
                                  "open it with writable=True")
        fut: Future = Future()
        t0 = time.perf_counter()
        ids = np.asarray(ids)
        rows = np.asarray(rows, self.store.dtype)
        if rows.shape != (len(ids), self.store.row_dim):
            raise ValueError(f"rows shape {rows.shape} != "
                             f"({len(ids)}, {self.store.row_dim})")
        ids, rows = keep_last_writer(ids, rows)
        nbytes = len(ids) * self.store.row_bytes
        sc = stream_class_of(tag if tag else "write", sclass)
        if not self.striped:
            self._sq.put(("w", ids, rows, None, fut, t0, sc))
            tk = IOTicket(fut, len(ids), nbytes,
                          time.perf_counter() - t0, tag, shards=1)
            with self._lock:
                self.stats.write_requests += len(ids)
                self.stats.write_bytes += nbytes
                self.stats.wall_submit_s += tk.submit_wall
                self.stats.write_batches += 1
                b = self.stats._bucket(sc.name)
                b["write_requests"] += len(ids)
                b["write_bytes"] += nbytes
                b["write_batches"] += 1
            if cq is not None:
                cq.add(tk)
            return tk

        sid, off = self.store.locate(ids)
        comp = _ShardedCompletion(self, fut, None, 0, kind="w")
        comp.sclass = sc
        batches = []
        for s in range(self.store.n_shards):
            m = sid == s
            if m.any():
                batches.append((s, off[m], rows[m]))
        tk = IOTicket(fut, len(ids), nbytes, 0.0, tag, shards=len(batches))
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            comp.t0w = t0
            comp.tag = tag
            comp.psid = tr.current()
        if not batches:                 # empty batch: resolve immediately
            fut.set_result((None, 0.0))
        else:
            comp.pending = len(batches)
            for s, offs, data in batches:
                self._schedulers[s].put(
                    _SQE("w", offs, data, comp, t0, sc, v_submit))
                self._ready.put(s)
        tk.submit_wall = time.perf_counter() - t0
        if tr is not None and tr.enabled:
            tr.record("io.submit.write", t0, time.perf_counter(),
                      track="submit", cat="io", parent=comp.psid,
                      args={"rows": len(ids), "shards": len(batches),
                            "tag": tag, "sclass": sc.name})
        with self._lock:
            self.stats.write_requests += len(ids)
            self.stats.write_bytes += nbytes
            self.stats.wall_submit_s += tk.submit_wall
            self.stats.write_batches += 1
            self.stats.write_shard_batches += len(batches)
            b = self.stats._bucket(sc.name)
            b["write_requests"] += len(ids)
            b["write_bytes"] += nbytes
            b["write_batches"] += 1
        if cq is not None:
            cq.add(tk)
        return tk

    def _gap_for(self, offs: np.ndarray) -> int:
        return (pick_coalesce_gap(offs, self.max_coalesce_gap, self.amp_cap)
                if self.adaptive_gap else self.coalesce_gap)

    # -- per-shard service: sorted, range-coalesced sequential reads ------
    def _service_shard(self, shard: int, offs: np.ndarray, dest: np.ndarray,
                       buf: np.ndarray):
        mm = self.store.shards[shard]
        order, bounds = coalesce_offsets(offs, self._gap_for(offs))
        so, sd = offs[order], dest[order]
        spans = [(int(so[lo]), int(so[hi - 1]) + 1, lo, hi)
                 for lo, hi in zip(bounds[:-1], bounds[1:])]
        n_ranges = len(bounds) - 1
        span_rows = sum(end - start for start, end, _, _ in spans)
        span_bytes = span_rows * self.store.row_bytes
        # per-SSD queue depth under the worker budget (32 blocks ~ 30% of
        # cores keep ~256 commands in flight per device; below that the
        # device starves — paper Fig. 7)
        qd = int(256 * min(1.0, self.worker_budget / 0.3))

        def time_fn(attempt, hedged):
            return self._ssd.range_io_time(n_ranges, span_bytes, qd)

        def io_fn(fd):
            # runs once, on the successful attempt: retried reads return
            # bit-identical bytes no matter how many attempts failed
            for start, end, lo, hi in spans:
                block = mm[start:end]   # sequential slice, not fancy-index
                buf[sd[lo:hi]] = block[so[lo:hi] - start]

        virt, _, _ = _recover_op(self, shard, "r", time_fn, io_fn)
        return virt, n_ranges, span_bytes

    # -- per-shard service: sorted, range-coalesced sequential WRITES -----
    def _service_shard_write(self, shard: int, offs: np.ndarray,
                             rows: np.ndarray):
        """Dirty rows sorted by offset; runs with <= gap untouched rows
        between them become ONE sequential write stream (the untouched gap
        rows ride along read-modify-write style, bounded write
        amplification buying sequential NAND programs).  Only the requested
        offsets are actually stored — the span shows up in the timing
        model, never in the data."""
        mm = self.store.shards[shard]
        order, bounds = coalesce_offsets(offs, self._gap_for(offs))
        so, sr = offs[order], rows[order]
        span_rows = sum(int(so[hi - 1]) + 1 - int(so[lo])
                        for lo, hi in zip(bounds[:-1], bounds[1:]))
        n_ranges = len(bounds) - 1
        span_bytes = span_rows * self.store.row_bytes
        qd = int(256 * min(1.0, self.worker_budget / 0.3))

        def time_fn(attempt, hedged):
            return self._ssd.range_write_time(n_ranges, span_bytes, qd)

        def io_fn(fd):
            if fd is not None and fd.torn:
                # torn write: only a prefix of the sorted stream programs
                # before the simulated crash — what the flush journal's
                # replay-or-discard recovery exists for
                k = len(so) // 2
                mm[so[:k]] = sr[:k]
                return
            mm[so] = sr                 # offsets unique post-dedupe

        virt, _, _ = _recover_op(self, shard, "w", time_fn, io_fn)
        return virt, n_ranges, span_bytes

    # -- completion handling (worker pool = the paper's CQ-polling kernel) -
    def _reap_cq(self, s: int):
        """Drain shard ``s``'s completion queue into its tickets.  CQEs
        carry everything the aggregation needs, so reaping is lock-free
        with respect to the shard's SERVICE path — a slow service on one
        shard never delays another shard's reap."""
        t0 = time.perf_counter()
        n = 0
        while True:
            try:
                comp, cqe = self._cqs[s].get_nowait()
            except queue.Empty:
                break
            n += 1
            if isinstance(cqe, BaseException):
                comp.shard_fail(cqe)
            else:
                comp.shard_done(*cqe)
        if n:
            tr = _trace.TRACER
            if tr is not None and tr.enabled:
                tr.record("io.reap", t0, time.perf_counter(),
                          track=f"ssd{s}/q", cat="io",
                          args={"shard": s, "cqes": n})

    def _worker(self):
        while not self._stop:
            try:
                s = self._ready.get(timeout=0.1)
            except queue.Empty:
                continue
            # paused engine: callers are staging a full arrival schedule so
            # the scheduler sees every competing batch before choosing —
            # hand the token back until resume()
            if self._paused:
                self._ready.put(s)
                self._ready.task_done()
                time.sleep(2e-4)
                continue
            # class-aware per-shard service: one worker drains a given
            # shard's scheduler at a time — the scheduler (not FIFO) picks
            # which class's head runs, while its hazard checks keep the
            # read-after-write guarantee the split-phase write path needs;
            # OTHER shards proceed in parallel on other workers.  On
            # contention the token goes back and the worker moves on.
            if not self._shard_lk[s].acquire(blocking=False):
                self._ready.put(s)
                self._ready.task_done()
                time.sleep(2e-4)        # don't spin hot on one busy shard
                continue
            try:
                sqe = self._schedulers[s].pop()
                if sqe is None:         # pragma: no cover - token per entry
                    continue
                comp = sqe.comp
                try:
                    t0 = time.perf_counter()
                    if sqe.kind == "w":
                        out = self._service_shard_write(s, sqe.offs,
                                                        sqe.payload)
                    else:
                        d, buf = sqe.payload
                        out = self._service_shard(s, sqe.offs, d, buf)
                    t1 = time.perf_counter()
                    v0, v1, qwait_v = self._schedulers[s].complete(sqe,
                                                                   out[0])
                    _note_qwait(self, s, sqe, v0, v1, qwait_v)
                    # queue-delay-aware virtual time: with an explicit
                    # virtual arrival the shard leg is priced from arrival
                    # to virtual completion (waiting behind every
                    # earlier-scheduled batch); without one, service only —
                    # the pre-congestion-control accounting
                    leg_virt = (v1 - sqe.v_submit
                                if sqe.v_submit is not None else out[0])
                    self._cqs[s].put(
                        (comp, (leg_virt, out[1], out[2], t1 - t0, qwait_v)))
                    tr = _trace.TRACER
                    if tr is not None and tr.enabled:
                        psid = getattr(comp, "psid", None)
                        tr.record("io.qwait", sqe.t_enq, t0,
                                  track=f"ssd{s}/q",
                                  cat="io", parent=psid,
                                  args={"shard": s, "kind": sqe.kind,
                                        "sclass": sqe.sclass.name,
                                        "qwait_virt_s": qwait_v})
                        tr.record(f"io.service.{sqe.kind}", t0, t1,
                                  track=f"ssd{s}", cat="io", parent=psid,
                                  args={"shard": s, "virt_s": out[0],
                                        "ranges": out[1],
                                        "span_bytes": out[2],
                                        "sclass": sqe.sclass.name})
                except Exception as e:
                    # errored CQE: the owning ticket gets the exception
                    # (via shard_fail) and the worker stays alive to
                    # service the next SQE batch — a service fault must
                    # never kill the thread silently.  The scheduler entry
                    # still completes (zero service) so its hazards release
                    self._schedulers[s].complete(sqe, 0.0)
                    self._cqs[s].put((comp, e))
            finally:
                self._shard_lk[s].release()
                try:
                    # the CQE is reaped OUTSIDE the shard lock: ticket
                    # aggregation (and future resolution callbacks) never
                    # block the next SQE batch of this shard from starting
                    self._reap_cq(s)
                except Exception as e:  # pragma: no cover - defensive
                    # aggregation bugs surface on the engine, not as a
                    # silent daemon-thread death that strands task_done
                    self.worker_errors.append(e)
                # pairs with drain()'s Queue.join(): the token only counts
                # as done once its shard read landed and was aggregated
                self._ready.task_done()

    def _worker_legacy(self):
        while not self._stop:
            # the pop happens INSIDE the service lock: two workers popping
            # FIFO items and racing their service would reorder a read
            # after the write it must observe
            if not self._legacy_lk.acquire(timeout=0.1):
                continue
            try:
                kind, ids, a, b, fut, t_enq, sc = self._sq.get(timeout=0.1)
            except queue.Empty:
                self._legacy_lk.release()
                continue
            try:
                t0 = time.perf_counter()
                # virtual time under the paper's hardware envelope; the
                # worker budget bounds in-flight NVMe commands exactly like
                # the paper's thread-block count does (32 blocks ~ 30% of
                # cores saturate 12 SSDs; below that the array starves)
                qd = int(256 * self.store.n_shards * min(1.0, self.worker_budget / 0.3))
                if kind == "w":
                    # whole-batch serial write, 4K-random write cost model
                    # (ids were deduped last-writer-wins at submit time);
                    # the whole-batch path is chaos stream 0
                    def wtime_fn(attempt, hedged):
                        return self.model.write_time(
                            len(ids), self.store.row_bytes, qd)

                    def wio_fn(fd):
                        if fd is not None and fd.torn:
                            k = len(ids) // 2
                            self.store.write_rows(ids[:k], a[:k],
                                                  dedupe=False)
                            return
                        self.store.write_rows(ids, a, dedupe=False)

                    virt, _, _ = _recover_op(self, 0, "w", wtime_fn, wio_fn)
                    t1 = time.perf_counter()
                    with self._lock:
                        self.stats.virtual_write_s += virt
                        self.stats.wall_complete_s += t1 - t0
                        self.stats._bucket(sc.name)["virtual_write_s"] += \
                            virt
                    tr = _trace.TRACER
                    if tr is not None and tr.enabled:
                        tr.record("io.qwait", t_enq, t0, track="legacy/q",
                                  cat="io", args={"kind": "w"})
                        tr.record("io.service.w", t0, t1, track="legacy",
                                  cat="io",
                                  args={"virt_s": virt, "rows": len(ids)})
                    fut.set_result((None, virt))
                else:
                    out, dest = a, b

                    def rtime_fn(attempt, hedged):
                        return self.model.read_time(
                            len(ids), self.store.row_bytes, qd)

                    box = {}

                    def rio_fn(fd):
                        # single read on the SUCCESSFUL attempt only —
                        # retries return bit-identical bytes
                        data = self.store.read_rows(ids)
                        if out is not None:
                            out[dest if dest is not None
                                else slice(0, len(ids))] = data
                        box["data"] = data

                    virt, _, _ = _recover_op(self, 0, "r", rtime_fn, rio_fn)
                    t1 = time.perf_counter()
                    with self._lock:
                        self.stats.virtual_io_s += virt
                        self.stats.wall_complete_s += t1 - t0
                        self.stats._bucket(sc.name)["virtual_io_s"] += virt
                    tr = _trace.TRACER
                    if tr is not None and tr.enabled:
                        tr.record("io.qwait", t_enq, t0, track="legacy/q",
                                  cat="io", args={"kind": "r"})
                        tr.record("io.service.r", t0, t1, track="legacy",
                                  cat="io",
                                  args={"virt_s": virt, "rows": len(ids)})
                    fut.set_result((box["data"] if out is None else None,
                                    virt))
            except Exception as e:
                # errored request: the waiter sees the exception via the
                # future, and the worker stays alive for the next item —
                # fatal chaos faults surface at ticket.wait(), never as a
                # silently-dead daemon thread
                fut.set_exception(e)
            finally:
                self._legacy_lk.release()
                # pairs with drain()'s Queue.join(): the item only counts
                # as done once its read landed and its future resolved
                self._sq.task_done()

    # -- congestion control: admission pause + back-pressure signal -------
    def pause(self):
        """Hold service: workers requeue ready tokens until ``resume()``.
        Lets callers (benches, tests) stage a full virtual arrival
        schedule so the scheduler's choices are a pure function of the
        staged batches — no wall-clock races."""
        self._paused = True

    def resume(self):
        self._paused = False

    def throttled(self, sclass: StreamClass = StreamClass.PREFETCH) -> bool:
        """Back-pressure signal for bulk admission: True while demand-class
        p99 queue delay (over the recent window) sits above
        ``qwait_high_s`` and has not yet fallen below ``qwait_low_s``.
        Only PREFETCH and CHECKPOINT admission honors it — demand,
        remote-demand, and write-back (correctness) traffic never
        throttles."""
        if sclass not in (StreamClass.PREFETCH, StreamClass.CHECKPOINT):
            return False
        return self._throttle_on

    def qwait_summary(self) -> dict:
        """Per-class queue-delay histogram summaries (virtual seconds),
        keyed by StreamClass name."""
        with self._lock:
            hists = dict(self._qwait_hist)
        return {name: h.summary() for name, h in hists.items()}

    # -- degraded-shard introspection (graceful degradation) --------------
    def degraded_shards(self) -> np.ndarray:
        """Shards whose consecutive-failure streak crossed
        ``degrade_after``: the cache suspends prefetch/checkpoint traffic
        to them while demand gathers keep being served (with retries)."""
        with self._lock:
            return np.array([s for s, v in enumerate(self._fail_streak)
                             if v >= self.degrade_after], np.int64)

    def shard_of(self, ids: np.ndarray) -> np.ndarray:
        """Map global row ids to the chaos/degradation stream (= storage
        shard) that serves them."""
        return self.store.locate(np.asarray(ids))[0]

    def close(self):
        """Drain, stop, and JOIN the worker threads (idempotent).

        Draining first means every ticket submitted before close() still
        resolves — workers check ``_stop`` before popping, so stopping with
        items queued would strand their futures and deadlock any waiter.
        Callers that share one engine across consumers (e.g. a
        ``HeteroCache`` inside a server) route shutdown through the owner;
        see ``HeteroCache.close``.
        """
        if self._threads:
            self.drain()
        self._stop = True
        for t in self._threads:
            # unbounded: shutdown legitimately waits out in-flight IO —
            # workers exit within one queue-poll interval once idle, and a
            # timed join would let a slow worker outlive close() unnoticed
            t.join()
        self._threads = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def drain(self):
        """Block until every submitted request has COMPLETED, not merely
        been popped: ``Queue.empty()`` turns true while a worker is still
        mid-read on the last item, so ``join()``/``task_done()`` semantics
        are what make close() safe to join on.  Only meaningful while
        workers are alive — close() guards accordingly."""
        if self.striped:
            self._ready.join()
        else:
            self._sq.join()


class SyncIOEngine:
    """GIDS/BaM-style baseline: the submitting context BLOCKS until the IO
    completes (warp spins between submit and poll), so submission slots are
    held for the full IO latency and effective queue depth collapses."""

    def __init__(self, store: FeatureStore, total_workers: int = 8,
                 env: HardwareEnvelope = DEFAULT_ENVELOPE,
                 chaos: ChaosSchedule | None | str = "env",
                 retry: RetryPolicy | None = None,
                 degrade_after: int = 3):
        self.store = store
        self.env = env
        self.model = ArrayModel(store.n_shards, env)
        self.stats = IOStats()
        # chaos recovery state (stream 0: the coupled path services the
        # whole batch as one attempt); fatal faults raise synchronously
        # from submit — the coupled contract has no deferred ticket wait
        self.chaos = ChaosSchedule.from_env() if chaos == "env" else chaos
        self.retry = retry if retry is not None else DEFAULT_RETRY
        self.degrade_after = degrade_after
        self._chaos_seq = [0]
        self._fail_streak = [0]
        self.worker_errors: list = []
        self._ssd = SSDModel(env, chaos=self.chaos)
        self._fault = self._ssd.fault
        self._lock = threading.Lock()
        self.stats._lock = self._lock   # atomic IOStats.snapshot()

    def degraded_shards(self) -> np.ndarray:
        """Whole engine degrades as one unit (single service stream)."""
        with self._lock:
            if self._fail_streak[0] >= self.degrade_after:
                return np.arange(self.store.n_shards, dtype=np.int64)
        return np.empty(0, np.int64)

    def shard_of(self, ids: np.ndarray) -> np.ndarray:
        return self.store.locate(np.asarray(ids))[0]

    def close(self):
        pass                            # no worker threads to reap

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _staging_virt(self, n_ids: int) -> float:
        """Host-side staging overhead (none for the GPU-managed baseline)."""
        return 0.0

    # -- congestion-control API parity (no queues: nothing to schedule) ---
    def pause(self):
        pass

    def resume(self):
        pass

    def throttled(self, sclass: "StreamClass | None" = None) -> bool:
        return False                    # coupled path: no back-pressure

    def qwait_summary(self) -> dict:
        return {}                       # coupled path: zero queue delay

    def submit(self, ids: np.ndarray, out: np.ndarray | None = None,
               dest: np.ndarray | None = None, tag: str = "",
               cq: CompletionQueue | None = None,
               sclass: StreamClass | None = None,
               v_submit: float | None = None) -> IOTicket:
        t0 = time.perf_counter()
        sc = stream_class_of(tag, sclass)
        box = {}

        def time_fn(attempt, hedged):
            # coupled submit/poll: a warp holds its slot from submit to
            # completion, collapsing effective queue depth (paper: ~60%
            # of peak); staging rides along on every (re)attempt
            return (self.model.read_time(
                        len(ids), self.store.row_bytes,
                        int(256 * self.store.n_shards * 0.6))
                    + self._staging_virt(len(ids)))

        def io_fn(fd):
            data = self.store.read_rows(ids)
            if out is not None:
                out[dest if dest is not None else slice(0, len(ids))] = data
            box["data"] = data

        virt, _, _ = _recover_op(self, 0, "r", time_fn, io_fn)
        data = box["data"]
        t1 = time.perf_counter()
        wall = t1 - t0
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            tr.record("io.sync.read", t0, t1, track="sync", cat="io",
                      args={"virt_s": virt, "rows": len(ids), "tag": tag})
        self.stats.requests += len(ids)
        self.stats.bytes += len(ids) * self.store.row_bytes
        self.stats.virtual_io_s += virt
        self.stats.wall_complete_s += wall
        self.stats.batches += 1
        b = self.stats._bucket(sc.name)
        b["requests"] += len(ids)
        b["bytes"] += len(ids) * self.store.row_bytes
        b["batches"] += 1
        b["virtual_io_s"] += virt
        fut: Future = Future()
        # the ticket resolves with the SAME virtual seconds the engine
        # accounted — downstream (cache stats) must agree with engine stats
        fut.set_result((data if out is None else None, virt))
        tk = IOTicket(fut, len(ids), len(ids) * self.store.row_bytes,
                      time.perf_counter() - t0, tag, shards=1)
        if cq is not None:
            cq.add(tk)
        return tk

    def submit_write(self, ids: np.ndarray, rows: np.ndarray,
                     tag: str = "",
                     cq: CompletionQueue | None = None,
                     sclass: StreamClass | None = None,
                     v_submit: float | None = None) -> IOTicket:
        """Coupled write: blocks until the rows land (the warp holds its
        slot for the whole program/flush, collapsing queue depth)."""
        t0 = time.perf_counter()
        sc = stream_class_of(tag if tag else "write", sclass)
        ids = np.asarray(ids)
        rows = np.asarray(rows, self.store.dtype)
        ids, rows = keep_last_writer(ids, rows)

        def time_fn(attempt, hedged):
            return (self.model.write_time(
                        len(ids), self.store.row_bytes,
                        int(256 * self.store.n_shards * 0.6))
                    + self._staging_virt(len(ids)))

        def io_fn(fd):
            if fd is not None and fd.torn:
                k = len(ids) // 2
                self.store.write_rows(ids[:k], rows[:k], dedupe=False)
                return
            self.store.write_rows(ids, rows, dedupe=False)

        virt, _, _ = _recover_op(self, 0, "w", time_fn, io_fn)
        t1 = time.perf_counter()
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            tr.record("io.sync.write", t0, t1, track="sync", cat="io",
                      args={"virt_s": virt, "rows": len(ids), "tag": tag})
        nbytes = len(ids) * self.store.row_bytes
        self.stats.write_requests += len(ids)
        self.stats.write_bytes += nbytes
        self.stats.virtual_write_s += virt
        self.stats.wall_complete_s += t1 - t0
        self.stats.write_batches += 1
        b = self.stats._bucket(sc.name)
        b["write_requests"] += len(ids)
        b["write_bytes"] += nbytes
        b["write_batches"] += 1
        b["virtual_write_s"] += virt
        fut: Future = Future()
        fut.set_result((None, virt))
        tk = IOTicket(fut, len(ids), nbytes,
                      time.perf_counter() - t0, tag, shards=1)
        if cq is not None:
            cq.add(tk)
        return tk


class CPUManagedEngine(SyncIOEngine):
    """Ginex/MariusGNN-style: single CPU thread stages features through host
    memory before any device transfer; adds host gather cost serially."""

    def _staging_virt(self, n_ids: int) -> float:
        # serial host-side staging pass (memcpy through CPU buffers)
        return n_ids * self.store.row_bytes / self.env.dram_bw * 4.0


def make_engine(mode: str, store: FeatureStore, worker_budget: float = 0.3,
                env: HardwareEnvelope = DEFAULT_ENVELOPE,
                striped: bool = True, coalesce_gap: int | str = 8,
                chaos: ChaosSchedule | None | str = "env",
                retry: RetryPolicy | None = None,
                degrade_after: int = 3,
                sched: str = "wfq", class_weights: dict | None = None,
                qwait_high_s: float | None = None,
                qwait_low_s: float | None = None,
                sched_log: bool = False):
    """Engine for an ablation mode (shared by trainer and server):
    ``cpu`` -> CPUManagedEngine, ``gids`` -> SyncIOEngine, anything
    Helios-flavoured -> AsyncIOEngine (``striped``/``coalesce_gap`` tune
    the per-shard SQ read path; ``coalesce_gap="adaptive"`` re-picks the
    gap per batch from offset density; ``striped=False`` is the legacy
    single-queue ablation).  ``chaos``/``retry``/``degrade_after``
    configure fault injection + bounded-retry recovery on every mode.
    ``sched``/``class_weights``/``qwait_high_s``/``qwait_low_s`` configure
    per-stream-class shard scheduling + back-pressure (docs/streams.md);
    the coupled cpu/gids baselines have no queues, so the knobs only
    apply to the striped/legacy Helios engine.  The default
    ``chaos="env"`` reads ``HELIOS_CHAOS``."""
    if mode == "cpu":
        return CPUManagedEngine(store, env=env, chaos=chaos, retry=retry,
                                degrade_after=degrade_after)
    if mode == "gids":
        return SyncIOEngine(store, env=env, chaos=chaos, retry=retry,
                            degrade_after=degrade_after)
    return AsyncIOEngine(store, worker_budget=worker_budget, env=env,
                         striped=striped, coalesce_gap=coalesce_gap,
                         chaos=chaos, retry=retry,
                         degrade_after=degrade_after,
                         sched=sched, class_weights=class_weights,
                         qwait_high_s=qwait_high_s,
                         qwait_low_s=qwait_low_s, sched_log=sched_log)
