"""Checks of the write leg shared by the CPU tests against the reference,
the GPU tests and ``chip_smoke.py``'s phase 12.  Not a test module.  It
imports numpy only (``card_and_cpu`` imports the port when called), so it
runs where no JAX is installed.

``Interleaving`` drives random interleavings of the cache's read, write,
refresh, prefetch, flush and invalidate legs on several ``HeteroCache``
objects in lockstep (the reference's and the port's on the CPU; the
port's on the card and on the CPU, ``card_and_cpu``) and on a plain
shadow model: last writer wins, deltas summed.  ``compare_caches`` holds
one cache's state to another's.  ``lost_update_errors`` checks a trained
store against its start and the deltas that reached ``apply_delta``;
``prefetch_invariants`` and ``without_prefetch_timing`` split a trainer
report into what the prefetch operator's thread timing decides and what
it does not.

The operations (``OPS``), each drawn from one seeded generator:

  * a split-phase gather: ``submit_planned``, later ``lookup_planned`` and
    ``complete_planned``, other operations between the phases.  Its rows
    must equal the shadow as it stood at submit: the tables and tiers are
    snapshotted there, storage reads are queued there (the engines' shard
    schedulers keep a later write behind an earlier read of its rows) and
    the write combiner's overlay is captured there;
  * ``gather`` of random ids, and of every row after every operation;
  * ``write_planned`` and ``apply_delta``, each with ``wait`` True or
    False, and ``complete_write`` of a pending write picked at random;
  * ``refresh`` with fresh scores;
  * ``prefetch_rows(wait=False)``, later ``complete_prefetch``;
  * ``flush_submit``, later ``flush_complete``: the store then holds the
    shadow as it stood at submit for every row not written since;
  * ``invalidate_rows``.

Two choices are made from every cache's state at once, so that no cache's
thread timing decides them alone: prefetch candidates and invalidated ids
leave out rows that any cache holds dirty.  A demoted row's dirty bit is
cleared when its write-back ticket completes, which an asynchronous engine
may have done before ``_flush_demoted`` polls it or not (thread timing, in
the reference too); prefetch leaves dirty rows out itself, and an
invalidated dirty row would take the store's older value, which no peer
wrote.
"""
from dataclasses import fields, is_dataclass

import numpy as np

N_OPS = 60
MAX_IDS = 64
OPS = ("gather_submit", "gather_lookup", "gather_complete", "gather",
       "write", "delta", "complete_write", "refresh", "prefetch",
       "complete_prefetch", "flush_submit", "flush_complete", "invalidate")
# what an asynchronous engine's thread timing decides, in the reference
# too.  ``_flush_demoted`` polls a flush-on-demote ticket just after it
# submits it: done, its rows' dirty bits clear and its seconds land in the
# result that caused it and in the stats now; else all of that waits for
# the next barrier.  The sums of those seconds then add in another order.
TIMED_FIELDS = {"RefreshResult": ("flushed", "flush_virtual_s", "virtual_s"),
                "PrefetchResult": ("virtual_s",)}
TIMED_STATS = ("flushed_rows", "virtual_flush_s", "virtual_migrate_s")
FLOAT_REL = 1e-12


def host(rows) -> np.ndarray:
    """Rows or a tier as host numpy: the reference gives numpy (a JAX array
    for its device tier), the port a tensor on its cache's device."""
    if hasattr(rows, "detach"):
        return rows.detach().cpu().numpy()
    return np.asarray(rows)


def keep_last(ids, rows):
    """Last writer wins in batch order (the cache's own rule)."""
    _, first_in_rev = np.unique(ids[::-1], return_index=True)
    last = np.sort(len(ids) - 1 - first_in_rev)
    return ids[last], rows[last]


def summed_delta(ids, delta):
    """Each distinct id once with its deltas summed in float32, in
    ``np.add.at`` order (``apply_delta``'s own rule)."""
    uniq, inv = np.unique(ids, return_inverse=True)
    out = np.zeros((len(uniq), delta.shape[1]), delta.dtype)
    np.add.at(out, inv, delta)
    return uniq, out


def values(x, timed=False):
    """A comparable form of what a cache operation returned: dataclass
    fields (less ``TIMED_FIELDS`` when ``timed``), a pending handle's
    identifying fields, or the value itself."""
    name = type(x).__name__
    if x is None or isinstance(x, (int, float, tuple)):
        return x
    if is_dataclass(x):
        skip = TIMED_FIELDS.get(name, ()) if timed else ()
        return (name, {f.name: getattr(x, f.name) for f in fields(x)
                       if f.name not in skip and not f.name.startswith("_")})
    if name == "PendingWrite":
        return (name, values(x.result, timed))
    if name == "PendingPrefetch":
        return (name, x.tier, x.ids.tolist(), x.victims.tolist(),
                x.victim_ids.tolist(),
                None if x.versions is None else x.versions.tolist())
    if name == "PendingEpochFlush":
        return (name, x.rows, x.bytes,
                None if x.pf is None else x.pf.ids.tolist())
    if name == "PendingGather":
        return (name, x.n_device, x.n_host, x.n_storage, x.n_remote)
    raise TypeError(f"no comparable form for {name}")


def _close(a, b, rel):
    """``a == b`` for counters; floats within ``rel`` (0: exact)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rel)
                                            for k in a)
    if isinstance(a, float) and rel:
        return abs(a - b) <= rel * max(abs(a), abs(b))
    return a == b


def _counters(stats) -> dict:
    v = {k: x for k, x in stats._values().items() if not k.startswith("wall")}
    if hasattr(stats, "by_class"):
        v["by_class"] = {c: {k: x for k, x in d.items()
                             if not k.startswith("wall")}
                         for c, d in stats.by_class.items()}
    return v


def compare_caches(a, b, quiet=True, timed=False):
    """Hold cache ``b`` to cache ``a``: translation tables, tier contents,
    write versions always; dirty bits, the write combiner's ids and rows
    and ``CacheStats`` too, except where ``timed`` (an asynchronous
    engine) and ``quiet`` is False (a write-back ticket may be in flight:
    ``TIMED_STATS`` and the dirty bits wait for its completion); the
    engines' counters only when ``quiet`` (no ticket in flight).  Timed
    float sums are held within ``FLOAT_REL``."""
    for name in ("loc", "slot", "_dev_ids", "_host_ids"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for name in ("device_tier", "host_tier"):
        assert np.array_equal(host(getattr(a, name)),
                              host(getattr(b, name))), name
    assert (a.mut is None) == (b.mut is None)
    settled = quiet or not timed
    if a.mut is not None:
        assert np.array_equal(a.mut._version, b.mut._version), "versions"
        if settled:
            assert np.array_equal(a.mut._dirty, b.mut._dirty), "dirty bits"
    assert (a._wc is None) == (b._wc is None)
    if a._wc is not None and settled:
        assert np.array_equal(a._wc._ids, b._wc._ids), "combiner ids"
        ra, rb = a._wc._rows, b._wc._rows
        assert (ra is None or not len(a._wc._ids)) == \
            (rb is None or not len(b._wc._ids)), "combiner rows"
        if len(a._wc._ids):
            assert np.array_equal(ra, rb), "combiner rows"
    rel = FLOAT_REL if timed else 0.0
    sa, sb = _counters(a.stats), _counters(b.stats)
    if not settled:
        for k in TIMED_STATS:
            sa.pop(k), sb.pop(k)
    for k in sa:
        assert _close(sa[k], sb[k], rel), ("CacheStats", k, sa[k], sb[k])
    if quiet:
        ea, eb = _counters(a.io.stats), _counters(b.io.stats)
        for k in ea:
            assert _close(ea[k], eb[k], rel), ("engine", k, ea[k], eb[k])


# a trainer's ``helios`` mode runs the prefetch and refresh operators of one
# batch on the two io workers at once, and which takes the cache's refresh
# lock first follows the threads, in the reference too (run twice on one
# core its prefetches read 6, 9 and 10 over 12 batches): the prefetch
# tickets and what they read, and the makespan they enter.  Where the
# prefetch admits no row (its candidates are rows the batch just wrote,
# whose versions moved before its ticket landed) every other count is the
# same.
PREFETCH_TIMED = {"cache": ("prefetches", "virtual_prefetch_s"),
                  "io": ("requests", "bytes", "virtual_s", "ranges",
                         "span_bytes", "overlap_efficiency", "bubble_frac")}


def prefetch_invariants(out):
    """What a trainer's report holds whatever the prefetch operator's
    timing (``test_policy.py:326``'s, and the books balancing): prefetches
    ran and admitted no row, the engine's read requests are its stream
    classes' sums, and the cache's prefetch seconds lie within the
    PREFETCH class's (which also takes refresh admissions)."""
    c, io = out["cache"], out["io"]
    assert c["prefetches"] > 0 and c["prefetched_rows"] == 0, c
    by = io["by_class"]
    assert io["requests"] == sum(d["requests"] for d in by.values())
    assert 0 < c["virtual_prefetch_s"] <= by["PREFETCH"]["virtual_io_s"]


def without_prefetch_timing(out):
    """A trainer's report less what ``PREFETCH_TIMED`` names."""
    out = dict(out, virtual_s=None)
    for part, keys in PREFETCH_TIMED.items():
        out[part] = {k: v for k, v in out[part].items() if k not in keys}
    out["io"]["by_class"] = {k: v for k, v in out["io"]["by_class"].items()
                             if k != "PREFETCH"}
    return out


def lost_update_errors(start, final, records, drop):
    """(error, control) of a trained store: the largest |final - (start +
    the recorded deltas)| over every element, the deltas summed per row in
    float64, where ``records`` are the ``(ids, delta)`` pairs that reached
    ``apply_delta``; and the same with record ``drop`` left out of the
    expectation (the control, which must fail: the expectation then
    differs from before at that record's rows alone)."""
    touched = np.unique(np.concatenate([np.asarray(i) for i, _ in records]))
    want = start[touched].astype(np.float64)
    ats = []
    for ids, delta in records:
        at = np.searchsorted(touched, ids)
        ats.append(at)
        if len(np.unique(at)) == len(at):
            want[at] += delta
        else:
            np.add.at(want, at, delta.astype(np.float64))
    got = final[touched]
    err = float(np.abs(got - want).max())
    rest = np.ones(len(start), bool)
    rest[touched] = False
    if rest.any():
        err = max(err, float(np.abs(final[rest] - start[rest]).max()))
    at, delta = np.unique(ats[drop]), np.zeros(want.shape)
    np.add.at(delta, ats[drop], records[drop][1].astype(np.float64))
    control = float(np.abs(got[at] - (want[at] - delta[at])).max())
    return err, control


class Interleaving:
    """One seeded sequence over ``caches`` (each over its own store in
    ``stores``, all holding the same rows, none dirty).  ``check(op,
    results, quiet)`` runs after every operation with the caches' results
    (a list, one per cache) for what the caller compares beyond the rows;
    ``quiet`` is True when no ticket is in flight.  ``timed`` marks an
    engine whose thread timing decides ``TIMED_FIELDS``."""

    def __init__(self, caches, stores, seed, n_ops=N_OPS, check=None,
                 timed=False, full_gather=True):
        self.caches, self.stores = list(caches), list(stores)
        self.rng = np.random.default_rng(seed)
        self.n_ops, self.check, self.timed = n_ops, check, timed
        self.full_gather = full_gather
        self.n = stores[0].n_rows
        self.dim = stores[0].row_dim
        self.all_ids = np.arange(self.n)
        self.shadow = stores[0].read_rows(self.all_ids).copy()
        for s in self.stores[1:]:
            assert np.array_equal(s.read_rows(self.all_ids), self.shadow)
        self.gathers, self.writes, self.prefetches = [], [], []
        self.flushing = None        # (handles, shadow at submit, written)
        self.counts = dict.fromkeys(OPS, 0)

    # -- plumbing ---------------------------------------------------------
    def _ids(self):
        return self.rng.integers(0, self.n, int(self.rng.integers(1, MAX_IDS)))

    def _rows(self, k):
        return self.rng.standard_normal((k, self.dim)).astype(np.float32)

    def _all(self, fn, handles=None):
        """``fn(cache)`` on every cache, or ``fn(cache, handle)`` with each
        cache's own pending handle; the results held equal."""
        out = [fn(c) if handles is None else fn(c, h)
               for c, h in zip(self.caches, handles or self.caches)]
        want = values(out[0], self.timed)
        for o in out[1:]:
            assert values(o, self.timed) == want, (want, values(o))
        return out

    def _dirty_anywhere(self, ids):
        mask = np.zeros(len(ids), bool)
        for c in self.caches:
            if c.mut is not None:
                mask |= c.mut.is_dirty(ids)
        return mask

    def _rows_equal(self, got, want, what):
        for k, g in enumerate(got):
            g = host(g)
            assert g.shape == want.shape, (what, k)
            if not np.array_equal(g, want):
                bad = np.where((g != want).any(axis=-1))[0]
                raise AssertionError(f"{what}: cache {k} differs from the "
                                     f"shadow at rows {bad[:8]}")

    def _written(self, ids):
        if self.flushing is not None:
            self.flushing[2].update(np.asarray(ids).tolist())

    def _pick(self, pending):
        return pending.pop(int(self.rng.integers(0, len(pending))))

    # -- operations -------------------------------------------------------
    def gather_submit(self):
        ids = self._ids()
        hs = self._all(lambda c: c.submit_planned(ids))
        self.gathers.append((hs, self.shadow[ids].copy()))
        return hs

    def gather_lookup(self):
        hs, _ = self.gathers[int(self.rng.integers(0, len(self.gathers)))]
        for c, h in zip(self.caches, hs):
            c.lookup_planned(h)
        return [None] * len(hs)

    def gather_complete(self):
        hs, want = self._pick(self.gathers)
        out = [c.complete_planned(h) for c, h in zip(self.caches, hs)]
        self._rows_equal(out, want, "split-phase gather")
        return [values(h) for h in hs]

    def gather(self, ids=None):
        ids = self._ids() if ids is None else ids
        out = [c.gather(ids) for c in self.caches]
        self._rows_equal(out, self.shadow[ids], "gather")
        return [None] * len(out)

    def write(self):
        ids = self._ids()
        rows = self._rows(len(ids))
        wait = bool(self.rng.integers(0, 2))
        out = self._all(lambda c: c.write_planned(ids, rows, wait=wait))
        ki, kr = keep_last(ids, rows)
        self.shadow[ki] = kr
        self._written(ki)
        if not wait:
            self.writes.append(out)
        return out

    def delta(self):
        ids = self._ids()
        delta = self._rows(len(ids))
        wait = bool(self.rng.integers(0, 2))
        out = self._all(lambda c: c.apply_delta(ids, delta, wait=wait))
        uniq, summed = summed_delta(ids, delta)
        self.shadow[uniq] = self.shadow[uniq] + summed
        self._written(uniq)
        if not wait:
            self.writes.append(out)
        return out

    def complete_write(self):
        hs = self._pick(self.writes)
        return self._all(lambda c, h: c.complete_write(h), hs)

    def refresh(self):
        scores = self.rng.standard_normal(self.n)
        return self._all(lambda c: c.refresh(scores))

    def prefetch(self):
        ids = self.rng.integers(0, self.n, 16)
        ids = ids[~self._dirty_anywhere(ids)]
        out = self._all(lambda c: c.prefetch_rows(ids, wait=False))
        if out[0] is not None:
            self.prefetches.append(out)
        return out

    def complete_prefetch(self):
        hs = self._pick(self.prefetches)
        return self._all(lambda c, h: c.complete_prefetch(h), hs)

    def flush_submit(self):
        out = self._all(lambda c: c.flush_submit())
        self.flushing = (out, self.shadow.copy(), set())
        return out

    def flush_complete(self):
        hs, at_submit, written = self.flushing
        self.flushing = None
        out = self._all(lambda c, h: c.flush_complete(h), hs)
        keep = np.ones(self.n, bool)
        keep[sorted(written)] = False
        first = self.stores[0].read_rows(self.all_ids)
        for k, s in enumerate(self.stores):
            rows = s.read_rows(self.all_ids)
            assert np.array_equal(rows, first), f"store {k} after a flush"
            assert np.array_equal(rows[keep], at_submit[keep]), \
                f"store {k} lost a write the flush covered"
        return out

    def invalidate(self):
        ids = self._ids()
        ids = ids[~self._dirty_anywhere(ids)]
        return self._all(lambda c: c.invalidate_rows(ids))

    # -- the sequence -----------------------------------------------------
    @property
    def quiet(self) -> bool:
        """No ticket in flight: nothing pending here, and no write or
        write-back ticket registered in any cache."""
        return not (self.gathers or self.writes or self.prefetches
                    or self.flushing or any(c._inflight
                                            for c in self.caches))

    def available(self):
        ok = {"gather_lookup": bool(self.gathers),
              "gather_complete": bool(self.gathers),
              "complete_write": bool(self.writes),
              "complete_prefetch": bool(self.prefetches),
              "flush_submit": self.flushing is None,
              "flush_complete": self.flushing is not None}
        return [op for op in OPS if ok.get(op, True)]

    def step(self):
        ops = self.available()
        op = ops[int(self.rng.integers(0, len(ops)))]
        results = getattr(self, op)()
        self.counts[op] += 1
        if self.full_gather:
            self.gather(self.all_ids)
        if self.check is not None:
            self.check(op, results, self.quiet)
        return op

    def finish(self):
        """Land everything still pending, flush, and hold each store alone
        to the shadow."""
        while self.gathers:
            self.gather_complete()
        while self.prefetches:
            self.complete_prefetch()
        while self.writes:
            self.complete_write()
        if self.flushing is not None:
            self.flush_complete()
        out = self._all(lambda c: c.flush())
        for c in self.caches:
            assert c.n_dirty == 0
        for k, s in enumerate(self.stores):
            assert np.array_equal(s.read_rows(self.all_ids), self.shadow), \
                f"store {k} does not reproduce the shadow after the flush"
        self.gather(self.all_ids)
        if self.check is not None:
            self.check("flush", out, self.quiet)

    def run(self):
        for _ in range(self.n_ops):
            self.step()
        self.finish()
        return self.counts


def card_and_cpu(root, device, seed=1000, policy="writeback", combine=16,
                 mode="helios", n_rows=2048, row_dim=16, dev_rows=48,
                 host_rows=96):
    """One interleaving (``Interleaving(seed=seed)``) on the port's cache
    with its device tier on ``device`` (K1's lookup, the pinned host tier,
    K2 in ``_device_rows`` on a card) beside the same sequence on the
    port's cache on the CPU, each over its own writable store made alike
    under ``root``, on engine ``mode``.  The CPU cache's state is held to
    the card's after every operation (``compare_caches``), every gather to
    the shadow and the other bit for bit, the flushed stores to the
    shadow.  Returns the counts of each operation."""
    import os
    from repro_torch.core.hetero_cache import HeteroCache
    from repro_torch.core import iostack
    stores = [iostack.FeatureStore(os.path.join(root, name), n_rows=n_rows,
                                   row_dim=row_dim, n_shards=4, create=True,
                                   rng_seed=seed, writable=True)
              for name in ("card", "cpu")]
    engines = {"gids": lambda st: iostack.SyncIOEngine(st, chaos=None),
               "cpu": lambda st: iostack.CPUManagedEngine(st, chaos=None),
               "helios": lambda st: iostack.AsyncIOEngine(st, chaos=None)}
    hot = np.arange(n_rows)[::-1].astype(float)
    caches = []
    try:
        for st, dev in zip(stores, (device, "cpu")):
            caches.append(HeteroCache(st, hot.copy(), dev_rows, host_rows,
                                      engines[mode](st), device=dev,
                                      write_policy=policy,
                                      write_combine_rows=combine))
        card = caches[0]
        if card.device.type == "cuda":
            assert card.device_tier.is_cuda and card.host_tier.is_pinned()
        timed = mode == "helios"

        def check(op, results, quiet):
            compare_caches(card, caches[1], quiet=quiet, timed=timed)
        return Interleaving(caches, stores, seed, check=check,
                            timed=timed).run()
    finally:
        for c in caches:
            c.close()
            c.io.close()
