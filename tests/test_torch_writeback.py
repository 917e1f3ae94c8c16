"""The port's write legs of ``HeteroCache`` against the reference
package's, leg by leg as ``tests/test_writeback.py`` runs them on the
reference alone: each leg runs the same seeded operations on both
packages' caches, each over its own writable ``FeatureStore`` made with
the same arguments and seed, on the engine modes the reference's leg
lists.  The reference runs its numpy lookup (``fused_backend="host"``);
the port runs K1's plain version (``"kernel"``) and its numpy lookup
(``"host"``) on the CPU.

After every operation: the gathered rows are bit-identical (the port's
come back as a tensor), every field of the returned ``WriteResult``,
``FlushResult``, ``PrefetchResult`` and ``RefreshResult`` is equal, and so
are ``CacheStats``, the engine's counters and virtual seconds, the
translation tables and tiers, the ``MutableTierTable``'s dirty bits and
versions and the write combiner's ids and rows; after each flush the
stores hold the same rows.  On the asynchronous engine a flush-on-demote
ticket's completion follows thread timing in the reference too
(``writeback_compare.TIMED_FIELDS``); those quantities are compared once no
ticket is in flight, float sums within rel 1e-12.  The random
interleavings are in ``tests/test_torch_writeback_random.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.iostack as r_io  # noqa: E402
from repro.core.hetero_cache import HeteroCache as RefCache  # noqa: E402
import repro_torch.core.iostack as t_io  # noqa: E402
from repro_torch.core.hetero_cache import HeteroCache  # noqa: E402
from repro_torch.core.hetero_cache import (PendingPrefetch,  # noqa: E402
                                           PendingWrite)
from writeback_compare import compare_caches, keep_last, values  # noqa: E402

N_ROWS, ROW_DIM, N_SHARDS = 2048, 16, 4
BACKENDS = ("kernel", "host")
ENGINES = {
    "helios": lambda io, s: io.AsyncIOEngine(s, chaos=None),
    "helios-legacy": lambda io, s: io.AsyncIOEngine(s, striped=False,
                                                    chaos=None),
    "gids": lambda io, s: io.SyncIOEngine(s, chaos=None),
    "cpu": lambda io, s: io.CPUManagedEngine(s, chaos=None),
}
TIMED = {"helios", "helios-legacy"}     # worker threads complete tickets


def _hot():
    return np.arange(N_ROWS)[::-1].astype(float)


def _rows(rng, n):
    return rng.standard_normal((n, ROW_DIM)).astype(np.float32)


class Twin:
    """The reference's cache (``r``) and the port's (``t``) over stores
    made alike, on engine ``engine``; ``both(fn)`` runs ``fn`` on each and
    holds the results equal, ``check()`` holds their state equal."""

    def __init__(self, root, engine, backend, dev_rows, host_rows, **kw):
        kw_store = dict(n_rows=N_ROWS, row_dim=ROW_DIM, n_shards=N_SHARDS,
                        create=True, rng_seed=0, writable=True)
        self.rs = r_io.FeatureStore(str(root / "ref"), **kw_store)
        self.ts = t_io.FeatureStore(str(root / "port"), **kw_store)
        self.timed = engine in TIMED
        self.r = RefCache(self.rs, _hot(), dev_rows, host_rows,
                          ENGINES[engine](r_io, self.rs),
                          fused_backend="host", **kw)
        self.t = HeteroCache(self.ts, _hot(), dev_rows, host_rows,
                             ENGINES[engine](t_io, self.ts), device="cpu",
                             fused_backend=backend, **kw)
        self.caches = (self.r, self.t)

    def both(self, fn):
        a, b = fn(self.r), fn(self.t)
        assert values(b, self.timed) == values(a, self.timed)
        return a, b

    def gather(self, ids):
        a, b = self.r.gather(ids), self.t.gather(ids)
        assert isinstance(b, torch.Tensor)
        np.testing.assert_array_equal(b.numpy(), a)
        return np.array(a)

    def quiet(self):
        return not (self.r._inflight or self.t._inflight)

    def check(self):
        compare_caches(self.r, self.t, quiet=self.quiet(), timed=self.timed)

    def store_rows(self, ids):
        a, b = self.rs.read_rows(ids), self.ts.read_rows(ids)
        np.testing.assert_array_equal(b, a)
        return a

    def write(self, ids, rows, **kw):
        """``write_planned`` on both: (the reference's, the port's)."""
        out = self.both(lambda c: c.write_planned(ids, rows, **kw))
        self.check()
        return out

    def each(self, fn, handles):
        """``fn(cache, handle)`` for each cache and its own handle, the
        results held equal."""
        a, b = (fn(c, h) for c, h in zip(self.caches, handles))
        assert values(b, self.timed) == values(a, self.timed)
        return a, b

    def close(self):
        for c in self.caches:
            c.close()
            c.io.close()


@pytest.fixture()
def twin(tmp_path):
    made = []

    def make(engine="gids", backend="kernel", dev_rows=64, host_rows=128,
             **kw):
        made.append(Twin(tmp_path, engine, backend, dev_rows, host_rows,
                         **kw))
        return made[-1]
    yield make
    for tw in made:
        tw.close()


def _tier_ids(tw):
    return np.array([int(np.where(tw.r.loc == t)[0][0]) for t in (0, 1, 2)])


# ---------------------------------------------------------------------------
# read-your-writes, write-through, flush-on-demote (test_writeback.py:191-295)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("engine", ["helios", "gids", "cpu"])
def test_write_planned_read_your_writes_all_tiers(twin, engine, backend):
    tw = twin(engine, backend)
    ids = _tier_ids(tw)
    rows = _rows(np.random.default_rng(0), 3)
    res, _ = tw.write(ids, rows)
    assert (res.device_rows, res.host_rows, res.through_rows) == (1, 1, 1)
    np.testing.assert_array_equal(tw.gather(ids), rows)
    assert tw.r.n_dirty == tw.t.n_dirty == 2
    np.testing.assert_array_equal(tw.store_rows(ids[2:]), rows[2:])
    assert not np.array_equal(tw.store_rows(ids[:2]), rows[:2])
    fr, _ = tw.both(lambda c: c.flush())
    assert fr.rows == 2
    tw.check()
    np.testing.assert_array_equal(tw.store_rows(ids), rows)
    assert tw.both(lambda c: c.flush())[0].rows == 0
    tw.check()


@pytest.mark.parametrize("backend", BACKENDS)
def test_writethrough_keeps_storage_current(twin, backend):
    tw = twin("gids", backend, write_policy="writethrough")
    ids = _tier_ids(tw)
    rows = _rows(np.random.default_rng(1), 3)
    assert tw.write(ids, rows)[0].through_rows == 3
    assert tw.t.n_dirty == 0
    np.testing.assert_array_equal(tw.store_rows(ids), rows)
    np.testing.assert_array_equal(tw.gather(ids), rows)
    tw.check()


@pytest.mark.parametrize("backend", BACKENDS)
def test_refresh_flushes_dirty_demotions(twin, backend):
    tw = twin("gids", backend, 32, 64)
    cached = np.where(tw.r.loc < 2)[0]
    rows = _rows(np.random.default_rng(2), len(cached))
    tw.write(cached, rows)
    assert tw.t.n_dirty == len(cached)
    res, _ = tw.both(lambda c: c.refresh(np.arange(N_ROWS, dtype=float)))
    assert res.flushed == len(cached) and res.flush_virtual_s > 0
    tw.check()
    assert tw.t.n_dirty == 0
    np.testing.assert_array_equal(tw.store_rows(cached), rows)
    np.testing.assert_array_equal(tw.gather(cached), rows)
    st = tw.t.stats
    assert st.virtual_flush_s == pytest.approx(res.flush_virtual_s)
    assert st.virtual_migrate_s == pytest.approx(
        res.virtual_s - res.flush_virtual_s)
    tw.check()


@pytest.mark.parametrize("backend", BACKENDS)
def test_cache_write_stats_match_engine(twin, backend):
    tw = twin("helios", backend)
    rng = np.random.default_rng(3)
    for _ in range(3):
        ids = rng.integers(0, N_ROWS, 200)
        tw.write(ids, _rows(rng, 200))
    scores = rng.standard_normal(N_ROWS)
    tw.both(lambda c: c.refresh(scores))
    tw.check()
    tw.both(lambda c: c.flush())
    tw.check()
    for c in tw.caches:
        st = c.stats
        assert st.virtual_write_s + st.virtual_flush_s == pytest.approx(
            c.io.stats.virtual_write_s, abs=1e-12)
        assert st.written_rows > 0 and st.flushed_rows > 0
    tw.store_rows(np.arange(N_ROWS))


# ---------------------------------------------------------------------------
# split-phase prefetch (test_writeback.py:302-373)
# ---------------------------------------------------------------------------

def _hot_candidates(tw, k):
    cand = np.where(tw.r.loc == 2)[0][:k]
    for c in tw.caches:
        c.policy._scores[cand] = N_ROWS * 10.0
    return cand


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefetch_split_phase_and_dirty_victim_flush(twin, backend):
    tw = twin("gids", backend, 0, 64)
    victim = int(tw.r._host_ids[np.argmin(
        tw.r.policy.placement_scores()[tw.r._host_ids])])
    vrow = _rows(np.random.default_rng(4), 1)
    tw.write(np.array([victim]), vrow)
    cand = _hot_candidates(tw, 1)
    pp = tw.both(lambda c: c.prefetch_rows(cand, wait=False))
    assert isinstance(pp[1], PendingPrefetch)
    res = tw.each(lambda c, h: c.complete_prefetch(h), pp)
    assert res[0].rows == 1
    tw.check()
    assert tw.t.loc[cand[0]] == 1 and tw.t.loc[victim] == 2
    np.testing.assert_array_equal(tw.store_rows(np.array([victim])), vrow)
    np.testing.assert_array_equal(tw.gather(np.array([victim])), vrow)
    tw.check()


@pytest.mark.parametrize("backend", BACKENDS)
def test_pending_prefetch_dropped_when_write_lands_mid_flight(twin, backend):
    tw = twin("gids", backend, 0, 64)
    cand = _hot_candidates(tw, 1)
    pp = tw.both(lambda c: c.prefetch_rows(cand, wait=False))
    assert pp[0] is not None
    new = np.full((1, ROW_DIM), 7.0, np.float32)
    tw.write(cand, new)
    res = tw.each(lambda c, h: c.complete_prefetch(h), pp)
    assert res[0].rows == 0 and res[0].virtual_s > 0
    tw.check()
    np.testing.assert_array_equal(tw.gather(cand), new)
    np.testing.assert_array_equal(tw.store_rows(cand), new)
    tw.check()


@pytest.mark.parametrize("backend", BACKENDS)
def test_pending_prefetch_revalidates_after_refresh(twin, backend):
    tw = twin("gids", backend, 0, 64)
    cand = _hot_candidates(tw, 4)
    pp = tw.both(lambda c: c.prefetch_rows(cand, wait=False))
    assert pp[0] is not None
    scores = tw.r.policy.placement_scores()
    tw.both(lambda c: c.refresh(scores))
    assert (tw.t.loc[cand] == 1).all()
    tw.check()
    res = tw.each(lambda c, h: c.complete_prefetch(h), pp)
    assert res[0].rows == 0
    np.testing.assert_array_equal(np.sort(tw.t._host_ids),
                                  np.where(tw.t.loc == 1)[0])
    everything = np.arange(N_ROWS)
    np.testing.assert_array_equal(tw.gather(everything),
                                  tw.store_rows(everything))
    tw.check()


# ---------------------------------------------------------------------------
# apply_delta and the flush barrier (test_writeback.py:424-463)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_apply_delta_composes_and_sums_duplicates(twin, backend):
    tw = twin("gids", backend)
    ids = _tier_ids(tw)
    base = tw.gather(ids)
    one = np.ones((3, ROW_DIM), np.float32)
    for _ in range(2):
        tw.both(lambda c: c.apply_delta(ids, one))
        tw.check()
    np.testing.assert_array_equal(tw.gather(ids), base + 1 + 1)
    tw.both(lambda c: c.apply_delta(np.array([ids[0], ids[0]]),
                                    np.ones((2, ROW_DIM), np.float32)))
    np.testing.assert_array_equal(tw.gather(ids[:1]), base[:1] + 2 + 2)
    stale = tw.gather(ids)
    tw.both(lambda c: c.apply_delta(ids, one))
    tw.both(lambda c: c.apply_delta(ids, np.zeros_like(one)))
    np.testing.assert_array_equal(tw.gather(ids)[1:], stale[1:] + 1)
    tw.check()
    tw.both(lambda c: c.flush())
    tw.check()
    tw.store_rows(np.arange(N_ROWS))


@pytest.mark.parametrize("backend", BACKENDS)
def test_flush_barrier_runs_even_without_dirty_rows(twin, backend):
    tw = twin("gids", backend, 0, 0, write_policy="writethrough")
    tw.write(np.array([5]), np.full((1, ROW_DIM), 3.5, np.float32))
    assert tw.t.n_dirty == 0
    fr, _ = tw.both(lambda c: c.flush())
    assert fr.rows == 0 and tw.t.stats.flushes == 1
    tw.check()


# ---------------------------------------------------------------------------
# split-phase writes (test_writeback.py:475-563)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("engine", ["helios", "helios-legacy", "gids",
                                    "cpu"])
def test_write_planned_split_phase_read_your_writes(twin, engine, backend):
    """``wait=False`` leaves the storage ticket in flight, a gather just
    after still reads the written values, ``complete_write`` is
    idempotent, and the cache's write seconds equal the engine's."""
    tw = twin(engine, backend)
    rng = np.random.default_rng(7)
    for _ in range(4):
        ids = rng.integers(0, N_ROWS, 150)
        rows = _rows(rng, 150)
        pws = tw.write(ids, rows, wait=False)
        assert isinstance(pws[1], PendingWrite)
        ki, kr = keep_last(ids, rows)
        np.testing.assert_array_equal(tw.gather(ki), kr)
        res = tw.each(lambda c, h: c.complete_write(h), pws)
        assert res[0].virtual_s >= 0.0
        assert tw.t.complete_write(pws[1]) is res[1]
        tw.check()
    tw.both(lambda c: c.flush())
    tw.check()
    for c in tw.caches:
        st = c.stats
        assert st.virtual_write_s + st.virtual_flush_s == pytest.approx(
            c.io.stats.virtual_write_s, abs=1e-12)
    tw.store_rows(np.arange(N_ROWS))


@pytest.mark.parametrize("backend", BACKENDS)
def test_flush_completes_inflight_writes_before_durability(twin, backend):
    tw = twin("helios", backend, 0, 0)
    rng = np.random.default_rng(8)
    pws, shadow = [], {}
    for _ in range(5):
        ids = rng.integers(0, N_ROWS, 100)
        rows = _rows(rng, 100)
        pws.append(tw.write(ids, rows, wait=False))
        ki, kr = keep_last(ids, rows)
        shadow.update(zip(ki.tolist(), kr))
    tw.both(lambda c: c.flush())
    tw.check()
    sids = np.array(sorted(shadow))
    np.testing.assert_array_equal(tw.store_rows(sids),
                                  np.stack([shadow[i] for i in sids]))
    assert all(p.done for pair in pws for p in pair)


@pytest.mark.parametrize("backend", BACKENDS)
def test_split_phase_flush_version_revalidation(twin, backend):
    tw = twin("gids", backend, 32, 64)
    ids = np.array([int(np.where(tw.r.loc < 2)[0][0])])
    v1, v2 = _rows(np.random.default_rng(9), 2)
    tw.write(ids, v1[None])
    assert tw.t.n_dirty == 1
    efs = tw.both(lambda c: c.flush(wait=False))
    tw.write(ids, v2[None])
    tw.each(lambda c, h: c.flush_complete(h), efs)
    tw.check()
    assert tw.t.n_dirty == 1
    np.testing.assert_array_equal(tw.gather(ids), v2[None])
    fr, _ = tw.both(lambda c: c.flush())
    assert fr.rows == 1 and tw.t.n_dirty == 0
    np.testing.assert_array_equal(tw.store_rows(ids), v2[None])
    tw.check()


@pytest.mark.parametrize("backend", BACKENDS)
def test_apply_delta_split_phase(twin, backend):
    tw = twin("helios", backend)
    ids = _tier_ids(tw)
    base = tw.gather(ids)
    pws = tw.both(lambda c: c.apply_delta(
        ids, np.ones((3, ROW_DIM), np.float32), wait=False))
    np.testing.assert_array_equal(tw.gather(ids), base + 1)
    res = tw.each(lambda c, h: c.complete_write(h), pws)
    assert res[0].rows == 3
    tw.check()
    tw.both(lambda c: c.flush())
    tw.check()
    np.testing.assert_array_equal(tw.store_rows(ids), base + 1)


# ---------------------------------------------------------------------------
# the write combiner (test_writeback.py:589-683)
# ---------------------------------------------------------------------------

def _demote(tw, scores):
    out = tw.both(lambda c: c.refresh(scores))
    tw.check()
    return out[0]


@pytest.mark.parametrize("backend", BACKENDS)
def test_write_combined_demotions_one_ticket_and_overlay(twin, backend):
    tw = twin("gids", backend, 0, 64, write_combine_rows=256)
    cached = np.where(tw.r.loc == 1)[0]
    rows = _rows(np.random.default_rng(10), len(cached))
    tw.write(cached, rows)
    wb0 = tw.t.io.stats.write_batches
    _demote(tw, np.arange(N_ROWS, dtype=float))
    assert tw.t.io.stats.write_batches == wb0
    assert (tw.t.loc[cached] == 2).all()
    assert tw.t.n_dirty == len(cached) == len(tw.t._wc)
    np.testing.assert_array_equal(tw.gather(cached), rows)
    assert not np.array_equal(tw.store_rows(cached), rows)
    fr, _ = tw.both(lambda c: c.flush())
    assert fr.rows == len(cached)
    assert tw.t.io.stats.write_batches == wb0 + 1
    tw.check()
    np.testing.assert_array_equal(tw.store_rows(cached), rows)
    np.testing.assert_array_equal(tw.gather(cached), rows)


@pytest.mark.parametrize("backend", BACKENDS)
def test_write_combiner_threshold_triggers_combined_ticket(twin, backend):
    tw = twin("gids", backend, 0, 48, write_combine_rows=40)
    rng = np.random.default_rng(11)
    shadow = {}
    wb0 = tw.t.io.stats.write_batches
    for _ in range(3):
        hot = np.where(tw.r.loc == 1)[0][:16]
        rows = _rows(rng, len(hot))
        tw.write(hot, rows)
        shadow.update(zip(hot.tolist(), rows))
        scores = np.arange(N_ROWS, dtype=float)
        scores[hot] = -1.0
        _demote(tw, scores)
    assert tw.t.io.stats.write_batches == wb0 + 1
    assert len(tw.t._wc) == 0
    tw.both(lambda c: c.flush())
    tw.check()
    sids = np.array(sorted(shadow))
    np.testing.assert_array_equal(tw.store_rows(sids),
                                  np.stack([shadow[i] for i in sids]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_close_drains_write_combiner(twin, backend):
    tw = twin("gids", backend, 0, 32, write_combine_rows=512)
    cached = np.where(tw.r.loc == 1)[0]
    rows = _rows(np.random.default_rng(13), len(cached))
    tw.write(cached, rows)
    _demote(tw, np.arange(N_ROWS, dtype=float))
    assert tw.t.n_dirty == len(cached) == len(tw.t._wc)
    for c in tw.caches:
        c.close()
    compare_caches(tw.r, tw.t)
    np.testing.assert_array_equal(tw.store_rows(cached), rows)


@pytest.mark.parametrize("backend", BACKENDS)
def test_write_combined_row_promotion_stays_dirty(twin, backend):
    tw = twin("gids", backend, 0, 32, write_combine_rows=128)
    victim = int(tw.r._host_ids[0])
    row = _rows(np.random.default_rng(12), 1)
    tw.write(np.array([victim]), row)
    scores = np.arange(N_ROWS, dtype=float)
    scores[victim] = -1.0
    _demote(tw, scores)
    assert tw.t.loc[victim] == 2 and len(tw.t._wc) == 1
    scores[victim] = float(N_ROWS * 10)
    _demote(tw, scores)
    assert tw.t.loc[victim] == 1 and len(tw.t._wc) == 0
    np.testing.assert_array_equal(tw.gather(np.array([victim])), row)
    assert bool(tw.t.mut.is_dirty(np.array([victim]))[0])
    tw.both(lambda c: c.flush())
    tw.check()
    np.testing.assert_array_equal(tw.store_rows(np.array([victim])), row)
