"""The port's congestion control against the reference's, on the CPU: the
stream-class scheduler and back-pressure legs of ``tests/test_congestion.py``
on each package, the cache shedding prefetch while the engine is throttled
held against the reference exactly, and the trainer with a demand-queue
watermark set.

Equal exactly: shed and skipped row counts, gathered rows, CacheStats and
the engines' per-class counters; engine virtual seconds within rel 1e-12.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ft_ref_compare import (PKGS, REF, host, no_wall,  # noqa: E402
                            run_trainer)

BOTH = pytest.mark.parametrize("pkg", list(PKGS), ids=list(PKGS))
TAG_CLASS = {"": "DEMAND", "prefetch": "PREFETCH", "flush": "WRITEBACK",
             "ckpt": "CHECKPOINT", "refresh": "PREFETCH"}


def _store(pkg, path):
    return PKGS[pkg].FeatureStore(str(path), n_rows=96, row_dim=4,
                                  n_shards=3, create=True, rng_seed=11)


def _storm(p, eng, rng, n=30):
    """30 demand batches all arriving at virtual t=0 on a paused engine."""
    eng.pause()
    storm = [eng.submit(rng.integers(0, 96, 32), v_submit=0.0)
             for _ in range(n)]
    eng.resume()
    for tk in storm:
        tk.wait()


@BOTH
def test_tag_class_mapping(pkg):
    """test_congestion.py:83: tags infer their stream class."""
    from importlib import import_module
    io = import_module(("repro" if pkg == "ref" else "repro_torch")
                       + ".core.iostack")
    for tag, name in TAG_CLASS.items():
        assert io.stream_class_of(tag, None) is io.StreamClass[name]
    assert io.stream_class_of("remote", None) is \
        io.StreamClass.REMOTE_DEMAND
    assert io.stream_class_of("prefetch", io.StreamClass.DEMAND) is \
        io.StreamClass.DEMAND
    assert all(c not in io.DEFAULT_CLASS_WEIGHTS for c in io.STRICT_CLASSES)


def _staged(pkg, path, sched):
    p = PKGS[pkg]
    eng = p.AsyncIOEngine(_store(pkg, path), sched=sched, sched_log=True,
                          chaos=None)
    rng = np.random.default_rng(3)
    try:
        eng.pause()
        pf = [eng.submit(rng.integers(0, 96, 32), tag="prefetch",
                         v_submit=0.0) for _ in range(40)]
        dem = eng.submit(rng.integers(0, 96, 16), v_submit=0.0)
        eng.resume()
        for tk in pf:
            tk.wait()
        dem.wait()
        return sorted(v0 - vs for _, c, _, vs, v0, _, _ in eng.sched_events
                      if c == "DEMAND")
    finally:
        eng.close()


def test_prefetch_storm_cannot_starve_demand(tmp_path):
    """test_congestion.py:181 on both packages: under wfq the demand batch
    queued behind 40 prefetch batches waits 0 on every shard, under fifo
    it waits out the storm; the packages' queue delays are equal."""
    got = {(k, s): _staged(k, tmp_path / f"{k}{s}", s)
           for k in PKGS for s in ("wfq", "fifo")}
    for k in PKGS:
        assert got[k, "wfq"] and max(got[k, "wfq"]) == 0.0
        assert min(got[k, "fifo"]) > 0.0
    for s in ("wfq", "fifo"):
        np.testing.assert_allclose(got["port", s], got["ref", s],
                                   rtol=1e-12, atol=0.0)


@BOTH
def test_backpressure_hysteresis(tmp_path, pkg):
    """test_congestion.py:193: a demand storm past the watermark throttles
    the bulk classes only; a quiet window releases it."""
    p = PKGS[pkg]
    eng = p.AsyncIOEngine(_store(pkg, tmp_path / "s"), sched="wfq",
                          qwait_high_s=1e-6, chaos=None)
    rng = np.random.default_rng(5)
    S = p.StreamClass
    try:
        _storm(p, eng, rng)
        assert eng.throttled(S.PREFETCH) and eng.throttled(S.CHECKPOINT)
        assert not eng.throttled(S.DEMAND)
        assert not eng.throttled(S.WRITEBACK)
        s = eng.stats.snapshot()
        assert s.throttle_engaged >= 1 and s.throttle_released == 0
        for j in range(25):
            eng.submit(rng.integers(0, 96, 8), v_submit=1.0 + j).wait()
        assert not eng.throttled(S.PREFETCH)
        assert eng.stats.snapshot().throttle_released >= 1
        summ = eng.qwait_summary()
        assert summ["DEMAND"]["count"] > 0 and summ["DEMAND"]["max"] > 0.0
    finally:
        eng.close()


@BOTH
def test_throttled_default_off(tmp_path, pkg):
    """test_congestion.py:228: no watermark, never throttled."""
    p = PKGS[pkg]
    store = _store(pkg, tmp_path / "s")
    for eng in (p.SyncIOEngine(store), p.AsyncIOEngine(store),
                p.AsyncIOEngine(store, striped=False)):
        assert not eng.throttled(p.StreamClass.PREFETCH)
        assert not eng.throttled(p.StreamClass.DEMAND)
        eng.close()


def _shed(pkg, path, fused):
    p = PKGS[pkg]
    store = _store(pkg, path)
    eng = p.AsyncIOEngine(store, sched="wfq", qwait_high_s=1e-9, chaos=None)
    rng = np.random.default_rng(9)
    try:
        cache = p.HeteroCache(store, None, 0, 24, eng, fused=fused)
        cache.policy._scores[:48] = 1.0
        _storm(p, eng, rng)
        throttled = eng.throttled(p.StreamClass.PREFETCH)
        res = cache.prefetch_rows(np.arange(24, 48))
        ids = rng.integers(0, 96, 40)
        rows = host(cache.gather(ids)).copy()
        want = store.read_rows(ids)
        stats = no_wall(cache.stats()._values())
        cache.close()
        return (throttled, res, rows, want, stats,
                no_wall(eng.stats._values()), eng.stats.by_class)
    finally:
        eng.close()


@pytest.mark.parametrize("fused", [False, True], ids=["plan", "fused"])
def test_cache_sheds_prefetch_while_throttled(tmp_path, fused):
    """test_congestion.py:236 on both packages: while the engine is
    throttled ``prefetch_rows`` refuses admission and counts the 24 shed
    rows, demand gathers stay byte-identical to the store; the packages'
    CacheStats and engine counters are equal (the fused leg runs the
    port's K1 plain version against the reference's host lookup)."""
    got = {k: _shed(k, tmp_path / k, fused) for k in PKGS}
    for k, (thr, res, rows, want, stats, _, _) in got.items():
        assert thr and res is None, k
        assert stats["throttled_skipped_rows"] == 24, k
        np.testing.assert_array_equal(rows, want)
    r, t = got["ref"], got["port"]
    np.testing.assert_array_equal(t[2], r[2])
    assert t[4] == r[4]
    for k in r[5]:
        if isinstance(r[5][k], float):
            assert t[5][k] == pytest.approx(r[5][k], rel=1e-12, abs=0.0), k
        else:
            assert t[5][k] == r[5][k], k
    assert t[6].keys() == r[6].keys()
    for c in r[6]:
        for k, v in r[6][c].items():
            assert t[6][c][k] == pytest.approx(v, rel=1e-12, abs=0.0), (c, k)


def test_trainer_with_watermark_matches_reference(tmp_path):
    """The trainer with ``io_qwait_high_s`` set, an online policy and the
    prefetch operator on, at ``prefetch_depth=1``: both packages sample,
    gather, prefetch and count alike.  The cache submits its tickets with
    no virtual arrival time, so the watermark never engages in either
    package (ROADMAP, what the port showed about the reference); the
    prefetch rows are admitted, not shed."""
    graphs = {k: p.synth_graph(2000, 8, skew=1.0, seed=0)
              for k, p in PKGS.items()}
    cfg = dict(batch_size=32, fanouts=(4, 3), hidden=16, presample_batches=2,
               seed=0, mode="helios", prefetch_depth=1, chaos=None,
               io_qwait_high_s=1e-9, cache_policy="online", prefetch_rows=16)
    runs = {}
    for k, p in PKGS.items():
        store = p.FeatureStore(str(tmp_path / k), 2000, 16, n_shards=4,
                               create=True, rng_seed=3)
        runs[k] = run_trainer(p, graphs[k], store, 6,
                              params_np=None if p is REF else runs["ref"][3],
                              **cfg)
    (rout, rloss, rseen, _, _), (tout, tloss, tseen, _, _) = (runs["ref"],
                                                              runs["port"])
    for a, b in zip(rseen["rows"], tseen["rows"]):
        np.testing.assert_array_equal(a, b)
    assert tout["cache"] == rout["cache"]
    assert tout["cache"]["prefetched_rows"] > 0
    ri, ti = dict(rout["io"]), dict(tout["io"])
    assert ti.pop("virtual_s") == pytest.approx(ri.pop("virtual_s"),
                                                rel=1e-12)
    for c in ri["by_class"]:
        for key, v in ri["by_class"][c].items():
            assert ti["by_class"][c][key] == pytest.approx(v, rel=1e-12), \
                (c, key)
    ri.pop("by_class"), ti.pop("by_class")
    assert ti == ri
    assert ti["throttle_engaged"] == 0 and ti["throttled_skipped_rows"] == 0
    np.testing.assert_allclose(tloss, rloss, rtol=1e-4)
