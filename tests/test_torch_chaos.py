"""The port's fault-tolerant main path against the reference's, on the CPU:
the legs of ``tests/test_chaos.py`` that the cache, the flush journal and
the checkpoints run, each on both packages over identically seeded stores,
then the trainer and the server under injected faults.

What must be identical and what agrees within a tolerance:

  * gathered rows, journal actions and row counts, CacheStats, and the
    engines' retry, timeout, degraded and fatal counters: equal exactly;
  * engine virtual seconds: rel 1e-12 (worker threads sum them in
    completion order);
  * losses: rtol 1e-4, as ``tests/test_torch_train.py``; embedding rows
    after training: atol 1e-4 (the last bits of each step's gradients);
  * every trainer comparison runs at ``prefetch_depth=1``, where each
    package is deterministic (at 2, two batch threads share the sampler's
    rng and which samples first follows the threads).

A stored checkpoint, a journal and a torn store written by one package
are read by the other: the on-disk formats are the reference's.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ft_ref_compare import (PKGS, PORT, REF, host, no_wall,  # noqa: E402
                            run_trainer, train_raising)

N_ROWS, ROW_DIM, N_SHARDS = 4096, 16, 4
BOTH = pytest.mark.parametrize("pkg", list(PKGS), ids=list(PKGS))


def _store(pkg, path, writable=False, create=True, **kw):
    kw = dict(dict(n_rows=N_ROWS, row_dim=ROW_DIM, n_shards=N_SHARDS,
                   rng_seed=0), **kw)
    if not create:
        kw.pop("rng_seed")
    return PKGS[pkg].FeatureStore(str(path), create=create,
                                  writable=writable, **kw)


def _shard_bytes(path, n_shards=N_SHARDS):
    out = []
    for s in range(n_shards):
        with open(os.path.join(str(path), f"shard_{s}.bin"), "rb") as f:
            out.append(f.read())
    return out


def _io_equal(a, b):
    """Two engines' stats: every counter equal, virtual seconds to the
    last bit but for summation order."""
    va, vb = no_wall(a.stats._values()), no_wall(b.stats._values())
    assert va.keys() == vb.keys()
    for k in va:
        if isinstance(va[k], float):
            assert vb[k] == pytest.approx(va[k], rel=1e-12, abs=0.0), k
        else:
            assert vb[k] == va[k], k


# ---------------------------------------------------------------------------
# graceful degradation: a stuck shard is degraded and drops out of prefetch
# ---------------------------------------------------------------------------

def _degraded(pkg, path):
    p = PKGS[pkg]
    store = _store(pkg, path)
    eng = p.AsyncIOEngine(store, chaos=p.ChaosSchedule(
        seed=0, stuck=((2, 0, 10 ** 9),)),
        retry=p.RetryPolicy(deadline_s=1e-3, max_retries=3),
        degrade_after=3)
    cache = p.HeteroCache(store, device_rows=0, host_rows=256, io_engine=eng)
    shard2 = np.arange(2, N_ROWS, N_SHARDS)
    with pytest.raises(p.RetriesExhausted):
        eng.submit(shard2[:64]).wait()
    got = {"degraded": list(eng.degraded_shards()),
           "events": eng.stats.degraded_events}
    got["prefetch_stuck"] = cache.prefetch_rows(shard2[200:300])
    got["skipped"] = cache.stats.degraded_skipped_rows
    shard0 = np.arange(0, N_ROWS, N_SHARDS)
    res = cache.prefetch_rows(shard0[200:232])
    got["prefetch_other"] = (res.rows, res.tier) if res is not None else None
    got["skipped_after"] = cache.stats.degraded_skipped_rows
    got["host_tier"] = host(cache.host_tier).copy()
    got["cache"] = no_wall(cache.stats()._values())
    eng._fail_streak[2] = 0
    got["recovered"] = len(eng.degraded_shards())
    cache.close()
    return got, eng


def test_degraded_shard_suppresses_prefetch_in_both(tmp_path):
    """test_chaos.py:262 on both packages: a demand read of the stuck
    shard raises RetriesExhausted (not a hang), the shard is degraded, and
    a prefetch skips exactly its 100 rows; another shard's prefetch admits
    the same rows into the same host tier in both; the engines' retry,
    timeout, fatal and degraded counters are equal."""
    (r, r_eng), (t, t_eng) = (_degraded(k, tmp_path / k) for k in PKGS)
    for got in (r, t):
        assert got["degraded"] == [2] and got["events"] == 1
        assert got["prefetch_stuck"] is None
        assert got["skipped"] == got["skipped_after"] == 100
        assert got["recovered"] == 0
    assert t["prefetch_other"] == r["prefetch_other"]
    np.testing.assert_array_equal(t["host_tier"], r["host_tier"])
    assert t["cache"] == r["cache"]
    _io_equal(r_eng, t_eng)
    assert t_eng.stats.timeouts == 4 and t_eng.stats.fatal_errors == 1
    for e in (r_eng, t_eng):
        e.close()


@BOTH
def test_checkpoint_defers_degraded_shards(tmp_path, pkg):
    """test_chaos.py:290 on each package: ``save_embeddings(skip_shards=
    [1, 3])`` defers those shards, and a restore reads the base's bytes
    for them."""
    p = PKGS[pkg]
    wstore = _store(pkg, tmp_path / "w", writable=True)
    cm = p.CheckpointManager(str(tmp_path / "ckpt"), keep=4)
    vers = np.zeros(N_ROWS, np.int64)
    cm.save_embeddings(1, wstore, versions=vers)
    wstore.write_rows(np.arange(N_ROWS),
                      np.ones((N_ROWS, ROW_DIM), np.float32))
    wstore.flush()
    m = cm.save_embeddings(2, wstore, versions=vers + 1,
                           skip_shards=np.array([1, 3]))
    assert m["shards_deferred"] == [1, 3]
    assert m["shards_written"] == N_SHARDS - 2
    live = _store(pkg, tmp_path / "live", writable=True, rng_seed=None)
    out = cm.restore_embeddings(live, step=2)
    assert out["restored_step"] == 2
    got = live.read_rows(np.arange(N_ROWS))
    assert (got[np.arange(0, N_ROWS, N_SHARDS)] == 1.0).all()
    assert not (got[np.arange(1, N_ROWS, N_SHARDS)] == 1.0).all()


def _deferred_checkpoint(pkg, root):
    p = PKGS[pkg]
    wstore = _store(pkg, root / "w", writable=True)
    cm = p.CheckpointManager(str(root / "ckpt"), keep=4)
    vers = np.zeros(N_ROWS, np.int64)
    cm.save_embeddings(1, wstore, versions=vers)
    rows = np.random.default_rng(5).standard_normal(
        (N_ROWS, ROW_DIM)).astype(np.float32)
    wstore.write_rows(np.arange(N_ROWS), rows)
    wstore.flush()
    m = cm.save_embeddings(2, wstore, versions=vers + 1,
                           skip_shards=np.array([1, 3]))
    return m, str(root / "ckpt")


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_deferred_checkpoint_restores_across_packages(tmp_path, writer,
                                                      reader):
    """A checkpoint with deferred shards written by one package restores
    in the other to the bytes its writer restores (the deferred shards
    from the base step), and both packages write the same manifest."""
    m_w, ckpt = _deferred_checkpoint(writer, tmp_path / writer)
    m_r, _ = _deferred_checkpoint(reader, tmp_path / reader)
    keep = ("shards_deferred", "shards_written")
    assert {k: m_w[k] for k in keep} == {k: m_r[k] for k in keep}
    rows = {}
    for who in (writer, reader):
        live = _store(who, tmp_path / f"live_{who}", writable=True,
                      rng_seed=None)
        out = PKGS[who].CheckpointManager(ckpt).restore_embeddings(live,
                                                                   step=2)
        assert out["restored_step"] == 2
        rows[who] = live.read_rows(np.arange(N_ROWS))
    np.testing.assert_array_equal(rows[reader], rows[writer])


# ---------------------------------------------------------------------------
# crash-consistent flush: the write-intent journal and torn-write replay
# ---------------------------------------------------------------------------

@BOTH
def test_flush_journal_lifecycle(tmp_path, pkg):
    """test_chaos.py:344: no journal is left once a barrier completed."""
    p = PKGS[pkg]
    wstore = _store(pkg, tmp_path / "w", writable=True)
    c = p.HeteroCache(wstore, device_rows=0, host_rows=N_ROWS)
    assert c.journal_recovery == {"action": "none"}
    ids = np.arange(0, N_ROWS, 3)
    c.write_planned(ids, np.full((len(ids), ROW_DIM), 7.0, np.float32))
    c.flush()
    assert not os.path.exists(os.path.join(wstore.path, "flush.journal"))
    np.testing.assert_array_equal(wstore.read_rows(ids), 7.0)
    c.close()


def _torn_flush(pkg, path, device_rows=0):
    """test_chaos.py:355's crash: a torn write on the flush barrier raises
    SimulatedCrash after a prefix of the batch landed.  Returns the rows
    written."""
    p = PKGS[pkg]
    store = _store(pkg, path, writable=True)
    ids = np.arange(0, N_ROWS, 3)
    new = np.full((len(ids), ROW_DIM), 9.0, np.float32)
    new[:, 0] = ids
    eng = p.SyncIOEngine(store, chaos=p.ChaosSchedule(
        seed=0, torn_at=tuple((0, q) for q in range(64))))
    c = p.HeteroCache(store, device_rows=device_rows,
                      host_rows=N_ROWS - device_rows, io_engine=eng)
    # the port's cache takes the rows as a tensor (on a card: a card
    # tensor; ``test_torch_gpu.py`` runs that case)
    c.write_planned(ids, torch.from_numpy(new) if p is PORT else new)
    with pytest.raises(p.SimulatedCrash):
        c.flush()
    assert os.path.exists(os.path.join(store.path, "flush.journal"))
    return ids, new


@pytest.mark.parametrize("writer,replayer", [
    ("ref", "ref"), ("port", "port"), ("ref", "port"), ("port", "ref")])
def test_crash_mid_flush_replays_barrier(tmp_path, writer, replayer):
    """test_chaos.py:355, with the torn store written by one package and
    replayed by the other: both packages leave the same torn shards and
    the same journal bytes, and a new cache over the reopened store
    replays the barrier (``{"action": "replayed", "rows": n}``) before
    anything reads the torn rows.  The port's cache holds a device tier
    here too (its rows come from a tensor)."""
    torn = {}
    for who in (writer, replayer):
        root = tmp_path / who
        ids, new = _torn_flush(who, root / "t",
                               device_rows=64 if who == "port" else 0)
        with open(os.path.join(str(root / "t"), "flush.journal"), "rb") as f:
            torn[who] = (_shard_bytes(root / "t"), f.read())
    assert torn[writer] == torn[replayer]
    p = PKGS[replayer]
    store2 = _store(replayer, tmp_path / writer / "t", writable=True,
                    create=False)
    c2 = p.HeteroCache(store2, device_rows=0, host_rows=N_ROWS)
    assert c2.journal_recovery == {"action": "replayed", "rows": len(ids)}
    np.testing.assert_array_equal(store2.read_rows(ids), new)
    np.testing.assert_array_equal(host(c2.gather(ids)), new)
    assert not os.path.exists(os.path.join(store2.path, "flush.journal"))
    c2.close()


@pytest.mark.parametrize("writer,reader", [
    ("ref", "ref"), ("port", "port"), ("ref", "port"), ("port", "ref")])
def test_torn_journal_detected_and_discarded(tmp_path, writer, reader):
    """test_chaos.py:384: a journal truncated mid-payload is torn, and
    the reader's cache discards it and leaves the store as it was."""
    store = PKGS[reader].FeatureStore(str(tmp_path / "t"), n_rows=256,
                                      row_dim=8, n_shards=2, create=True,
                                      rng_seed=0, writable=True)
    before = store.read_rows(np.arange(256))
    j = PKGS[writer].FlushJournal(store.path)
    j.record(np.arange(10), np.ones((10, 8), np.float32))
    path = os.path.join(store.path, "flush.journal")
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:len(blob) - 17])
    assert PKGS[reader].FlushJournal(store.path).pending()[0] == "torn"
    c = PKGS[reader].HeteroCache(store, device_rows=0, host_rows=64)
    assert c.journal_recovery == {"action": "discarded"}
    np.testing.assert_array_equal(store.read_rows(np.arange(256)), before)
    assert not os.path.exists(path)
    c.close()


@BOTH
def test_journal_bitflip_detected(tmp_path, pkg):
    """test_chaos.py:402: a flipped bit fails the journal's crc."""
    p = PKGS[pkg]
    store = p.FeatureStore(str(tmp_path / "t"), n_rows=256, row_dim=8,
                           n_shards=2, create=True, rng_seed=0,
                           writable=True)
    j = p.FlushJournal(store.path)
    j.record(np.arange(10), np.ones((10, 8), np.float32))
    path = os.path.join(store.path, "flush.journal")
    blob = bytearray(open(path, "rb").read())
    blob[-5] ^= 0x40
    open(path, "wb").write(bytes(blob))
    assert j.pending()[0] == "torn"
    assert j.recover(store) == {"action": "discarded"}


@BOTH
def test_stale_journal_removed_on_create(tmp_path, pkg):
    """test_chaos.py:415: re-creating a store drops an old intent."""
    p = PKGS[pkg]
    store = p.FeatureStore(str(tmp_path / "t"), n_rows=64, row_dim=4,
                           n_shards=2, create=True, writable=True)
    p.FlushJournal(store.path).record(np.arange(4),
                                      np.ones((4, 4), np.float32))
    del store
    store2 = p.FeatureStore(str(tmp_path / "t"), n_rows=64, row_dim=4,
                            n_shards=2, create=True, writable=True)
    assert not os.path.exists(os.path.join(store2.path, "flush.journal"))


# ---------------------------------------------------------------------------
# checkpoint corruption fallback
# ---------------------------------------------------------------------------

def _corrupt_chain(pkg, root):
    p = PKGS[pkg]
    wstore = _store(pkg, root / "w", writable=True)
    cm = p.CheckpointManager(str(root / "ckpt"), keep=5)
    for step in (1, 2, 3):
        wstore.write_rows(np.arange(N_ROWS),
                          np.full((N_ROWS, ROW_DIM), float(step),
                                  np.float32))
        wstore.flush()
        cm.save_embeddings(step, wstore)
    p3 = os.path.join(str(root / "ckpt"), f"emb_{3:010d}", "table",
                      "shard_2.bin")
    blob = bytearray(open(p3, "rb").read())
    blob[100] ^= 0x01
    open(p3, "wb").write(bytes(blob))
    m2 = os.path.join(str(root / "ckpt"), f"emb_{2:010d}", "manifest.json")
    open(m2, "w").write("{not json")
    return str(root / "ckpt")


@pytest.mark.parametrize("writer,reader", [
    ("ref", "ref"), ("port", "port"), ("ref", "port"), ("port", "ref")])
def test_restore_falls_back_past_corrupt_manifest(tmp_path, writer, reader):
    """test_chaos.py:431: a corrupt newest shard and a corrupt mid-chain
    manifest make restore walk back to step 1 and report both skips, in
    either package, whichever wrote the chain; the reports name the same
    steps and reasons."""
    ckpt = _corrupt_chain(writer, tmp_path)
    live = _store(reader, tmp_path / "live", writable=True, rng_seed=None)
    out = PKGS[reader].CheckpointManager(ckpt).restore_embeddings(live)
    assert out["restored_step"] == 1
    assert [s["step"] for s in out["skipped"]] == [3, 2]
    assert (live.read_rows(np.arange(N_ROWS)) == 1.0).all()
    if writer != reader:
        live2 = _store(writer, tmp_path / "live2", writable=True,
                       rng_seed=None)
        want = PKGS[writer].CheckpointManager(ckpt).restore_embeddings(live2)
        assert json.dumps(out["skipped"], sort_keys=True, default=str) == \
            json.dumps(want["skipped"], sort_keys=True, default=str)


@BOTH
def test_restore_all_corrupt_raises_with_report(tmp_path, pkg):
    """test_chaos.py:460: a missing shard file with no older checkpoint
    raises an IOError that names the step."""
    p = PKGS[pkg]
    wstore = _store(pkg, tmp_path / "w", writable=True)
    cm = p.CheckpointManager(str(tmp_path / "ckpt"), keep=5)
    cm.save_embeddings(1, wstore)
    os.remove(os.path.join(str(tmp_path / "ckpt"), f"emb_{1:010d}",
                           "table", "shard_0.bin"))
    live = _store(pkg, tmp_path / "live", writable=True, rng_seed=None)
    with pytest.raises(IOError, match="step 1"):
        cm.restore_embeddings(live)


@BOTH
def test_restore_geometry_mismatch_still_raises(tmp_path, pkg):
    """test_chaos.py:473: a store of another geometry is the caller's
    error; no fallback masks it."""
    p = PKGS[pkg]
    wstore = _store(pkg, tmp_path / "w", writable=True)
    cm = p.CheckpointManager(str(tmp_path / "ckpt"), keep=5)
    cm.save_embeddings(1, wstore)
    other = p.FeatureStore(str(tmp_path / "other"), n_rows=N_ROWS,
                           row_dim=ROW_DIM + 1, n_shards=N_SHARDS,
                           create=True, writable=True)
    with pytest.raises(ValueError, match="geometry"):
        cm.restore_embeddings(other)


# ---------------------------------------------------------------------------
# e2e: the cache's gathers under chaos stay bit-identical
# ---------------------------------------------------------------------------

def _chaos_gathers(pkg, store, batches, chaos):
    p = PKGS[pkg]
    eng = (p.AsyncIOEngine(store, chaos=None) if not chaos else
           p.AsyncIOEngine(store, chaos=p.ChaosSchedule(
               seed=7, read_error_rate=0.02, stuck=((1, 3, 6),)),
               retry=p.RetryPolicy(deadline_s=5e-3)))
    cache = p.HeteroCache(store, device_rows=128, host_rows=512,
                          io_engine=eng)
    got = [host(cache.gather(b)).copy() for b in batches]
    stats = no_wall(cache.stats()._values())
    cache.close()
    eng.close()
    return got, stats, eng


def test_cache_gathers_bit_identical_under_chaos(tmp_path):
    """test_chaos.py:489: twelve 512-id gathers under ``ChaosSchedule(
    seed=7, read_error_rate=0.02, stuck=((1, 3, 6),))`` are bit-identical
    to the clean run, in both packages, with retries above 0; the two
    packages' CacheStats and retry, timeout and error counters are
    equal, and their engines' virtual seconds within rel 1e-12."""
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, N_ROWS, 512) for _ in range(12)]
    runs = {}
    for k in PKGS:
        store = _store(k, tmp_path / k)
        runs[k] = (_chaos_gathers(k, store, batches, False),
                   _chaos_gathers(k, store, batches, True))
    want = runs["ref"][0][0]
    for k, (clean, chaotic) in runs.items():
        for w, a, b in zip(want, clean[0], chaotic[0]):
            np.testing.assert_array_equal(a, w)
            np.testing.assert_array_equal(b, w)
        assert chaotic[2].stats.retries > 0, k
        assert chaotic[2].stats.timeouts > 0, k
    assert runs["port"][1][1] == runs["ref"][1][1]
    _io_equal(runs["ref"][1][2], runs["port"][1][2])


# ---------------------------------------------------------------------------
# the trainer under injected faults
# ---------------------------------------------------------------------------

N_V, FEAT = 2000, 16
TRAIN = dict(batch_size=32, fanouts=(4, 3), hidden=16, presample_batches=2,
             seed=0, mode="helios", prefetch_depth=1)
CHAOS_ENV = "seed=7,read_error_rate=0.05"


@pytest.fixture(scope="module")
def graphs():
    return {k: p.synth_graph(N_V, 8, skew=1.0, seed=0)
            for k, p in PKGS.items()}


def _fstore(pkg, path, writable=False, create=True):
    kw = dict(n_shards=4, writable=writable, create=create)
    if create:
        kw["rng_seed"] = 3
    return PKGS[pkg].FeatureStore(str(path), N_V, FEAT, **kw)


def _trainer_pair(tmp_path, graphs, n_batches, tag="", writable=False,
                  **cfg):
    r = run_trainer(REF, graphs["ref"], _fstore("ref", tmp_path / f"r{tag}",
                                                writable), n_batches, **cfg)
    t = run_trainer(PORT, graphs["port"],
                    _fstore("port", tmp_path / f"p{tag}", writable),
                    n_batches, params_np=r[3], **cfg)
    return r, t


def _assert_runs_match(r, t):
    (rout, rloss, rseen, _, rseq), (tout, tloss, tseen, _, tseq) = r, t
    for k in ("nodes", "src", "rows"):
        assert len(tseen[k]) == len(rseen[k])
        for a, b in zip(rseen[k], tseen[k]):
            np.testing.assert_array_equal(a, b)
    assert tout["cache"] == rout["cache"]
    ri, ti = dict(rout["io"]), dict(tout["io"])
    assert ti.pop("virtual_s") == pytest.approx(ri.pop("virtual_s"),
                                                rel=1e-12)
    assert ti == ri
    assert tout["virtual_s"] == pytest.approx(rout["virtual_s"], rel=1e-12)
    np.testing.assert_allclose(tloss, rloss, rtol=1e-4)
    assert tseq == rseq


def test_trainer_under_helios_chaos_matches_reference(tmp_path, graphs,
                                                      monkeypatch):
    """``OutOfCoreGNNTrainer.train`` in ``helios`` with ``HELIOS_CHAOS``
    set (``chaos="env"``, the default): both packages sample the same
    batches, gather the same rows (equal to the clean run's), keep equal
    CacheStats and IO counters (retries above 0), spend the same seeds of
    the fault schedule on every stream, and lose within rtol 1e-4."""
    monkeypatch.delenv("HELIOS_CHAOS", raising=False)
    clean = run_trainer(PORT, graphs["port"], _fstore("port",
                                                      tmp_path / "clean"),
                        6, **TRAIN)
    monkeypatch.setenv("HELIOS_CHAOS", CHAOS_ENV)
    r, t = _trainer_pair(tmp_path, graphs, 6, **TRAIN)
    _assert_runs_match(r, t)
    assert t[0]["io"]["retries"] > 0 and t[0]["io"]["transient_errors"] > 0
    assert clean[0]["io"]["retries"] == 0
    for a, b in zip(clean[2]["rows"], t[2]["rows"]):
        np.testing.assert_array_equal(a, b)
    assert t[0]["cache"] == clean[0]["cache"]


EMB = dict(TRAIN, train_embeddings=True, embedding_lr=0.05)


def test_trainer_torn_epoch_flush_replays(tmp_path, graphs):
    """Trainable embeddings with the epoch flush torn on stream 0: a
    clean pilot run of each package counts the service operations on every
    stream (the same in both); the flush is the last one, so
    ``torn_at=((0, n0 - 1),)`` tears exactly it.  ``train`` raises
    SimulatedCrash in both packages; a new trainer on the reopened store
    replays the journal (the same action and row count in both), the
    replayed rows are the clean run's exactly, in each package, and within
    atol 1e-4 of the reference's; then one more batch trains."""
    pilot, start = {}, None
    for k, p in PKGS.items():
        pilot[k] = run_trainer(p, graphs[k], _fstore(k, tmp_path / f"c{k}",
                                                     True), 5,
                               params_np=start,
                               chaos=p.ChaosSchedule(seed=7), **EMB)
        start = pilot["ref"][3]
    assert pilot["port"][4] == pilot["ref"][4]
    n0 = pilot["ref"][4][0]
    assert n0 > 0
    got = {}
    for k, p in PKGS.items():
        path = tmp_path / f"t{k}"
        kind, in_time, left = train_raising(
            p, graphs[k], _fstore(k, path, True), 5, 120,
            params_np=None if p is REF else start,
            chaos=p.ChaosSchedule(seed=7, torn_at=((0, n0 - 1),)), **EMB)
        assert in_time and kind is p.SimulatedCrash, (k, kind)
        assert p is REF or left == []
        assert os.path.exists(os.path.join(str(path), "flush.journal"))
        with p.Trainer(graphs[k], _fstore(k, path, True, create=False),
                       p.TrainerConfig(**dict(EMB, chaos=None))) as tr:
            got[k] = tr.cache.journal_recovery
            rows = tr.store.read_rows(np.arange(N_V))
            clean = _fstore(k, tmp_path / f"c{k}", create=False)
            np.testing.assert_array_equal(rows, clean.read_rows(
                np.arange(N_V)))
            out = tr.train(1)
            assert np.isfinite(out["loss_last"])
        got[k + "_rows"] = rows
    assert got["port"] == got["ref"]
    assert got["port"]["action"] == "replayed" and got["port"]["rows"] > 0
    np.testing.assert_allclose(got["port_rows"], got["ref_rows"], atol=1e-4)


@pytest.mark.parametrize("depth", [1, 2])
def test_trainer_fatal_demand_fault_raises_and_closes(tmp_path, graphs,
                                                      depth):
    """A fatal fault on the second demand read of stream 0 surfaces from
    ``train`` as FatalIOError in both packages within 120 s.  The port's
    trainer then leaves no thread running once ``with`` has exited: at
    ``prefetch_depth=2`` the other batch in flight settles before the
    engines close.  The reference runs at depth 1 only: at 2 its other
    batch can wait forever on a ticket of the closed engine (ROADMAP,
    what the port showed about the reference)."""
    left = {}
    for k, p in PKGS.items():
        kind, in_time, left[k] = train_raising(
            p, graphs[k], _fstore(k, tmp_path / k), 6, 120,
            chaos=p.ChaosSchedule(seed=0, fatal_at=((0, 1),)),
            **dict(TRAIN, prefetch_depth=depth if p is PORT else 1))
        assert in_time, k
        assert kind is p.FatalIOError, (k, kind)
    assert left["port"] == []


def test_trainer_stuck_shard_with_deadline_matches_reference(tmp_path,
                                                             graphs):
    """A stuck window on stream 1 under a 5 ms deadline (the chip phase's
    schedule): both packages time out, retry and recover with equal
    counters; the gathered rows are the same and the losses agree."""
    kw = dict(TRAIN, io_deadline_s=5e-3)
    r, t = _trainer_pair(tmp_path, graphs, 6, chaos=None, **kw)
    rc, tc = (run_trainer(p, graphs[k], _fstore(k, tmp_path / f"{k}s"), 6,
                          params_np=None if p is REF else r[3],
                          chaos=p.ChaosSchedule(seed=7, read_error_rate=0.02,
                                                stuck=((1, 3, 6),)), **kw)
              for k, p in PKGS.items())
    _assert_runs_match(rc, tc)
    assert tc[0]["io"]["timeouts"] > 0 and tc[0]["io"]["retries"] > 0
    for a, b in zip(t[2]["rows"], tc[2]["rows"]):
        np.testing.assert_array_equal(a, b)
    _assert_runs_match(r, t)


# ---------------------------------------------------------------------------
# the server under injected faults
# ---------------------------------------------------------------------------

SERVE = dict(model="sage", mode="helios", request_batch_size=8,
             fanouts=(4, 3), hidden=16, device_cache_frac=0.05,
             host_cache_frac=0.1, max_batch_requests=4, seed=0)


def _serve(pkg, graph, store, wl, params=None, **cfg):
    p = PKGS[pkg]
    kw = {} if params is None else {"params": params}
    with p.Server(graph, store, p.ServerConfig(**SERVE, **cfg), **kw) as srv:
        futs = [srv.submit(s, k, t) for s, t, k in wl]
        st = srv.flush()
        res = [f.result() for f in futs]
        return st, res, dict(srv.io.stats._values()), srv.params


def test_server_under_helios_chaos(tmp_path, graphs, monkeypatch):
    """``GNNInferenceServer`` under ``HELIOS_CHAOS``: each package answers
    the same requests as its clean run with the same logits (rtol 1e-5),
    retries above 0; the port's answers, virtual latencies and retry
    counters under chaos equal the reference's."""
    from repro_torch.gnn.models import params_from_numpy
    from ft_ref_compare import np_tree
    wl = {k: p.zipf_workload(N_V, 24, 8, rate_rps=2_000,
                             degrees=graphs[k].degrees(), seed=1)
          for k, p in PKGS.items()}
    out = {}
    params = None
    for chaos in (False, True):
        if chaos:
            monkeypatch.setenv("HELIOS_CHAOS", CHAOS_ENV)
        else:
            monkeypatch.delenv("HELIOS_CHAOS", raising=False)
        for k in PKGS:
            store = _fstore(k, tmp_path / f"{k}{chaos}")
            out[k, chaos] = _serve(k, graphs[k], store, wl[k],
                                   params=(params_from_numpy(params, "cpu")
                                           if k == "port" else None))
            if k == "ref" and params is None:
                params = np_tree(out[k, chaos][3])
    for k in PKGS:
        (sc, rc, ioc, _), (sx, rx, iox, _) = out[k, False], out[k, True]
        assert sc.served == sx.served == len(wl[k]), k
        assert ioc["retries"] == 0 and iox["retries"] > 0, k
        for a, b in zip(rc, rx):
            np.testing.assert_allclose(b["logits"], a["logits"], rtol=1e-5,
                                       atol=1e-6)
    (sr, rr, ior, _), (st, rt, iot, _) = out["ref", True], out["port", True]
    assert (st.served, st.rejected_total, st.batches) == \
        (sr.served, sr.rejected_total, sr.batches)
    assert st.storage_rows_issued == sr.storage_rows_issued
    for k in ("retries", "transient_errors", "timeouts", "fatal_errors"):
        assert iot[k] == ior[k], k
    for a, b in zip(rr, rt):
        assert b["latency_v"] == pytest.approx(a["latency_v"], rel=1e-12)
        np.testing.assert_allclose(b["logits"], np.asarray(a["logits"]),
                                   rtol=1e-5, atol=1e-5)
