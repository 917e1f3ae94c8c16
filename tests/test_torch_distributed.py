"""The port's scale-out subsystem against the reference package's.

Partitioning, the partitioned store, the remote IO engine (reads, owner
writes, the dead-peer reroute), the cache's remote tier, the serving fleet,
the failure coordinator and int8 gradient compression.  Each case runs
``repro`` and ``repro_torch`` on the same inputs, made with numpy from a
seed, at the sizes of ``tests/test_distributed.py``: rows, ownership maps,
engine counters, cache stats and virtual seconds are identical; fleet
logits agree within 1e-5, compression's scales and round trips within
1e-7 relative and its error-feedback trees within 1e-6.  The port's cache
and fleet run on the CPU (``device="cpu"``), the K1 kernel as its plain
version.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.hetero_cache import HeteroCache as RefCache  # noqa: E402
from repro.core.iostack import AsyncIOEngine as RefAsync  # noqa: E402
from repro.core.iostack import CompletionQueue as RefCQ  # noqa: E402
from repro.core.iostack import FeatureStore as RefStore  # noqa: E402
from repro.distributed import partition as ref_part  # noqa: E402
from repro.distributed.remote_engine import \
    RemoteIOEngine as RefRemote  # noqa: E402
from repro.ft import failures as ref_ft  # noqa: E402
from repro_torch.core.hetero_cache import HeteroCache  # noqa: E402
from repro_torch.core.iostack import (AsyncIOEngine,  # noqa: E402
                                      CompletionQueue, FeatureStore)
from repro_torch.distributed import partition as part  # noqa: E402
from repro_torch.distributed.remote_engine import \
    RemoteIOEngine  # noqa: E402
from repro_torch.ft import failures as ft  # noqa: E402

N_ROWS, ROW_DIM, SEED = 256, 8, 11

# (port module/class, reference module/class) pairs, port first
PKGS = dict(store=(FeatureStore, RefStore), engine=(AsyncIOEngine, RefAsync),
            remote=(RemoteIOEngine, RefRemote), cache=(HeteroCache, RefCache),
            part=(part, ref_part), cq=(CompletionQueue, RefCQ),
            ft=(ft, ref_ft))
CACHE_PATHS = {     # port kwargs, reference kwargs
    "kernel": (dict(fused=True), dict(fused=True, fused_backend="host")),
    "host": (dict(fused=True, fused_backend="host"),
             dict(fused=True, fused_backend="host")),
    "plan": (dict(fused=False), dict(fused=False)),
}


def _side(k: int) -> dict:
    """The classes and modules of one package: 0 the port, 1 the
    reference."""
    return {name: pair[k] for name, pair in PKGS.items()}


def _pstores(root, n_workers, writable=False, kind="hash"):
    out = []
    for k, tag in ((0, "port"), (1, "ref")):
        p = _side(k)["part"]
        out.append(p.PartitionedFeatureStore(
            os.path.join(root, tag), N_ROWS, ROW_DIM,
            p.make_partition(kind, N_ROWS, n_workers), n_shards=2,
            create=True, rng_seed=SEED, writable=writable))
    return out


def _engine_counters(eng) -> tuple:
    """The engine's row counters, exact, and its network seconds: a sum
    its worker threads book in completion order, so two runs may round it
    differently in the last bit (the reference against itself too)."""
    return (eng.local_rows, eng.remote_rows, eng.rerouted_rows,
            eng.rerouted_batches, pytest.approx(eng.virtual_net_s,
                                                rel=1e-12, abs=0))


def _no_wall(values: dict) -> dict:
    return {k: v for k, v in values.items() if not k.startswith("wall")}


def _io_stats_equal(a, b):
    """Engine stats: counts exact; virtual seconds summed over tickets in
    completion order (the storage and remote legs of one gather land in
    either order) to the last bit."""
    va, vb = _no_wall(a.stats._values()), _no_wall(b.stats._values())
    assert va.keys() == vb.keys()
    for k in va:
        if isinstance(va[k], float):
            assert va[k] == pytest.approx(vb[k], rel=1e-12, abs=0), k
        else:
            assert va[k] == vb[k], k


# ---------------------------------------------------------------------------
# ownership maps and the partitioned store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["hash4", "hash4-seed1", "resize4to5",
                                  "degree4", "degree3-uniform"])
def test_ownership_maps_identical(case):
    rng = np.random.default_rng(0)
    deg = np.minimum(rng.zipf(1.5, N_ROWS), 64).astype(np.float64)
    maps = []
    for p in (part, ref_part):
        if case == "hash4":
            m = [p.make_partition("hash", N_ROWS, 4)]
        elif case == "hash4-seed1":
            m = [p.ConsistentHashPartition(N_ROWS, 4, n_vnodes=16, seed=1)]
        elif case == "resize4to5":
            m = [p.ConsistentHashPartition(N_ROWS, w, seed=1) for w in (4, 5)]
        elif case == "degree4":
            m = [p.make_partition("degree", N_ROWS, 4, degrees=deg)]
        else:
            m = [p.DegreeBalancedPartition(np.ones(N_ROWS), 3)]
        maps.append(m)
    for a, b in zip(*maps):
        np.testing.assert_array_equal(a.owner, b.owner)
        ids = np.array([0, 5, 255, 17, 17])
        np.testing.assert_array_equal(a.owner_of(ids), b.owner_of(ids))
        for w in range(a.n_workers):
            np.testing.assert_array_equal(a.rows_of(w), b.rows_of(w))
    if case == "resize4to5":    # the same rows move, and only some
        moved = maps[0][0].owner != maps[0][1].owner
        np.testing.assert_array_equal(
            moved, maps[1][0].owner != maps[1][1].owner)
        assert 0 < moved.mean() < 0.5


@pytest.mark.parametrize("args,exc", [
    (("degree", N_ROWS, 4), ValueError), (("nope", N_ROWS, 4), ValueError),
    (("hash", N_ROWS, 0), ValueError)])
def test_partition_errors_identical(args, exc):
    for p in (part, ref_part):
        with pytest.raises(exc):
            p.make_partition(*args)


@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_partitioned_store_bytes_identical(tmp_path, n_workers):
    port, ref = _pstores(str(tmp_path), n_workers)
    want = ref_part.reference_rows(np.arange(N_ROWS), ROW_DIM, SEED)
    np.testing.assert_array_equal(
        part.reference_rows(np.arange(N_ROWS), ROW_DIM, SEED), want)
    np.testing.assert_array_equal(port.read_rows(np.arange(N_ROWS)), want)
    np.testing.assert_array_equal(ref.read_rows(np.arange(N_ROWS)), want)
    np.testing.assert_array_equal(port.local_index, ref.local_index)
    for w in range(n_workers):
        for s in range(2):
            name = os.path.join(f"worker_{w}", f"shard_{s}.bin")
            with open(os.path.join(tmp_path, "port", name), "rb") as a, \
                    open(os.path.join(tmp_path, "ref", name), "rb") as b:
                assert a.read() == b.read()
    with pytest.raises(PermissionError):
        port.write_rows(np.array([1]), np.ones((1, ROW_DIM), np.float32))


# ---------------------------------------------------------------------------
# the remote engine
# ---------------------------------------------------------------------------

def _engine_run(pstore, remote_cls, me):
    """Reads (gather and scatter form, an empty batch), owner-writes and a
    read-back through one engine: every result and virtual second."""
    out = []
    with remote_cls(pstore, me=me, chaos=None) as eng:
        ids = np.array([0, 7, 255, 13, 13, 200,
                        pstore.partition.rows_of(me)[0]])
        data, virt = eng.submit(ids).wait()
        out.append((data.copy(), virt))
        buf = np.zeros((len(ids) + 1, ROW_DIM), np.float32)
        _, virt = eng.submit(ids, buf, np.arange(len(ids)) + 1).wait()
        out.append((buf, virt))
        d0, v0 = eng.submit(np.empty(0, np.int64)).wait()
        out.append((d0, v0))
        wids = np.array([3, 99, 148, 99])
        rows = np.arange(4 * ROW_DIM, dtype=np.float32).reshape(4, ROW_DIM)
        _, virt = eng.submit_write(wids, rows).wait()
        out.append((None, virt))
        data, virt = eng.submit(wids).wait()
        out.append((data.copy(), virt))
        counters = _engine_counters(eng)
        stats = _no_wall(eng.stats._values())
    return out, counters, stats


@pytest.mark.parametrize("me", [0, 3])
def test_remote_engine_reads_and_writes_identical(tmp_path, me):
    port, ref = _pstores(str(tmp_path), 4, writable=True)
    a = _engine_run(port, RemoteIOEngine, me)
    b = _engine_run(ref, RefRemote, me)
    for (da, va), (db, vb) in zip(a[0], b[0]):
        if da is not None:
            np.testing.assert_array_equal(da, db)
        assert va == vb
    assert a[1] == b[1] and a[1][0] > 0 and a[1][1] > 0 and a[1][2] == 0
    assert a[2] == b[2]
    # last writer wins: row 99 holds the fourth row
    np.testing.assert_array_equal(a[0][-1][0][1], a[0][-1][0][3])
    np.testing.assert_array_equal(port.read_rows(np.arange(N_ROWS)),
                                  ref.read_rows(np.arange(N_ROWS)))


def test_remote_engine_rejects_alike(tmp_path):
    (port, ref), (wport, wref) = (_pstores(str(tmp_path / "ro"), 2),
                                  _pstores(str(tmp_path / "rw"), 4, True))
    for st, wst, cls in ((port, wport, RemoteIOEngine),
                         (ref, wref, RefRemote)):
        with cls(st, me=0, chaos=None) as eng:
            with pytest.raises(PermissionError):
                eng.submit_write(np.array([1]),
                                 np.ones((1, ROW_DIM), np.float32))
        with cls(wst, me=0, chaos=None) as eng:
            with pytest.raises(ValueError):
                eng.submit_write(np.array([1, 2]),
                                 np.ones((1, ROW_DIM), np.float32))
        with pytest.raises(ValueError):
            cls(wst, me=9)


def _dead_peer_run(pstore, k, per_step: bool):
    """Five tickets of worker 1's rows (and four of worker 0's) through a
    remote engine at worker 0, worker 1 killed before step 2's.  With
    ``per_step`` each ticket is waited on before the next step's kill
    check, so its legs are routed by the step; without, all five are in
    flight at once."""
    s = _side(k)
    p = pstore.partition
    coord = s["ft"].Coordinator(n_workers=4)
    inj = s["ft"].FailureInjector(kill_at={2: 1})
    victim = p.rows_of(1)[:24]
    with s["remote"](pstore, me=0, coordinator=coord, chaos=None) as eng:
        cq = s["cq"]()
        tickets, batches = [], []
        for step in range(5):
            inj.apply(step, coord.workers)      # step 2 kills worker 1
            ids = np.concatenate([victim[:12], p.rows_of(0)[:4]])
            batches.append(ids)
            tickets.append(eng.submit(ids, cq=cq))
            if per_step:
                tickets[-1].wait()
        done = cq.drain()
        assert len(done) == len(tickets)
        assert {id(t) for t in done} == {id(t) for t in tickets}
        got = [(tk.wait()[0].copy(), tk.wait()[1]) for tk in tickets]
        assert not eng.peer_alive(1)
        t_dead = eng.submit(victim).wait()[1]
        coord.workers[1].alive = True
        t_live = eng.submit(victim).wait()[1]
        return got, batches, _engine_counters(eng), (t_dead, t_live)


@pytest.mark.parametrize("per_step", [False, True],
                         ids=["in_flight", "per_step"])
def test_dead_peer_reroute_identical(tmp_path, per_step):
    """A peer killed while tickets are in flight: the port's engine against
    the reference's.

    The engine reads ``peer_alive(w)`` when a worker thread services a
    leg, not when the leg is submitted (``remote_engine.py``, the same in
    both packages).  With all five tickets in flight, whether step 0-1's
    legs to worker 1 are serviced before or after step 2's kill depends on
    the thread schedule, so their pricing (``remote`` or ``reroute``) can
    differ between two runs under load.  That case asserts what holds
    under any interleaving: every ticket completes once with the right
    rows, local rows agree and so do remote rows (the engine counts a
    rerouted row as remote too, ``_book_peer``), rows are rerouted, and a
    dead peer costs more than a live one.  Waiting on each ticket
    before the next step fixes the routing by the step; that case holds
    every counter, each ticket's virtual seconds and the dead and live
    times exactly."""
    port, ref = _pstores(str(tmp_path), 4)
    want = ref_part.reference_rows(np.arange(N_ROWS), ROW_DIM, SEED)
    a, b = (_dead_peer_run(port, 0, per_step),
            _dead_peer_run(ref, 1, per_step))
    for (ra, va), (rb, vb), ids in zip(a[0], b[0], a[1]):
        np.testing.assert_array_equal(ra, want[ids])
        np.testing.assert_array_equal(ra, rb)
        if per_step:
            assert va == vb
    assert a[2][2] > 0 and b[2][2] > 0
    assert a[3][0] > a[3][1] and b[3][0] > b[3][1]
    if per_step:
        assert a[2] == b[2] and a[2][3] > 0
        assert a[3] == b[3]
    else:
        assert a[2][:2] == b[2][:2]


# ---------------------------------------------------------------------------
# the cache's remote tier
# ---------------------------------------------------------------------------

def _trace():
    rng = np.random.default_rng(3)
    return [rng.integers(0, N_ROWS, 48) for _ in range(6)] + \
        [np.repeat(np.arange(40, 52), 4), np.empty(0, np.int64)]


@pytest.mark.parametrize("path", list(CACHE_PATHS))
@pytest.mark.parametrize("mode", ["async", "fleet1", "fleet4"])
def test_cache_remote_tier_matches_reference(tmp_path, mode, path):
    """The three-mode consistency trace: a single-store async engine, a
    one-worker fleet and a four-worker fleet with the remote tier live.
    The port's cache returns the reference's rows bit for bit, with the
    same CacheStats (wall time aside), engine counters and per-gather
    ``io_virt``; every mode returns the same rows."""
    want = ref_part.reference_rows(np.arange(N_ROWS), ROW_DIM, SEED)
    caches = []
    for k, tag in ((0, "port"), (1, "ref")):
        s = _side(k)
        root = str(tmp_path / tag)
        if mode == "async":
            st = s["store"](root, N_ROWS, ROW_DIM, n_shards=2, create=True,
                            writable=True)
            st.write_rows(np.arange(N_ROWS), want)
            st.flush()
            eng = s["engine"](st, chaos=None)
        else:
            p = s["part"]
            st = p.PartitionedFeatureStore(
                root, N_ROWS, ROW_DIM,
                p.make_partition("hash", N_ROWS, 1 if mode == "fleet1"
                                 else 4), n_shards=2, create=True,
                rng_seed=SEED)
            eng = s["remote"](st, me=0, chaos=None)
        kw = CACHE_PATHS[path][k]
        if k == 0:
            kw = dict(kw, device="cpu")
        caches.append(s["cache"](st, np.zeros(N_ROWS), 16, 32,
                                 io_engine=eng, **kw))
    port, ref = caches
    try:
        np.testing.assert_array_equal(port._base_loc, ref._base_loc)
        for ids in _trace():
            pp, pr = port.submit_planned(ids), ref.submit_planned(ids)
            b, a = port.complete_planned(pp), ref.complete_planned(pr)
            assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            np.testing.assert_array_equal(b.numpy(), want[ids])
            assert (pp.n_device, pp.n_host, pp.n_storage, pp.n_remote) == \
                (pr.n_device, pr.n_host, pr.n_storage, pr.n_remote)
            assert pp.io_virt == pr.io_virt
        assert _no_wall(port.stats()._values()) == \
            _no_wall(ref.stats()._values())
        _io_stats_equal(port.io, ref.io)
        if mode == "fleet4":
            assert port.stats.remote_hits > 0
            assert port.stats.virtual_remote_s > 0
            assert _engine_counters(port.io) == _engine_counters(ref.io)
        else:
            assert port.stats.remote_hits == 0
    finally:
        for c in caches:
            c.close()
            c.io.close()


@pytest.mark.parametrize("path", ["kernel", "plan"])
def test_cache_remote_tier_prefetch_and_refresh_identical(tmp_path, path):
    """Placement, refresh and prefetch treat remote rows as admissible
    (loc >= 2) and demote victims to their own base tier: loc, slot and
    _base_loc equal the reference's after every step."""
    from repro.core.policy import OnlineDecayPolicy as RefPolicy
    from repro_torch.core.policy import OnlineDecayPolicy
    want = ref_part.reference_rows(np.arange(N_ROWS), ROW_DIM, SEED)
    stores = _pstores(str(tmp_path), 4, writable=True)
    caches = []
    for k, (st, pol) in enumerate(zip(stores, (OnlineDecayPolicy,
                                               RefPolicy))):
        kw = CACHE_PATHS[path][k]
        if k == 0:
            kw = dict(kw, device="cpu")
        caches.append(_side(k)["cache"](
            st, device_rows=8, host_rows=16,
            io_engine=_side(k)["remote"](st, me=0, chaos=None),
            policy=pol(N_ROWS, refresh_every=2), journal=False, **kw))
    port, ref = caches
    remote_ids = stores[0].partition.rows_of(2)[:8]
    local_ids = stores[0].partition.rows_of(0)[:4]
    try:
        for step in range(5):
            ids = np.concatenate([remote_ids, local_ids[:step]])
            b = port.gather(ids)
            np.testing.assert_array_equal(b.numpy(), np.asarray(ref.gather(
                ids)))
            np.testing.assert_array_equal(b.numpy(), want[ids])
            ra, rb = ref.maybe_refresh(), port.maybe_refresh()
            assert (ra is None) == (rb is None)
            if ra is not None:
                assert vars(ra) == vars(rb)
            pa, pb = ref.maybe_prefetch(k=8), port.maybe_prefetch(k=8)
            assert (pa is None) == (pb is None)
            if pa is not None:
                assert vars(pa) == vars(pb)
            for name in ("loc", "slot", "_base_loc"):
                np.testing.assert_array_equal(getattr(port, name),
                                              getattr(ref, name))
            un = port.loc >= 2
            np.testing.assert_array_equal(port.loc[un], port._base_loc[un])
        assert (port.loc[remote_ids] < 2).any()
        assert port.stats.remote_hits > 0 and port.stats.refreshes > 0
        # an owner-write of a remote row lands at its owner, read back
        rows = np.full((2, ROW_DIM), 3.25, np.float32)
        wid = np.array([remote_ids[0], stores[0].partition.rows_of(3)[0]])
        assert vars(port.write_planned(wid, rows)) == \
            vars(ref.write_planned(wid, rows))
        np.testing.assert_array_equal(port.gather(wid).numpy(), rows)
        np.testing.assert_array_equal(np.asarray(ref.gather(wid)), rows)
        assert vars(port.flush()) == vars(ref.flush())
        np.testing.assert_array_equal(stores[0].read_rows(wid), rows)
        np.testing.assert_array_equal(stores[0].read_rows(np.arange(N_ROWS)),
                                      stores[1].read_rows(np.arange(N_ROWS)))
        assert _no_wall(port.stats()._values()) == \
            _no_wall(ref.stats()._values())
        assert _engine_counters(port.io) == _engine_counters(ref.io)
    finally:
        for c in caches:
            c.close()
            c.io.close()


# ---------------------------------------------------------------------------
# the serving fleet
# ---------------------------------------------------------------------------

def _fleet_world(root):
    from repro.gnn.graph import synth_graph as ref_graph
    from repro_torch.gnn.graph import synth_graph
    graphs = (synth_graph(600, 5, skew=1.2, seed=0),
              ref_graph(600, 5, skew=1.2, seed=0))
    stores = tuple(cls(os.path.join(root, tag), 600, 16, n_shards=2,
                       create=True, rng_seed=0, writable=True)
                   for cls, tag in ((FeatureStore, "port"),
                                    (RefStore, "ref")))
    return graphs, stores


@pytest.mark.parametrize("n_replicas,fleet_seed", [(3, 1), (2, 4)])
def test_fleet_matches_reference(tmp_path, n_replicas, fleet_seed):
    """The reference test's configuration with the reference's parameters
    carried over: the same routes, the same answered requests, logits
    within 1e-5, the same invalidated rows, and written rows read back on
    every replica and from the store."""
    import jax
    from repro.distributed.fleet import ServingFleet as RefFleet
    from repro.serving.service import ServerConfig as RefConfig
    from repro_torch.distributed.fleet import ServingFleet
    from repro_torch.gnn.models import params_from_numpy
    from repro_torch.serving import ServerConfig
    (tg, rg), (tst, rst) = _fleet_world(str(tmp_path))
    kw = dict(request_batch_size=8, fanouts=(3, 2), hidden=8,
              device_cache_frac=0.05, host_cache_frac=0.10,
              presample_batches=1, seed=0, chaos=None)
    rng = np.random.default_rng(2)
    reqs = [rng.choice(600, 8, replace=False) for _ in range(9)]
    hot = np.arange(40)
    new = np.full((40, 16), 7.5, np.float32)
    runs = []
    with RefFleet(rg, rst, n_replicas=n_replicas, cfg=RefConfig(**kw),
                  seed=fleet_seed) as ref:
        params = params_from_numpy(jax.tree.map(np.asarray, ref.replicas[
            0].params), "cpu")
        with ServingFleet(tg, tst, n_replicas=n_replicas,
                          cfg=ServerConfig(device="cpu", **kw),
                          seed=fleet_seed, params=params) as port:
            assert all(r.params is params for r in port.replicas)
            assert all(r.cache.write_policy == "writethrough"
                       for r in port.replicas)
            for fleet in (port, ref):
                out = []
                for _ in range(2):  # before and after the owner-writes
                    futs = [fleet.submit(s) for s in reqs]
                    fleet.flush()
                    out.append([(i, f.result()) for f, i in futs])
                    if len(out) == 1:
                        fleet.write_embeddings(hot, new)
                runs.append(out)
                for i, rep in enumerate(fleet.replicas):
                    fleet._settle_invalidations(i)
                    np.testing.assert_array_equal(
                        np.asarray(rep.cache.gather(hot)), new)
                assert fleet._settle_invalidations(0) == 0
            np.testing.assert_array_equal(port.router.route_counts,
                                          ref.router.route_counts)
            assert port.invalidated_rows == ref.invalidated_rows > 0
            assert port.embedding_writes == ref.embedding_writes == 1
            np.testing.assert_array_equal(tst.read_rows(hot), new)
            np.testing.assert_array_equal(rst.read_rows(hot), new)
            for rp, rr in zip(port.replicas, ref.replicas):
                assert _no_wall(rp.cache.stats()._values()) == \
                    _no_wall(rr.cache.stats()._values())
    served = 0
    for rnd_port, rnd_ref in zip(*runs):
        for (ia, a), (ib, b) in zip(rnd_port, rnd_ref):
            assert ia == ib and (a is None) == (b is None)
            if a is not None:
                served += 1
                assert a["latency_v"] == b["latency_v"]
                np.testing.assert_allclose(a["logits"],
                                           np.asarray(b["logits"]),
                                           rtol=1e-5, atol=1e-5)
    assert served > 0


def test_fleet_own_params_shared_by_replicas(tmp_path):
    """Without ``params`` the fleet draws one set from a seeded
    ``torch.Generator``, as the server does, and every replica serves
    that one set: two fleets with one seed answer identically."""
    from repro_torch.distributed.fleet import ServingFleet
    from repro_torch.gnn.models import init_gnn_params
    from repro_torch.serving import ServerConfig
    (tg, _), (tst, _) = _fleet_world(str(tmp_path))
    cfg = ServerConfig(device="cpu", request_batch_size=8, fanouts=(3, 2),
                       hidden=8, presample_batches=1, chaos=None)
    want = init_gnn_params(torch.Generator().manual_seed(0), "sage", 16, 8,
                           tg.n_classes, device="cpu")
    rng = np.random.default_rng(5)
    reqs = [rng.choice(600, 8, replace=False) for _ in range(6)]
    outs = []
    for _ in range(2):
        with ServingFleet(tg, tst, n_replicas=2, cfg=cfg) as fleet:
            assert fleet.replicas[0].params is fleet.replicas[1].params
            for a, b in zip(fleet.params["layers"], want["layers"]):
                assert all(torch.equal(a[k], b[k]) for k in b)
            futs = [fleet.submit(s)[0] for s in reqs]
            fleet.flush()
            outs.append([f.result() for f in futs])
    for a, b in zip(*outs):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a["logits"], b["logits"])


def test_router_routes_identical():
    from repro.distributed.fleet import PowerOfTwoRouter as RefRouter
    from repro_torch.distributed.fleet import PowerOfTwoRouter
    rng = np.random.default_rng(9)
    for n in (1, 2, 5):
        a, b = PowerOfTwoRouter(n, seed=3), RefRouter(n, seed=3)
        for _ in range(40):
            depths = list(rng.integers(0, 4, n))
            assert a.pick(depths) == b.pick(depths)
        np.testing.assert_array_equal(a.route_counts, b.route_counts)
    for cls in (PowerOfTwoRouter, RefRouter):
        with pytest.raises(ValueError):
            cls(0)


def test_fleet_and_remote_cache_need_the_card_by_default(tmp_path):
    """Without a card, a fleet with the default ``ServerConfig`` and a
    remote-tier cache with the default device raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.distributed.fleet import ServingFleet
    from repro_torch.serving import ServerConfig
    (tg, _), (tst, _) = _fleet_world(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingFleet(tg, tst, n_replicas=2, cfg=ServerConfig())
    port, _ = _pstores(str(tmp_path / "p"), 4)
    with RemoteIOEngine(port, me=0, chaos=None) as eng:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HeteroCache(port, np.zeros(N_ROWS), 8, 8, io_engine=eng)


# ---------------------------------------------------------------------------
# failure coordination
# ---------------------------------------------------------------------------

def _coordinator_run(mod):
    t = [0.0]
    coord = mod.Coordinator(n_workers=4, heartbeat_timeout=2.0,
                            clock=lambda: t[0])
    inj = mod.FailureInjector(kill_at={3: 2}, slow_at={1: (1, 4.0)})
    det = mod.StragglerDetector(alpha=0.3, threshold=2.5)
    durs = [1.0, 1.1, 0.9, 5.0, 1.0, 3.0, 1.2, 9.0]
    log = [det.observe("io", d) for d in durs] + [dict(det.ema)]
    for step in range(6):
        t[0] = float(step)
        inj.apply(step, coord.workers)
        for w in coord.workers:
            if w != 3 or step < 2:
                coord.heartbeat(w)
        log.append(coord.step_plan(step))
        log.append(coord.observe_stage(step, "gather",
                                       durs[step] * coord.workers[1]
                                       .slow_factor, worker_id=1))
        log.append(coord.dead_workers(now=t[0] + 0.5))
    log.append([(w.worker_id, w.alive, w.slow_factor, w.last_heartbeat)
                for w in coord.workers.values()])
    log.append(coord.events)
    return log


def test_coordinator_and_straggler_decisions_identical():
    a, b = _coordinator_run(ft), _coordinator_run(ref_ft)
    assert a == b
    assert any(x is True for x in a[:8])
    assert any(isinstance(e, tuple) and e[0] == "restart" for e in a[-1])


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

SHAPES = [(), (1,), (255,), (256,), (257,), (3, 700), (4, 8, 33)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_matches_reference(shape):
    import jax.numpy as jnp
    from repro.distributed import compression as rc
    from repro_torch.distributed import compression as tc
    rng = np.random.default_rng(len(shape) * 7 + sum(shape))
    g = np.array(rng.standard_normal(shape) * 10 ** rng.uniform(-3, 3),
                 np.float32)
    if g.size > 3:
        g.reshape(-1)[:3] = [0.0, 0.5, -0.5]    # ties round half to even
    q, s, pad = tc.quantize_int8(torch.from_numpy(g))
    rq, rs, rpad = rc.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8 and pad == rpad == (-g.size) % tc.BLOCK
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-7, atol=0)
    back = tc.dequantize_int8(q, s, pad, g.shape)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(rc.dequantize_int8(rq, rs, rpad, g.shape)),
        rtol=1e-7, atol=0)
    np.testing.assert_allclose(
        tc.compress_decompress(torch.from_numpy(g)).numpy(),
        np.asarray(rc.compress_decompress(jnp.asarray(g))), rtol=1e-7,
        atol=0)
    assert tc.BLOCK == rc.BLOCK


def test_quantize_all_zero_block():
    from repro_torch.distributed import compression as tc
    q, s, pad = tc.quantize_int8(torch.zeros(300))
    assert not q.any() and not s.any() and pad == 212
    assert torch.equal(tc.compress_decompress(torch.zeros(2, 3)),
                       torch.zeros(2, 3))


def _leaves_in_jax_order(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_in_jax_order(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves_in_jax_order(v)]
    return [tree]


@pytest.mark.parametrize("steps", [1, 3])
def test_error_feedback_tree_matches_reference(steps):
    import jax
    import jax.numpy as jnp
    from repro.distributed import compression as rc
    from repro_torch.distributed import compression as tc
    rng = np.random.default_rng(steps)
    grads_np = [{"layers": [{"w": rng.standard_normal((33, 17))
                             .astype(np.float32),
                             "b": rng.standard_normal(17)
                             .astype(np.float32) * 1e-3}],
                 "head": {"w": rng.standard_normal((17, 5))
                          .astype(np.float32)}}
                for _ in range(steps)]
    err_t = err_r = None
    for g in grads_np:
        gt = {"layers": [{k: torch.from_numpy(v) for k, v in
                          g["layers"][0].items()}],
              "head": {"w": torch.from_numpy(g["head"]["w"])}}
        sent_t, err_t = tc.compressed_grad_tree(gt, err_t)
        sent_r, err_r = rc.compressed_grad_tree(
            jax.tree.map(jnp.asarray, g), err_r)
        for a, b in ((sent_t, sent_r), (err_t, err_r)):
            la = [x.numpy() for x in _leaves_in_jax_order(a)]
            lb = [np.asarray(x) for x in jax.tree.leaves(b)]
            assert len(la) == len(lb) == 3
            for x, y in zip(la, lb):
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)
    assert tc.wire_bytes(gt) == rc.wire_bytes(jax.tree.map(jnp.asarray, g))
    raw, comp = tc.wire_bytes(gt)
    assert raw == 4 * (33 * 17 + 17 + 17 * 5) and comp < raw

