"""The port's observability against the reference's, on the CPU: the stats
snapshots and their deltas, the cache's and engines' spans, retry
instants under chaos, a traced training epoch (coverage, per-batch
critical path, the Chrome export) and the ``HELIOS_TRACE`` hook, each leg
of ``tests/test_obs.py:123-386`` on both packages, and the packages'
readings held against each other.

Equal exactly: gathered rows with tracing on and off, CacheStats and IO
counters, span names and counts, retry instants; virtual seconds of the
engines and of the pipeline's spans within rel 1e-12 (worker threads sum
them in completion order).  The compared epoch runs at
``prefetch_depth=1``; the reference's own epoch leg (depth 2) runs on the
port as it is.
"""
import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ft_ref_compare import (PKGS, PORT, host, no_wall,  # noqa: E402
                            np_tree, start_from)

N_ROWS, ROW_DIM, N_SHARDS = 4096, 32, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = pytest.mark.parametrize("pkg", list(PKGS), ids=list(PKGS))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    p = tmp_path_factory.mktemp("obs_feats")
    return {k: pk.FeatureStore(str(p / k), n_rows=N_ROWS, row_dim=ROW_DIM,
                               n_shards=N_SHARDS, create=True, rng_seed=0)
            for k, pk in PKGS.items()}


class _Tracing:
    """Install a fresh tracer in one package (restoring the old one)."""

    def __init__(self, pkg):
        self.mod = PKGS[pkg].trace

    def __enter__(self):
        self.prev = self.mod.TRACER
        self.tr = self.mod.install()
        return self.tr

    def __exit__(self, *exc):
        self.mod.TRACER = self.prev
        return False


def _names(tracer):
    return collections.Counter(s.name for s in tracer.spans)


# the port's phase spans inside the trainer's operators, which the
# reference does not have: each opens inside its operator's span
PORT_PHASES = {"pipe.io_complete.wait": "pipe.io_complete",
               "pipe.io_complete.land": "pipe.io_complete",
               "pipe.train.dispatch": "pipe.train",
               "pipe.train.sync": "pipe.train",
               "sample.draw": "pipe.sample",
               "sample.relabel": "pipe.sample"}


# ---------------------------------------------------------------------------
# stats snapshots and deltas
# ---------------------------------------------------------------------------

@BOTH
def test_stats_publish_into_registry(stores, pkg):
    """test_obs.py:123: engine stats publish into the metrics registry."""
    p = PKGS[pkg]
    p.metrics.REGISTRY.reset()
    eng = p.AsyncIOEngine(stores[pkg])
    eng.submit(np.arange(512)).wait()
    eng.stats.publish("t.io")
    snap = p.metrics.REGISTRY.snapshot()
    assert snap["t.io.requests"] == 512 and snap["t.io.bytes"] > 0
    assert snap["t.io.bw"] > 0
    eng.close()
    p.metrics.REGISTRY.reset()


@BOTH
def test_iostats_snapshot_and_delta(stores, pkg):
    """test_obs.py:139: a snapshot is frozen, its delta counts the rest."""
    eng = PKGS[pkg].AsyncIOEngine(stores[pkg])
    eng.submit(np.arange(256)).wait()
    before = eng.stats.snapshot()
    assert before.requests == eng.stats.requests
    eng.submit(np.arange(256, 768)).wait()
    d = eng.stats.delta(before)
    assert d.batches >= 1 and d.requests == 512 and d.bytes > 0
    assert before.requests + d.requests == eng.stats.requests
    eng.close()


def _snapshots(pkg, store):
    p = PKGS[pkg]
    ids = np.random.default_rng(0).integers(0, N_ROWS, 2048)
    eng = p.AsyncIOEngine(store)
    cache = p.HeteroCache(store, np.arange(N_ROWS)[::-1], 256, 512, eng)
    t = cache.submit_planned(ids[:1024])
    cache.complete_planned(t)
    snap = cache.stats()
    assert snap.device_hits == cache.stats.device_hits
    assert snap.hit_rate == pytest.approx(cache.stats.hit_rate)
    io_snap = eng.stats.snapshot()
    t = cache.submit_planned(ids[1024:])
    cache.complete_planned(t)
    d = cache.stats().delta(snap)
    io_d = eng.stats.delta(io_snap)
    eng.close()
    return snap, d, io_snap, io_d, cache.stats


def test_cache_stats_callable_snapshot(stores):
    """test_obs.py:152 on both packages: ``cache.stats()`` is an atomic
    snapshot and ``delta`` counts one batch of 1024 rows; the packages'
    snapshots and deltas, of the cache and of the engine, are equal."""
    got = {k: _snapshots(k, stores[k]) for k in PKGS}
    for k, (snap, d, _, _, live) in got.items():
        assert live.batches == snap.batches + 1
        assert (d.device_hits + d.host_hits + d.storage_misses
                + d.remote_hits) == 1024
        assert d.batches == 1
    (rs, rd, ris, rid, _), (ts, td, tis, tid, _) = got["ref"], got["port"]
    assert no_wall(ts._values()) == no_wall(rs._values())
    assert no_wall(td._values()) == no_wall(rd._values())
    for a, b in ((ris, tis), (rid, tid)):
        va, vb = no_wall(a._values()), no_wall(b._values())
        for key in va:
            assert vb[key] == pytest.approx(va[key], rel=1e-12), key


# ---------------------------------------------------------------------------
# engine and cache spans; gathers identical with tracing on
# ---------------------------------------------------------------------------

@BOTH
def test_engine_spans_and_identical_gathers(stores, pkg):
    """test_obs.py:174: engine spans parent their submit across threads
    and the gathered rows are bit-identical with tracing on and off."""
    p = PKGS[pkg]
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, N_ROWS, 777) for _ in range(4)]
    eng = p.AsyncIOEngine(stores[pkg])
    want = [eng.submit(b).wait()[0] for b in batches]
    eng.close()
    with _Tracing(pkg) as tracer:
        eng = p.AsyncIOEngine(stores[pkg])
        got = [eng.submit(b).wait()[0] for b in batches]
        eng.close()
    for w, g in zip(want, got):
        assert (w == g).all()
    assert {"io.submit.read", "io.qwait", "io.service.r",
            "io.ticket.read"} <= set(_names(tracer))
    by_id = {s.sid: s for s in tracer.spans}
    submits = {s.sid for s in tracer.spans if s.name == "io.submit.read"}
    for s in tracer.spans:
        if s.name in ("io.qwait", "io.service.r", "io.ticket.read"):
            assert s.parent in submits or s.parent is None
        if s.parent is not None:
            assert s.parent in by_id and s.parent != s.sid


def _cache_spans(pkg, store, traced):
    p = PKGS[pkg]
    ids = np.random.default_rng(2).integers(0, N_ROWS, 1024)
    eng = p.AsyncIOEngine(store)
    cache = p.HeteroCache(store, np.arange(N_ROWS)[::-1], 128, 256, eng)
    if not traced:
        rows = host(cache.complete_planned(cache.submit_planned(ids)))
        eng.close()
        return rows, None
    with _Tracing(pkg) as tracer:
        t = cache.submit_planned(ids)
        rows = host(cache.complete_planned(t))
        eng.close()
    return rows, tracer


def test_cache_spans_nest_engine_spans(stores):
    """test_obs.py:206 on both packages: the cache's split-phase gather
    emits ``cache.gather.submit`` and ``cache.gather.complete``, engine
    submits opened inside it parent to a ``cache.*`` span, and the rows
    are the untraced gather's.  Both packages emit the same spans, as
    many of each."""
    names = {}
    for k in PKGS:
        plain, _ = _cache_spans(k, stores[k], False)
        rows, tracer = _cache_spans(k, stores[k], True)
        np.testing.assert_array_equal(rows, plain)
        by_id = {s.sid: s for s in tracer.spans}
        assert any(s.name == "cache.gather.submit" for s in tracer.spans)
        assert any(s.name == "cache.gather.complete" for s in tracer.spans)
        io_subs = [s for s in tracer.spans if s.name == "io.submit.read"]
        assert io_subs and all(by_id[s.parent].name.startswith("cache.")
                               for s in io_subs if s.parent is not None)
        names[k] = _names(tracer)
    assert names["port"] == names["ref"]


# ---------------------------------------------------------------------------
# retry instants under chaos
# ---------------------------------------------------------------------------

def _retries(pkg, store):
    p = PKGS[pkg]
    with _Tracing(pkg) as tracer:
        eng = p.AsyncIOEngine(store,
                              chaos=p.ChaosSchedule(seed=7,
                                                    read_error_rate=0.05),
                              retry=p.RetryPolicy(deadline_s=5e-4,
                                                  backoff_base_s=2e-5))
        rng = np.random.default_rng(3)
        data = [eng.submit(rng.integers(0, N_ROWS, 2048)).wait()[0]
                for _ in range(6)]
        eng.close()
    return eng.stats, [e for e in tracer.events if e[0] == "ft.retry.r"], \
        data


def test_retry_instants_under_chaos(stores):
    """test_obs.py:228 on both packages: chaos retries surface as
    ``ft.retry.r`` instants on the shard's track; both packages raise the
    same instants (stream, retries, transient errors, backoff) and count
    the same retries."""
    got = {k: _retries(k, stores[k]) for k in PKGS}
    for k, (stats, ev, _) in got.items():
        assert stats.retries > 0, k
        assert ev, k
        name, t, track, cat, tname, args = ev[0]
        assert cat == "ft" and args["retries"] >= 1
        assert track.startswith("s")
    (rs, rev, rdata), (ts, tev, tdata) = got["ref"], got["port"]
    assert ts.retries == rs.retries and ts.transient_errors == \
        rs.transient_errors

    def key(ev):
        return sorted((e[2], json.dumps(e[5], sort_keys=True)) for e in ev)
    assert key(tev) == key(rev)
    for a, b in zip(rdata, tdata):
        np.testing.assert_array_equal(a, b)


@BOTH
def test_chaos_env_gathers_identical_when_traced(stores, pkg):
    """test_obs.py:247: the same chaos seed, tracing on and off: the
    recovery path does not depend on the spans."""
    p = PKGS[pkg]
    b = np.random.default_rng(4).integers(0, N_ROWS, 4096)
    eng = p.AsyncIOEngine(stores[pkg],
                          chaos=p.ChaosSchedule(seed=11, read_error_rate=0.03),
                          retry=p.RetryPolicy(backoff_base_s=2e-5))
    want, _ = eng.submit(b).wait()
    eng.close()
    with _Tracing(pkg) as tracer:
        eng = p.AsyncIOEngine(stores[pkg], chaos=p.ChaosSchedule(
            seed=11, read_error_rate=0.03),
            retry=p.RetryPolicy(backoff_base_s=2e-5))
        got, _ = eng.submit(b).wait()
        eng.close()
    assert (want == got).all()
    assert any(e[0] == "ft.retry.r" for e in tracer.events)


# ---------------------------------------------------------------------------
# a traced training epoch
# ---------------------------------------------------------------------------

EPOCH = dict(mode="helios", batch_size=64, fanouts=(4, 3), hidden=32,
             presample_batches=2)


def _epoch(pkg, root, params_np=None, **cfg):
    p = PKGS[pkg]
    g = p.synth_graph(5000, 8, skew=1.0, seed=0)
    st = p.FeatureStore(str(root / f"{pkg}_f"), n_rows=5000, row_dim=32,
                        n_shards=4, create=True, rng_seed=3)
    with _Tracing(pkg) as tr:
        with p.Trainer(g, st, p.TrainerConfig(**EPOCH, **cfg)) as trn:
            if params_np is not None:
                start_from(trn, params_np)
            start = np_tree(trn.state["params"]) if pkg == "ref" else None
            out = trn.train(6)
    return tr, out, start


@pytest.fixture(scope="module")
def epochs(tmp_path_factory):
    """The port's epoch at the trainer's defaults (depth 2, as the
    reference's own leg), and both packages' at depth 1 under chaos."""
    root = tmp_path_factory.mktemp("obs_epoch")
    out = {"port": _epoch("port", root / "d2", chaos=None)}
    env = os.environ.pop("HELIOS_CHAOS", None)
    try:
        kw = dict(prefetch_depth=1, chaos="env")
        os.environ["HELIOS_CHAOS"] = "seed=7,read_error_rate=0.05"
        ref = _epoch("ref", root / "r1", **kw)
        out["ref_chaos"] = ref
        out["port_chaos"] = _epoch("port", root / "p1", params_np=ref[2],
                                   **kw)
    finally:
        os.environ.pop("HELIOS_CHAOS", None)
        if env is not None:
            os.environ["HELIOS_CHAOS"] = env
    return out


@pytest.mark.parametrize("run", ["port", "port_chaos", "ref_chaos"])
def test_traced_epoch_report_and_obs(epochs, run):
    """test_obs.py:286: coverage of the virtual timeline at least 0.95,
    overlap and bubble shares in [0, 1], and every batch's critical path
    at most its summed phase time."""
    tr, out, _ = epochs[run]
    assert "obs" in out and out["obs"]["coverage"] >= 0.95
    assert 0.0 <= out["overlap"]["overlap_efficiency"] <= 1.0
    assert 0.0 <= out["io"]["bubble_frac"] <= 1.0
    assert out["io"]["overlap_efficiency"] == pytest.approx(
        out["overlap"]["overlap_efficiency"])
    for b in out["obs"]["batches"].values():
        assert b["critical_s"] <= b["sum_s"] + 1e-9
        assert b["ops"] >= 1 and b["path"]


def test_concurrent_batch_spans_well_formed(epochs):
    """test_obs.py:299 on the port: every pipeline span carries its batch
    and lies inside the makespan; all 6 batches appear."""
    tr, out, _ = epochs["port"]
    pipe = [s for s in tr.spans if s.cat == "pipe"]
    assert pipe
    by_id = {s.sid: s for s in tr.spans}
    for s in pipe:
        assert s.args["batch"] >= 0
        assert s.v1 >= s.v0 >= 0.0
        assert s.v1 <= out["virtual_s"] + 1e-6
        if s.parent is not None:
            assert s.parent in by_id
    assert len({s.args["batch"] for s in pipe}) == 6


def test_traced_chaos_epoch_matches_reference(epochs):
    """Both packages' traced epochs under ``HELIOS_CHAOS`` at depth 1:
    the same pipeline, cache and engine spans, as many of each, the same
    ``ft.retry.r`` instants (retries above 0), the same per-batch virtual
    critical path and summed time (rel 1e-12) and the same coverage.  The
    port's phase spans (``PORT_PHASES``) are left out of the count, and
    each sits once in every batch's operator span."""
    (rtr, rout, _), (ttr, tout, _) = epochs["ref_chaos"], epochs["port_chaos"]
    names = _names(ttr)
    by_id = {s.sid: s for s in ttr.spans}
    for name, op in PORT_PHASES.items():
        del names[name]
        in_ops = [by_id[s.parent] for s in ttr.spans if s.name == name
                  and s.parent in by_id and by_id[s.parent].name == op]
        assert sorted(p.args["batch"] for p in in_ops) == list(range(6)), \
            name
    assert names == _names(rtr)
    assert tout["io"]["retries"] == rout["io"]["retries"] > 0
    rret = sorted(json.dumps(e[5], sort_keys=True) for e in rtr.events
                  if e[0] == "ft.retry.r")
    tret = sorted(json.dumps(e[5], sort_keys=True) for e in ttr.events
                  if e[0] == "ft.retry.r")
    assert tret == rret and tret
    assert tout["obs"]["coverage"] == pytest.approx(rout["obs"]["coverage"],
                                                    rel=1e-12)
    rb, tb = rout["obs"]["batches"], tout["obs"]["batches"]
    assert tb.keys() == rb.keys()
    for b in rb:
        for k in ("critical_s", "sum_s"):
            assert tb[b][k] == pytest.approx(rb[b][k], rel=1e-12), (b, k)
        assert tb[b]["path"] == rb[b]["path"]
    for name in {s.name for s in rtr.spans if s.cat == "pipe"}:
        rv = sorted(s.v1 - s.v0 for s in rtr.spans if s.name == name)
        tv = sorted(s.v1 - s.v0 for s in ttr.spans if s.name == name)
        np.testing.assert_allclose(tv, rv, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("run", ["port", "port_chaos"])
def test_chrome_export_schema(epochs, tmp_path, run):
    """test_obs.py:316 on the port: the Chrome export passes
    ``validate_trace``, with virtual and wall timelines and a named track
    per shard worker and pipeline resource."""
    tr, _, _ = epochs[run]
    doc = PORT.export.write_trace(tr, str(tmp_path / "trace.json"))
    PORT.export.validate_trace(doc)
    with open(tmp_path / "trace.json") as fh:
        evs = json.load(fh)["traceEvents"]
    assert {"X", "M"} <= {e["ph"] for e in evs}
    assert {e["pid"] for e in evs if e["ph"] == "X"} == {1, 2}
    meta = [e for e in evs if e["ph"] == "M"]
    assert {"process_name", "thread_name"} <= {e["name"] for e in meta}
    tracks = {e["args"]["name"] for e in meta if e["name"] == "thread_name"}
    assert {"ssd0", "device", "io"} <= tracks
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in evs
               if e["ph"] == "X")
    if run == "port_chaos":
        assert any(e.get("name") == "ft.retry.r" for e in evs)


@BOTH
def test_validate_trace_rejects_malformed(pkg):
    """test_obs.py:338."""
    v = PKGS[pkg].export.validate_trace
    with pytest.raises(ValueError):
        v({"nope": []})
    with pytest.raises(ValueError):
        v({"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, "ts": -5,
                            "dur": 1, "name": "x"}]})
    with pytest.raises(ValueError):
        v({"traceEvents": [{"ph": "?", "pid": 1, "tid": 1, "name": "x"}]})


def test_env_var_installs_tracer_and_exports(stores, tmp_path):
    """test_obs.py:366 on the port: ``HELIOS_TRACE`` installs a tracer at
    import and exports a valid Chrome trace at exit (a process that
    imports no JAX and nothing of the reference)."""
    out = tmp_path / "envtrace.json"
    code = ("import numpy as np\n"
            "from repro_torch.core.iostack import AsyncIOEngine, "
            "FeatureStore\n"
            f"s = FeatureStore({stores['port'].path!r}, n_rows={N_ROWS}, "
            f"row_dim={ROW_DIM}, n_shards={N_SHARDS})\n"
            "e = AsyncIOEngine(s)\n"
            "e.submit(np.arange(512)).wait()\n"
            "e.close()\n"
            "import sys\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n")
    env = dict(os.environ, HELIOS_TRACE=str(out),
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    with open(out) as fh:
        doc = json.load(fh)
    PORT.export.validate_trace(doc)
    assert any(e.get("name") == "io.ticket.read"
               for e in doc["traceEvents"])
