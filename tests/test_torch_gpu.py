"""The port on the card: each CUDA kernel against its plain version, and
the cache and server on the card against themselves on the CPU.

Every case is marked ``gpu`` and skips without a CUDA device.  The file
imports no JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.hetero_cache import HeteroCache  # noqa: E402
from repro_torch.core.iostack import FeatureStore, make_engine  # noqa: E402
from repro_torch.core.policy import make_policy  # noqa: E402
from repro_torch.gnn.graph import synth_graph  # noqa: E402
from repro_torch.kernels.cache_lookup import ops as lookup_ops  # noqa: E402
from repro_torch.kernels.cache_lookup.ref import \
    fused_lookup_ref  # noqa: E402
from repro_torch.kernels.gather import ops as gather_ops  # noqa: E402
from repro_torch.kernels.gather.ref import gather_rows_ref  # noqa: E402
from repro_torch.kernels.segment_agg import ops as seg_ops  # noqa: E402
from repro_torch.kernels.segment_agg.ref import \
    segment_sum_ref  # noqa: E402
from repro_torch.serving import (GNNInferenceServer,  # noqa: E402
                                 ServerConfig, zipf_workload)

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python3 chip_smoke.py runs the "
                    "same checks on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_gather_matches_plain(dtype):
    dev = _cuda()
    g = torch.Generator().manual_seed(0)
    for n, d, b in ((31232, 1024, 3904), (100, 7, 13), (5, 3, 0)):
        table = torch.randn(n, d, generator=g).to(dtype).to(dev)
        idx = torch.randint(0, n, (b,), generator=g).to(dev)
        got = gather_ops.gather_rows(table, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, gather_rows_ref(table, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_segment_sum_matches_plain(dtype):
    dev = _cuda()
    g = torch.Generator().manual_seed(1)
    for e, d, s in ((3200, 1024, 3904), (640, 256, 3904), (37, 1, 5)):
        msgs = torch.randn(e, d, generator=g).to(dtype).to(dev)
        segs = torch.randint(-2, s + 3, (e,), generator=g).to(dev)
        got = seg_ops.segment_sum(msgs, segs, s)
        torch.cuda.synchronize()
        want = segment_sum_ref(msgs, segs, s)
        assert (got - want).abs().max() <= 1e-5 * max(
            want.abs().max().item(), 1.0)


def test_gpu_lookup_matches_plain():
    dev = _cuda()
    rng = np.random.default_rng(2)
    for B, n, dup in ((4000, 30000, False), (1, 64, False), (600, 500, True)):
        loc = rng.choice(4, n, p=[0.2, 0.3, 0.3, 0.2]).astype(np.int32)
        slot = np.zeros(n, np.int32)
        for tier in (0, 1):
            slot[loc == tier] = np.arange((loc == tier).sum())
        dt = torch.from_numpy(rng.normal(size=((loc == 0).sum(), 64))
                              .astype(np.float32)).to(dev)
        ht = torch.from_numpy(rng.normal(size=((loc == 1).sum(), 64))
                              .astype(np.float32)).pin_memory()
        ids = rng.integers(0, 20 if dup else n, B)
        args = (torch.from_numpy(ids).to(dev), torch.from_numpy(loc).to(dev),
                torch.from_numpy(slot).to(dev))
        got = lookup_ops.fused_cache_lookup(*args, dt, ht)
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(got, fused_lookup_ref(*args, dt,
                                                              ht))):
            assert torch.equal(a, b), k


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return FeatureStore(str(tmp_path_factory.mktemp("gpu_feats")),
                        n_rows=2048, row_dim=64, n_shards=4, create=True,
                        rng_seed=5)


@pytest.mark.parametrize("kw", [dict(), dict(fused_backend="host"),
                                dict(fused=False)],
                         ids=["kernel", "host", "plan"])
def test_gpu_cache_matches_cpu(store, kw):
    """The cache on the card (K1/K2) gathers the same bits, with the same
    stats, as on the CPU (plain versions)."""
    dev = _cuda()
    hot = np.bincount(np.arange(4096) % 97 * 21 % 2048, minlength=2048)
    caches = [HeteroCache(store, hot, 100, 200,
                          make_engine("helios", store, chaos=None),
                          device=d, **kw) for d in (dev, "cpu")]
    assert caches[0].host_tier.is_pinned()
    rng = np.random.default_rng(3)
    try:
        for ids in (rng.integers(0, 2048, 300), np.repeat(np.arange(20), 9),
                    np.array([5]), np.empty(0, np.int64)):
            a, b = (c.gather(ids) for c in caches)
            assert a.device.type == "cuda"
            assert torch.equal(a.cpu(), b)
        va, vb = (c.stats()._values() for c in caches)
        va.pop("wall_s"), vb.pop("wall_s")
        assert va == vb
    finally:
        for c in caches:
            c.close()
            c.io.close()


def test_gpu_cache_migration_and_writes_match_cpu(tmp_path):
    """Refresh, prefetch, write_planned, apply_delta, invalidate and flush
    on the card (copy-on-write device tier, K2 reads, pinned host tier)
    leave the same tiers, stats and flushed store as on the CPU."""
    dev = _cuda()
    kw = dict(n_rows=2048, row_dim=64, n_shards=4, create=True, rng_seed=6,
              writable=True)
    stores = [FeatureStore(str(tmp_path / d), **kw) for d in ("gpu", "cpu")]
    hot = np.bincount(np.arange(4096) % 97 * 21 % 2048, minlength=2048)
    caches = [HeteroCache(
        st, None, 100, 200, make_engine("helios", st, chaos=None),
        policy=make_policy("online", 2048, presample=hot, refresh_every=1,
                           half_life=2.0, hysteresis=0.0),
        journal=False, device=d) for st, d in zip(stores, (dev, "cpu"))]
    rng = np.random.default_rng(8)
    try:
        for step in range(4):
            ids = rng.integers(0, 2048, 300)
            a, b = (c.gather(ids) for c in caches)
            assert torch.equal(a.cpu(), b)
            ra, rb = (c.maybe_refresh() for c in caches)
            assert (ra is None) == (rb is None)
            if ra is not None:
                assert vars(ra) == vars(rb)
            pa, pb = (c.maybe_prefetch(16) for c in caches)
            assert (pa is None) == (pb is None)
            if pa is not None:
                assert vars(pa) == vars(pb)
            wid = rng.integers(0, 2048, 120)
            rows = rng.normal(size=(120, 64)).astype(np.float32)
            assert vars(caches[0].write_planned(wid, rows)) == \
                vars(caches[1].write_planned(wid, rows))
            delta = rng.normal(size=(120, 64)).astype(np.float32)
            assert vars(caches[0].apply_delta(wid, delta)) == \
                vars(caches[1].apply_delta(wid, delta))
            assert caches[0].invalidate_rows(wid[:10]) == \
                caches[1].invalidate_rows(wid[:10])
        assert caches[0].device_tier.is_cuda
        assert caches[0].host_tier.is_pinned()
        assert torch.equal(caches[0].device_tier.cpu(), caches[1].device_tier)
        assert torch.equal(caches[0].host_tier, caches[1].host_tier)
        assert vars(caches[0].flush()) == vars(caches[1].flush())
        np.testing.assert_array_equal(stores[0].read_rows(np.arange(2048)),
                                      stores[1].read_rows(np.arange(2048)))
        va, vb = (c.stats()._values() for c in caches)
        va.pop("wall_s"), vb.pop("wall_s")
        assert va == vb and va["refreshes"] > 0
    finally:
        for c in caches:
            c.close()
            c.io.close()


def test_gpu_server_matches_cpu(store):
    """A small server on the card against the same server on the CPU:
    the same requests answered, the same virtual latencies, logits within
    1e-4, and every kernel launched on the card."""
    _cuda()
    g = synth_graph(2048, 8, skew=1.2, seed=0)
    wl = zipf_workload(2048, 12, 16, rate_rps=20_000, degrees=g.degrees(),
                       seed=1)
    kw = dict(request_batch_size=16, fanouts=(4, 3), hidden=32,
              max_batch_requests=4, chaos=None)
    for m in (gather_ops, seg_ops, lookup_ops):
        m.launches = 0
    results = []
    for device in ("cuda", "cpu"):
        with GNNInferenceServer(g, store,
                                ServerConfig(device=device, **kw)) as srv:
            futs = [srv.submit(s, k, t) for s, t, k in wl]
            srv.flush()
            results.append([f.result() for f in futs])
    assert min(gather_ops.launches, seg_ops.launches,
               lookup_ops.launches) > 0
    for a, b in zip(*results):
        assert (a is None) == (b is None)
        if a is not None:
            assert a["latency_v"] == b["latency_v"]
            np.testing.assert_allclose(a["logits"], b["logits"], rtol=1e-4,
                                       atol=1e-4)
