"""The port on the card: each CUDA kernel against its plain version, and
the cache and server on the card against themselves on the CPU.

Every case is marked ``gpu`` and skips without a CUDA device.  The file
imports no JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

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


def _backward_launches(ops) -> int:
    """Launches a K2 or K3 wrapper module counted for the other's
    backward."""
    return sum(n for use, n in ops.launches_by_use.items()
               if use[0] == "backward")


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


@pytest.mark.parametrize("row_bytes", [4, 12, 1020, 1024, 4112])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_gather_widths_bit_exact(dtype, row_bytes):
    """K2 against the plain version, bit for bit, at row widths that pick
    each copy unit, int32 and int64 indices and B from 1 to 65,537, on
    random indices and on sorted runs of repeated ones (the pairs the
    kernel loads once); an index outside the table gives a zero row."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(6)
    d = row_bytes // torch.tensor([], dtype=dtype).element_size()
    table = torch.randn(5000, d, generator=g, device=dev).to(dtype)
    for B in (1, 7, 640, 3904, 65537):
        rand = torch.randint(0, 5000, (B,), generator=g, device=dev)
        for idx in (rand, torch.sort(rand // 3).values):
            want = gather_rows_ref(table, idx)
            for ix in (idx, idx.to(torch.int32)):
                before = gather_ops.launches
                got = gather_ops.gather_rows(table, ix)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (B, ix.dtype)
                assert gather_ops.launches == before + 1
    idx = torch.tensor([3, -1, -1, 4999, 5000, 5000, 1 << 30, 0, 0],
                       device=dev)
    ok = (idx >= 0) & (idx < 5000)
    want = torch.zeros(idx.shape[0], d, dtype=dtype, device=dev)
    want[ok] = table[idx[ok]]
    assert torch.equal(gather_ops.gather_rows(table, idx), want)


def test_gpu_gather_misaligned_view_bit_exact():
    """A table view 4 bytes off a 16-byte boundary is copied in 4-byte
    units, bit-exact."""
    dev = _cuda()
    flat = torch.randn(3000 * 1024 + 1, device=dev)
    table = flat[1:].view(3000, 1024)
    for idx in (torch.randint(0, 3000, (3904,), device=dev),
                torch.sort(torch.randint(0, 1500, (3905,), device=dev)).values):
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


def _seg_ids(gen, pattern, E, n_seg):
    """Segment ids as chip_smoke.py's K3 edges draw them: one id over
    every edge, shuffled runs of 10 or 25, or unsorted with ids outside
    [0, n_seg)."""
    if pattern == "one_id":
        return torch.full((E,), 3, dtype=torch.int64)
    if pattern.startswith("runs"):
        f = int(pattern[4:])
        return torch.randperm(n_seg, generator=gen)[:-(-E // f)] \
            .repeat_interleave(f)[:E]
    return torch.randint(-3, n_seg + 3, (E,), generator=gen)


@pytest.mark.parametrize("D", [1, 3, 4, 255, 256, 1020, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_segment_sum_edge_set(dtype, D):
    """K3 within 1e-5 of the largest sum of its plain version at E in {0,
    1, 4,096, 65,537}: one id over 4,096 edges, shuffled runs of 10 and
    25, unsorted ids with out-of-range ones; int32 and int64 ids; every
    call on the route its width and type call for."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(D)
    mgen = torch.Generator(device=dev).manual_seed(D)
    vec = 4 if dtype == torch.float32 else 8
    route = "edges" if D <= 4 else "vec" if D % vec == 0 else "scalar"
    for E, pattern in ((4096, "one_id"), (4096, "runs25"), (65537, "runs10"),
                       (3000, "unsorted"), (1, "unsorted"), (0, "unsorted")):
        n_seg = max(E // 5, 8)
        seg = _seg_ids(gen, pattern, E, n_seg).to(dev)
        msgs = torch.randn(E, D, generator=mgen, device=dev).to(dtype)
        want = segment_sum_ref(msgs, seg, n_seg)
        for ix in (seg, seg.to(torch.int32)):
            before = seg_ops.route_launches[route]
            got = seg_ops.segment_sum(msgs, ix, n_seg)
            torch.cuda.synchronize()
            assert got.shape == (n_seg, D)
            if E:
                assert (got - want).abs().max() <= 1e-5 * max(
                    want.abs().max().item(), 1.0), (E, pattern, ix.dtype)
                assert seg_ops.route_launches[route] == before + 1


@pytest.mark.parametrize("route,dtype,D,offset", [
    ("edges", torch.float32, 1, 0), ("vec", torch.float32, 1024, 0),
    ("vec", torch.bfloat16, 256, 0), ("scalar", torch.float32, 255, 0),
    ("scalar", torch.float32, 1024, 1)])
def test_gpu_segment_sum_each_route(route, dtype, D, offset):
    """One call per route counts one launch on that route, and sums the
    served layer's shape (runs of 5 over 3,904 segments) within 1e-5; a
    message block 4 bytes off a 16-byte boundary takes the scalar route."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(9)
    E, n_seg = 3200, 3904
    flat = torch.randn(E * D + offset, generator=gen, device=dev).to(dtype)
    msgs = flat[offset:].view(E, D)
    seg = torch.randperm(n_seg, device=dev)[:E // 5].repeat_interleave(5)
    before = dict(seg_ops.route_launches)
    n = seg_ops.launches
    got = seg_ops.segment_sum(msgs, seg, n_seg)
    torch.cuda.synchronize()
    want = segment_sum_ref(msgs, seg, n_seg)
    assert (got - want).abs().max() <= 1e-5 * max(want.abs().max().item(),
                                                   1.0)
    assert seg_ops.launches == n + 1
    assert {r: seg_ops.route_launches[r] - before[r]
            for r in seg_ops.ROUTES} == {r: int(r == route)
                                         for r in seg_ops.ROUTES}


@pytest.mark.parametrize("B", [1023, 1024, 1025, 65537, 150000])
def test_gpu_lookup_multi_cta_bit_exact(B):
    """K1 bit-exact against its plain version across many 256-position
    tiles: random ids, a pool of 37 ids repeated across every tile, ids
    outside the tables, and all-host and all-miss tables; int32 and int64
    ids; the dedup table is reused from call to call."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(B)
    n, D = 200_000, 64
    dt = torch.randn(10_000, D, generator=gen).to(dev)
    ht = torch.randn(20_000, D, generator=gen).pin_memory()
    mixed = torch.multinomial(torch.tensor([0.05, 0.1, 0.6, 0.25]), n,
                              replacement=True, generator=gen)
    for loc in (mixed, torch.ones(n, dtype=torch.int64),
                torch.full((n,), 2)):
        slot = torch.where(loc == 0, torch.randint(0, 10_000, (n,),
                                                   generator=gen),
                           torch.randint(0, 20_000, (n,), generator=gen))
        args = (loc.to(torch.int32).to(dev), slot.to(torch.int32).to(dev))
        ids = torch.randint(0, n, (B,), generator=gen)
        pool = ids[:37][torch.randint(0, 37, (B,), generator=gen)]
        bad = ids.clone()
        bad[::97] = -1
        bad[5::101] = n + 3
        for x in (ids, pool, bad, pool.to(torch.int32)):
            x = x.to(dev)
            got = lookup_ops.fused_cache_lookup(x, *args, dt, ht)
            torch.cuda.synchronize()
            for k, (a, b) in enumerate(zip(got, fused_lookup_ref(
                    x, *args, dt, ht))):
                assert torch.equal(a, b), (k, B)


def test_gpu_lookup_threads_share_the_table():
    """Eight threads (more than the card machine's cores) call K1 at once
    on one stream, so their launches could interleave on it: each call's
    outputs stay bit-exact (the dedup table and host list they share are
    taken one call at a time)."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    dev = _cuda()
    gen = torch.Generator().manual_seed(21)
    n = 50_000
    loc = torch.multinomial(torch.tensor([0.1, 0.2, 0.5, 0.2]), n,
                            replacement=True, generator=gen)
    slot = torch.randint(0, 5_000, (n,), generator=gen)
    args = (loc.to(torch.int32).to(dev), slot.to(torch.int32).to(dev))
    dt = torch.randn(5_000, 32, generator=gen).to(dev)
    ht = torch.randn(5_000, 32, generator=gen).pin_memory()
    batches = [torch.randint(0, n // (1 + k % 3), (500 + 997 * k,),
                             generator=gen).to(dev) for k in range(64)]

    def one(ids):
        got = lookup_ops.fused_cache_lookup(ids, *args, dt, ht)
        torch.cuda.current_stream().synchronize()
        return all(torch.equal(a, b) for a, b in zip(
            got, fused_lookup_ref(ids, *args, dt, ht)))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(one, b) for b in batches]
            assert all(f.result(timeout=120) for f in futs)
    finally:
        sys.setswitchinterval(old)


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


def test_gpu_cache_kernel_matches_host_at_training_batch(tmp_path):
    """The cache's K1 kernel and its host fused plan gather the same bits,
    with the same stats, at a training-sized batch (100,000 ids with
    repeats over a 40,000-row store, 5% device and 10% host tiers)."""
    dev = _cuda()
    st = FeatureStore(str(tmp_path / "feats"), n_rows=40_000, row_dim=64,
                      n_shards=4, create=True, rng_seed=7)
    rng = np.random.default_rng(4)
    hot = rng.zipf(1.3, 200_000) % 40_000
    hot = np.bincount(hot, minlength=40_000)
    caches = [HeteroCache(st, hot, 2_000, 4_000,
                          make_engine("helios", st, chaos=None), device=dev,
                          fused_backend=b) for b in ("kernel", "host")]
    try:
        for _ in range(2):
            ids = rng.zipf(1.3, 100_000) % 40_000
            a, b = (c.gather(ids) for c in caches)
            assert torch.equal(a, b)
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


# ---------------------------------------------------------------------------
# LM serving kernels (K4, K5) and the LM path on the card
# ---------------------------------------------------------------------------

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, lse_ref, visible)
from repro_torch.kernels.rwkv_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv_scan.ref import wkv_ref  # noqa: E402
from repro_torch.models import lm, steps  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_gpu_flash_attention_matches_plain(dtype, causal):
    """K4 against its plain version on both routes: ragged S and T, hd
    32/64/80/128, GQA groups 1/3/8, a causal q_offset, and the model's
    layout read through strides (views of a packed qkv projection).
    float32 within 2e-5, bf16 within 2e-2.  bf16 at hd 64-128 takes the
    tensor-core route, everything else the CUDA-core route."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(4)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    cases = [(S, S, hd, G, off)
             for S, hd, G in ((1, 64, 1), (24, 80, 3), (129, 128, 8),
                              (1024, 128, 3), (1000, 64, 8), (24, 32, 3))
             for off in ((0, 5) if causal else (0,))]
    if causal:
        cases += [(100, 612, 128, 3, 512), (100, 612, 80, 1, 512)]
    if dtype == torch.bfloat16:
        cases.append((4096, 4096, 128, 3, 0))
    for S, T, hd, G, off in cases:
        K, B = 2, 2
        H = K * G
        qkv = torch.randn(B, max(S, T), H + 2 * K, hd, generator=g,
                          device=dev, dtype=torch.float32).to(dtype)
        q, k, v = qkv[:, :S, :H], qkv[:, :T, H:H + K], qkv[:, :T, H + K:]
        route = ("tensor_cores" if dtype == torch.bfloat16 and hd >= 64
                 else "cuda_cores")
        before = fa_ops.route_launches[route]
        got = fa_ops.flash_attention(q, k, v, causal, q_offset=off)
        torch.cuda.synchronize()
        want = attention_ref(q, k, v, causal, q_offset=off)
        assert (got.float() - want.float()).abs().max() <= tol, \
            (S, T, hd, G, off)
        assert fa_ops.route_launches[route] == before + 1, (S, hd, route)


def test_gpu_flash_attention_routes_count_and_refuse_misalignment():
    """Each route counts its own launches beside the total; a bf16 view at
    a tensor-core width whose pointer or strides TMA cannot take raises
    ValueError and launches nothing."""
    dev = _cuda()
    fa_ops.launches = 0
    fa_ops.route_launches = dict.fromkeys(fa_ops.ROUTES, 0)
    for dtype, hd in ((torch.bfloat16, 128), (torch.float32, 128),
                      (torch.bfloat16, 32), (torch.bfloat16, 80)):
        q = torch.randn(1, 8, 4, hd, device=dev).to(dtype)
        fa_ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    torch.cuda.synchronize()
    assert fa_ops.route_launches == {"tensor_cores": 2, "cuda_cores": 2}
    assert fa_ops.launches == 4
    shifted = torch.zeros(8 * 4 * 64 + 1, dtype=torch.bfloat16,
                          device=dev)[1:].view(1, 8, 4, 64)
    padded = torch.zeros(1, 8, 4, 68, dtype=torch.bfloat16,
                         device=dev)[..., :64]
    for t in (shifted, padded):
        with pytest.raises(ValueError, match="tensor-core route"):
            fa_ops.flash_attention(t, t[:, :, :2], t[:, :, :2])
    assert fa_ops.launches == 4


def test_gpu_flash_attention_refuses_other_forms():
    dev = _cuda()
    q = torch.zeros(1, 8, 4, 64, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q[..., :48], q[:, :, :2, :48],
                               q[:, :, :2, :48])
    with pytest.raises(TypeError, match="bfloat16"):
        fa_ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 8, 4, 128, device=dev)[..., ::2]
        fa_ops.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="H % K"):
        fa_ops.flash_attention(q, q[:, :, :3], q[:, :, :3])


def _k4_case(g, dev, dtype, S, T, hd, G, K=2, B=2):
    """q, k, v as views of one packed qkv projection, as the model makes
    them."""
    H = K * G
    qkv = torch.randn(B, max(S, T), H + 2 * K, hd, generator=g, device=dev,
                      dtype=torch.float32).to(dtype)
    return qkv[:, :S, :H], qkv[:, :T, H:H + K], qkv[:, :T, H + K:]


def _k4_check(q, k, v, causal, off, window, route, tol):
    before = fa_ops.route_launches[route]
    got = fa_ops.flash_attention(q, k, v, causal, off, window)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal, off, window)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (tuple(q.shape), tuple(k.shape), causal, off, window,
                        err)
    assert fa_ops.route_launches[route] == before + 1, route


@pytest.mark.parametrize("dtype,hd", [
    (torch.bfloat16, 64), (torch.bfloat16, 128), (torch.bfloat16, 256),
    (torch.float32, 64), (torch.float32, 256)])
def test_gpu_flash_attention_window_matches_plain(dtype, hd):
    """K4 with a local-attention window on both routes against its plain
    version: windows of 1, 7, 64, 127, 128, 129 and 2048 keys, causal and
    not, at ragged S and T, a causal q_offset, and recurrentgemma's S 4096
    at window 2048 (MQA, 10 query heads).  float32 within 2e-5, bf16
    within 2e-2; bf16 at hd 64/128/256 on the tensor cores, float32 on the
    CUDA cores."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(6)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    route = ("tensor_cores" if dtype == torch.bfloat16
             and hd in fa_ops.TENSOR_CORE_HEAD_DIMS else "cuda_cores")
    cases = [(S, S, G, causal, 0, w) for S, G in ((200, 3), (129, 1))
             for w in (1, 7, 64, 127, 128, 129) for causal in (True, False)]
    cases += [(100, 612, 3, True, 512, 64), (333, 333, 8, True, 0, 2048)]
    for S, T, G, causal, off, w in cases:
        q, k, v = _k4_case(g, dev, dtype, S, T, hd, G)
        _k4_check(q, k, v, causal, off, w, route, tol)
    if dtype == torch.bfloat16:
        q, k, v = _k4_case(g, dev, dtype, 4096, 4096, hd, 10, K=1, B=1)
        _k4_check(q, k, v, True, 0, 2048, route, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [96, 112, 256])
def test_gpu_flash_attention_new_head_widths(dtype, hd):
    """K4 at phi-3-vision's 96, kimi-k2's 112 (bf16: the tensor cores, the
    head padded to 128 by TMA's zero fill) and recurrentgemma's 256 (bf16:
    the tensor cores, 64-key tiles), causal and not, ragged S, GQA groups
    1, 3 and 10."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(hd)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    route = ("tensor_cores" if dtype == torch.bfloat16
             and hd in fa_ops.TENSOR_CORE_HEAD_DIMS else "cuda_cores")
    for S, G in ((1, 1), (24, 3), (129, 10), (1000, 3)):
        for causal in (True, False):
            q, k, v = _k4_case(g, dev, dtype, S, S, hd, G)
            _k4_check(q, k, v, causal, 0, 0, route, tol)
    q, k, v = _k4_case(g, dev, dtype, 100, 612, hd, 3)
    _k4_check(q, k, v, True, 512, 0, route, tol)


@pytest.mark.parametrize("case", ["mqa", "windows", "ragged"])
def test_gpu_flash_attention_hd256_tensor_cores(case):
    """K4's bf16 forward at hd 256 on the tensor cores (64-key tiles)
    against its plain version within 2e-2, at its new seams: MQA 10:1 at S
    1, 63, 64, 65 and 129; windows of 1, 2, 63, 64, 65, 66, 127 and 129,
    causal and not, and 2048 at recurrentgemma's S 4096 (MQA 10:1); ragged
    S and T with T % 64 != 0 (333, 100 over 612 at q_offset 512, with and
    without a window; 37 over 611 and 64 over 1500, non-causal).  A bf16
    view at hd 256 whose pointer TMA cannot take raises ValueError and
    launches nothing."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(256)
    if case == "mqa":
        for S in (1, 63, 64, 65, 129):
            for causal in (True, False):
                q, k, v = _k4_case(g, dev, torch.bfloat16, S, S, 256, 10, K=1)
                _k4_check(q, k, v, causal, 0, 0, "tensor_cores", 2e-2)
    elif case == "windows":
        for w in (1, 2, 63, 64, 65, 66, 127, 129):
            for causal in (True, False):
                q, k, v = _k4_case(g, dev, torch.bfloat16, 300, 300, 256, 10,
                                   K=1)
                _k4_check(q, k, v, causal, 0, w, "tensor_cores", 2e-2)
        q, k, v = _k4_case(g, dev, torch.bfloat16, 4096, 4096, 256, 10, K=1,
                           B=1)
        _k4_check(q, k, v, True, 0, 2048, "tensor_cores", 2e-2)
    else:
        for S, T, causal, off, w, G, K in (
                (333, 333, True, 0, 0, 3, 2), (100, 612, True, 512, 0, 10, 1),
                (100, 612, True, 512, 65, 10, 1), (37, 611, False, 0, 0, 1, 4),
                (64, 1500, False, 0, 0, 1, 4)):
            q, k, v = _k4_case(g, dev, torch.bfloat16, S, T, 256, G, K=K)
            _k4_check(q, k, v, causal, off, w, "tensor_cores", 2e-2)
        shifted = torch.zeros(8 * 4 * 256 + 1, dtype=torch.bfloat16,
                              device=dev)[1:].view(1, 8, 4, 256)
        before = fa_ops.launches
        with pytest.raises(ValueError, match="tensor-core route"):
            fa_ops.flash_attention(shifted, shifted[:, :, :1],
                                   shifted[:, :, :1])
        assert fa_ops.launches == before


def test_gpu_flash_attention_hd256_builds_without_spill():
    """The build log (``nvcc -Xptxas -v``) of the hd-256 tensor-core
    forward, ``flash_fwd_tc_kernel<256>``, shows no spill store or load."""
    _cuda()
    from repro_torch.kernels import build
    build.build_all(("flash_attention",))
    found = {n: r for n, r in build.ptxas_report("flash_attention").items()
             if "flash_fwd_tc_kernelILi256E" in n}
    assert len(found) == 1, found
    r, = found.values()
    assert r["registers"] and r["spill_stores"] == r["spill_loads"] == 0, r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_flash_attention_cross_ragged(dtype):
    """K4 non-causal at S != T with ragged T, whisper's shapes at hd 64: the
    cross-attention (64 queries over 1500 frames), the encoder (1500 x
    1500), and a few odd ones (1 x 1500, 37 x 611, 300 x 7)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(8)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    route = "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores"
    for S, T in ((64, 1500), (1500, 1500), (1, 1500), (37, 611), (300, 7)):
        q, k, v = _k4_case(g, dev, dtype, S, T, 64, 1, K=12)
        _k4_check(q, k, v, False, 0, 0, route, tol)


def test_gpu_wkv_matches_plain():
    """K5 against the exact recurrence over the clip range of logw, from a
    nonzero state: y and final state within 1e-4 of the largest
    magnitude."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    for T, N in ((1, 64), (17, 8), (64, 64), (300, 32)):
        for lw in (-1e-4, -0.5, -20.0, None):
            B, H = 2, 3
            r, k, v = (torch.randn(B, T, H, N, generator=g, device=dev)
                       for _ in range(3))
            logw = (torch.full((B, T, H, N), lw, device=dev) if lw is not None
                    else torch.clamp(-torch.exp(torch.randn(
                        B, T, H, N, generator=g, device=dev)), -20, -1e-4))
            u = torch.randn(H, N, generator=g, device=dev) * 0.3
            s0 = torch.randn(B, H, N, N, generator=g, device=dev)
            y, s = wkv_ops.wkv(r, k, v, logw, u, s0)
            torch.cuda.synchronize()
            yw, sw = wkv_ref(r, k, v, logw, u, s0)
            for a, b in ((y, yw), (s, sw)):
                assert bool(torch.isfinite(a).all())
                assert (a - b).abs().max() <= 1e-4 * max(
                    b.abs().max().item(), 1.0), (T, N, lw)


@pytest.mark.parametrize("N", [8, 16, 32, 64])
def test_gpu_wkv_sweep(N):
    """K5 against the exact recurrence at T in {0, 1, 5, 17, 64, 1000}, logw
    at -20, -6, -1e-4 and mixed over the clip range, with and without an
    initial state, for one (batch, head) and for 256: y and final state
    within 1e-4 of the largest magnitude."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(N)
    for T in (0, 1, 5, 17, 64, 1000):
        for lw in (-20.0, -6.0, -1e-4, None):
            for B, H in ((1, 1), (4, 64)):
                for with_state in (True, False):
                    r, k, v = (torch.randn(B, T, H, N, generator=g,
                                           device=dev) for _ in range(3))
                    logw = (torch.full((B, T, H, N), lw, device=dev)
                            if lw is not None else torch.clamp(-torch.exp(
                                2 * torch.randn(B, T, H, N, generator=g,
                                                device=dev)), -20, -1e-4))
                    u = torch.randn(H, N, generator=g, device=dev) * 0.3
                    s0 = (torch.randn(B, H, N, N, generator=g, device=dev)
                          if with_state else None)
                    got = wkv_ops.wkv(r, k, v, logw, u, s0)
                    torch.cuda.synchronize()
                    for a, b in zip(got, wkv_ref(r, k, v, logw, u, s0)):
                        assert bool(torch.isfinite(a).all())
                        if b.numel() == 0:
                            continue
                        err = (a - b).abs().max().item()
                        assert err <= 1e-4 * max(b.abs().max().item(), 1.0), \
                            (T, lw, B * H, with_state)


def test_gpu_wkv_refuses_other_forms():
    dev = _cuda()
    r = torch.zeros(1, 4, 2, 8, device=dev)
    u = torch.zeros(2, 8, device=dev)
    with pytest.raises(ValueError, match="head size"):
        z = torch.zeros(1, 4, 1, 128, device=dev)
        wkv_ops.wkv(z, z, z, z, torch.zeros(1, 128, device=dev))
    with pytest.raises(TypeError, match="float32"):
        wkv_ops.wkv(r.double(), r.double(), r.double(), r.double(),
                    u.double())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 2, 4, 8, device=dev).transpose(1, 2)
        wkv_ops.wkv(t, t, t, t, u)
    with pytest.raises(ValueError, match="state"):
        wkv_ops.wkv(r, r, r, r, u, torch.zeros(1, 2, 8, 4, device=dev))


@pytest.mark.parametrize("name", ["llama3.2-3b", "stablelm-3b", "rwkv6-7b"])
def test_gpu_lm_serving_matches_cpu(name):
    """Prefill (K4 or K5 on the card) and 4 greedy decode steps at
    ``.reduced()`` width in float32: logits and caches within 1e-4 of the
    same parameters on the CPU (plain versions)."""
    dev = _cuda()
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    cpu = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    # the same CPU generator draws the same numbers for either device
    card = lm.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    tok = torch.randint(0, cfg.vocab, (2, 24),
                        generator=torch.Generator().manual_seed(1))
    pre, dec = steps.make_prefill_step(cfg, extra_len=4), \
        steps.make_decode_step(cfg)
    (la, ca), (lb, cb) = pre(card, {"tokens": tok.to(dev)}), \
        pre(cpu, {"tokens": tok})
    for i in range(5):
        assert torch.allclose(la.cpu(), lb, rtol=1e-4, atol=1e-4), i
        for key in cb:
            assert torch.allclose(ca[key].cpu(), cb[key], rtol=1e-4,
                                  atol=1e-4), (i, key)
        nxt = torch.argmax(lb, -1)[:, None]
        (la, ca), (lb, cb) = dec(card, ca, nxt.to(dev), 24 + i), \
            dec(cpu, cb, nxt, 24 + i)


FAMILIES = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "recurrentgemma-2b",
            "phi-3-vision-4.2b", "whisper-small")


@pytest.mark.parametrize("name,dtype", [
    (n, d) for n in FAMILIES for d in ("float32", "bfloat16")
    # a bf16 rounding difference can flip an MoE top-k choice
    if d == "float32" or get_config(n).moe is None])
def test_gpu_lm_families_match_cpu(name, dtype):
    """Prefill (K4 on the card; recurrentgemma at window 8, so the band and
    the ring buffer act) and 8 greedy decode steps at ``.reduced()``
    width, from the same parameters and inputs (``launch.serve.
    prefill_batch``: tokens, stub-frontend embeddings, whisper's frames):
    logits and every cache leaf within 1e-4 of the CPU's (plain versions)
    in float32, within 5e-2 of the largest magnitude in bf16."""
    from repro_torch.launch.serve import prefill_batch
    dev = _cuda()
    kw = {"window": 8} if name == "recurrentgemma-2b" else {}
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype, **kw)
    cpu = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = lm.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    ba, bb = (prefill_batch(cfg, 2, 24, 30, d) for d in (dev, "cpu"))
    pre, dec = steps.make_prefill_step(cfg, q_chunk=16, extra_len=8), \
        steps.make_decode_step(cfg)
    (la, ca), (lb, cb) = pre(card, ba), pre(cpu, bb)

    def ok(a, b):
        a, b = a.cpu().float(), b.float()
        if dtype == "float32":
            return torch.allclose(a, b, rtol=1e-4, atol=1e-4)
        return (a - b).abs().max() <= 5e-2 * b.abs().max()
    for i in range(9):
        assert ok(la, lb), (i, "logits")
        want = lm.flat_cache(cb)
        for key, a in lm.flat_cache(ca).items():
            assert ok(a, want[key]), (i, key)
        if i == 8:
            break
        nxt = torch.argmax(lb, -1)[:, None]
        (la, ca), (lb, cb) = dec(card, ca, nxt.to(dev), 24 + i), \
            dec(cpu, cb, nxt, 24 + i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_backward_rules_launch_kernels_and_match_plain(dtype):
    """The model's chain gather -> mask -> segment sum on the card, with
    padded (id 0) and out-of-range ids: the gradients of the table and
    the mask through the kernels' backward rules (K3 for the gather, K2
    for the segment sum) against the plain versions' own autograd on the
    same card tensors, within 1e-5 (float32) or 1e-2 (bfloat16) of the
    largest gradient; each backward launches its kernel once."""
    dev = _cuda()
    g = torch.Generator().manual_seed(3)
    n, d, e, s = 5000, 256 if dtype == torch.float32 else 64, 40000, 3000
    table = torch.randn(n, d, generator=g).to(dtype)
    idx = torch.randint(0, n, (e,), generator=g)
    idx[e // 2:] = 0
    idx[::97] = n + 2
    dst = torch.randint(0, s, (e,), generator=g)
    dst[e // 2:] = 0
    dst[::89] = -1
    w = torch.rand(e, generator=g)
    w[e // 2:] = 0
    cot = torch.randn(s, d, generator=g)

    def run(gather, ssum):
        t = table.to(dev).requires_grad_(True)
        wt = w.to(dev).to(dtype).requires_grad_(True)
        out = ssum(gather(t, idx.to(dev)) * wt[:, None], dst.to(dev), s)
        out.backward(cot.to(dev))
        torch.cuda.synchronize()
        return t.grad.float().cpu(), wt.grad.float().cpu()
    before = (_backward_launches(gather_ops), _backward_launches(seg_ops))
    uses = (("backward", (s, d), e), ("backward", (e, d), e))
    by_use = [m.launches_by_use.get(u, 0)
              for m, u in zip((gather_ops, seg_ops), uses)]
    got = run(gather_ops.gather_rows, seg_ops.segment_sum)
    assert (_backward_launches(gather_ops) - before[0],
            _backward_launches(seg_ops) - before[1]) == (1, 1)
    # counted by use where they launch: K2 gathers the (s, d) gradient at
    # the e ids, K3 sums the (e, d) gradient
    assert [m.launches_by_use.get(u, 0) - n for m, u, n in zip(
        (gather_ops, seg_ops), uses, by_use)] == [1, 1]
    want = run(gather_rows_ref, segment_sum_ref)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= tol * b.abs().max()


@pytest.mark.parametrize("kw", [
    dict(mode="helios", prefetch_depth=1),
    dict(mode="helios-nopipe", train_embeddings=True,
         embedding_momentum=0.9, embedding_adam=0.99)])
def test_gpu_trainer_matches_cpu(tmp_path, kw):
    """The trainer on the card (K1, K2/K3 forward and backward) against
    itself on the CPU (plain versions), 6 batches: the same sampled
    batches, identical cache, IO (and write-back) stats and virtual_s;
    losses within 1e-4 relative and the final parameters within 1e-4
    (K3's atomics and cuBLAS sum in other orders, carried by AdamW)."""
    from repro_torch.gnn.train import OutOfCoreGNNTrainer, TrainerConfig
    from repro_torch.core.tree import tree_leaves
    dev = _cuda()
    g = synth_graph(4000, 8, seed=0)
    runs = []
    for where in (dev, "cpu"):
        store = FeatureStore(str(tmp_path / f"f_{where}"), 4000, 64,
                             n_shards=4, create=True, rng_seed=2,
                             writable=True)
        cfg = TrainerConfig(batch_size=64, fanouts=(5, 3), hidden=32,
                            presample_batches=2, chaos=None,
                            device=str(where), **kw)
        with OutOfCoreGNNTrainer(g, store, cfg) as tr:
            nodes, sample = [], tr.sampler.sample
            tr.sampler.sample = lambda s: nodes.append(sample(s)) or nodes[-1]
            before = (lookup_ops.launches, _backward_launches(gather_ops),
                      _backward_launches(seg_ops))
            out = tr.train(6)
            launched = (lookup_ops.launches - before[0],
                        _backward_launches(gather_ops) - before[1],
                        _backward_launches(seg_ops) - before[2])
            runs.append((out, nodes, [m["loss"] for m in tr.metrics_log],
                         [t.cpu() for t in tree_leaves(tr.state["params"])],
                         launched))
    (a, na, la, pa, ka), (b, nb, lb, pb, kb) = runs
    # K1 once per batch, and once per optimizer-table gather
    assert ka[0] >= 6 and min(ka) > 0 and kb == (0, 0, 0)
    for x, y in zip(na, nb):
        np.testing.assert_array_equal(x.nodes, y.nodes)
    for key in ("cache", "io", "virtual_s") + (
            ("writeback",) if "train_embeddings" in kw else ()):
        assert a[key] == b[key], key
    np.testing.assert_allclose(la, lb, rtol=1e-4)
    for x, y in zip(pa, pb):
        assert (x - y).abs().max() <= 1e-4


# ---------------------------------------------------------------------------
# scale-out: the cache's remote tier and the serving fleet on the card
# ---------------------------------------------------------------------------

from repro_torch.distributed.partition import (  # noqa: E402
    PartitionedFeatureStore, make_partition)
from repro_torch.distributed.remote_engine import \
    RemoteIOEngine  # noqa: E402


def test_gpu_remote_tier_cache_matches_cpu(tmp_path):
    """A cache over a 4-worker partitioned store and a RemoteIOEngine
    (me=0) on the card against the same on the CPU: peer-owned rows sit at
    base tier 3, K1 emits their first occurrences as its remote miss list,
    and the rows, CacheStats (wall time aside) and the engines' row
    counters are identical."""
    dev = _cuda()
    pstore = PartitionedFeatureStore(
        str(tmp_path / "fleet"), 2048, 64, make_partition("hash", 2048, 4),
        n_shards=2, create=True, rng_seed=5)
    hot = np.bincount(np.arange(4096) % 97 * 21 % 2048, minlength=2048)
    engines = [RemoteIOEngine(pstore, me=0, chaos=None) for _ in range(2)]
    caches = [HeteroCache(pstore, hot, 100, 200, eng, device=d)
              for eng, d in zip(engines, (dev, "cpu"))]
    rng = np.random.default_rng(3)
    before, remote_listed = lookup_ops.launches, 0
    try:
        assert caches[0].host_tier.is_pinned()
        assert (caches[0]._base_loc == 3).sum() > 1000
        for ids in (rng.integers(0, 2048, 300), np.repeat(np.arange(20), 9),
                    rng.integers(0, 2048, 1500), np.array([5]),
                    np.empty(0, np.int64)):
            pg = caches[0].submit_planned(ids)
            remote_listed += len(pg.plan[3][0])
            a = caches[0].complete_planned(pg)
            b = caches[1].gather(ids)
            assert a.device.type == "cuda"
            assert torch.equal(a.cpu(), b)
            np.testing.assert_array_equal(b.numpy(), pstore.read_rows(ids))
        assert lookup_ops.launches - before == 4 and remote_listed > 0
        va, vb = (c.stats()._values() for c in caches)
        va.pop("wall_s"), vb.pop("wall_s")
        assert va == vb and va["remote_hits"] > 0
        assert [(e.local_rows, e.remote_rows) for e in engines] == \
            [(engines[1].local_rows, engines[1].remote_rows)] * 2
    finally:
        for c in caches:
            c.close()
        for e in engines:
            e.close()


def test_gpu_fleet_matches_cpu(tmp_path):
    """A 2-replica fleet on the card against the same fleet on the CPU
    with the card's parameters: the same routes, the same answered
    requests, logits within 1e-4, the same invalidated rows after an
    owner-write, and the written rows read back on every replica."""
    from repro_torch.distributed.fleet import ServingFleet
    _cuda()
    g = synth_graph(2048, 8, skew=1.2, seed=0)
    kw = dict(request_batch_size=16, fanouts=(4, 3), hidden=32,
              max_batch_requests=4, presample_batches=1, chaos=None)
    rng = np.random.default_rng(2)
    reqs = [rng.choice(2048, 16, replace=False) for _ in range(12)]
    hot = np.arange(64)
    new = np.full((64, 64), 2.5, np.float32)
    runs, params = [], None
    for where in ("cuda", "cpu"):
        store = FeatureStore(str(tmp_path / where), 2048, 64, n_shards=4,
                             create=True, rng_seed=5, writable=True)
        with ServingFleet(g, store, n_replicas=2, seed=1, params=params,
                          cfg=ServerConfig(device=where, **kw)) as fleet:
            if params is None:
                params = {"layers": [{k: v.cpu() for k, v in lp.items()}
                                     for lp in fleet.params["layers"]],
                          "head": {k: v.cpu() for k, v in
                                   fleet.params["head"].items()}}
                assert fleet.replicas[0].cache.device_tier.is_cuda
            out = []
            for rnd in range(2):
                futs = [fleet.submit(s) for s in reqs]
                fleet.flush()
                out.append([(i, f.result()) for f, i in futs])
                if rnd == 0:
                    fleet.write_embeddings(hot, new)
            for i, rep in enumerate(fleet.replicas):
                fleet._settle_invalidations(i)
                assert torch.equal(rep.cache.gather(hot).cpu(),
                                   torch.from_numpy(new))
            assert fleet._settle_invalidations(0) == 0
            np.testing.assert_array_equal(store.read_rows(hot), new)
            runs.append((out, fleet.router.route_counts.copy(),
                         fleet.invalidated_rows))
    (oa, ra, ia), (ob, rb, ib) = runs
    np.testing.assert_array_equal(ra, rb)
    assert ia == ib > 0
    for rnd_a, rnd_b in zip(oa, ob):
        for (i, a), (j, b) in zip(rnd_a, rnd_b):
            assert i == j and (a is None) == (b is None)
            if a is not None:
                assert a["latency_v"] == b["latency_v"]
                np.testing.assert_allclose(a["logits"], b["logits"],
                                           rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# K4's backward (FlashAttentionFn) and the kernels without one
# ---------------------------------------------------------------------------

def _k4_grads(q, k, v, do, causal, q_offset, window, fn):
    """(out, dq, dk, dv) of ``fn`` at leaf copies of q, k, v."""
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*qkv, causal, q_offset, window)
    out.backward(do)
    return (out, *(t.grad for t in qkv))


# entry by entry: |got - want| <= rtol |want| + atol mean|want| + floor,
# (rtol, (atol of dq, dk, dv)) by dtype, as chip_smoke.py's K4_BWD_TOL:
# in bf16, dq and dk carry delta = rowsum(dO * O) from the forward's bf16
# output, which the plain version computes in float32; dv does not.  The
# floor: where a query sees one key, P = 1 and dS = 0, the exact dq and
# dk are zero and the kernel gives rounding noise.
K4_BWD_TOL = {torch.float32: (1e-5, (1e-3, 1e-3, 1e-3)),
              torch.bfloat16: (2 ** -6, (2 ** -2, 2 ** -2, 2 ** -8))}
K4_BWD_FLOOR = 1e-4
# and the largest |got - want| within this share of the largest |want|,
# or of 1 where that is smaller
K4_BWD_LARGEST = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _k4_bwd_ratio(a, b, rtol, atol):
    """The largest |a - b| / (rtol |b| + atol mean|b| + floor)."""
    b = b.float()
    return float(((a.float() - b).abs()
                  / (rtol * b.abs() + atol * float(b.abs().mean())
                     + K4_BWD_FLOOR)).max())


def _k4_bwd_check(q, k, v, causal, q_offset, window, g, fault=False):
    """The K4 autograd Function's dq, dk, dv against autograd through the
    plain version on the same card tensors, every entry within
    ``K4_BWD_TOL`` and the largest error within ``K4_BWD_LARGEST``; one
    forward and one backward launch counted, the backward on the route its
    dtype and width call for (bf16 at 64-256: the tensor cores; float32
    and bf16 at 8-32: the CUDA cores).  With
    ``fault``, one tile of 64 keys of dk, then of dv, zeroed from the
    middle key on must fail the same check."""
    do = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    route = ("tensor_cores" if q.dtype == torch.bfloat16
             and q.shape[3] in fa_ops.TENSOR_CORE_BWD_HEAD_DIMS
             else "cuda_cores")
    f0, b0 = fa_ops.launches, fa_ops.bwd_launches
    r0 = fa_ops.bwd_route_launches[route]
    out, *got = _k4_grads(q, k, v, do, causal, q_offset, window,
                          fa_ops.flash_attention)
    torch.cuda.synchronize()
    assert out.grad_fn is not None
    assert (fa_ops.launches, fa_ops.bwd_launches) == (f0 + 1, b0 + 1)
    assert fa_ops.bwd_route_launches[route] == r0 + 1, route
    _, *want = _k4_grads(q, k, v, do, causal, q_offset, window,
                         attention_ref)
    rtol, atols = K4_BWD_TOL[q.dtype]
    for name, a, b, atol in zip(("dq", "dk", "dv"), got, want, atols):
        assert a.dtype == b.dtype == q.dtype and a.shape == b.shape
        r = _k4_bwd_ratio(a, b, rtol, atol)
        largest = float((a.float() - b.float()).abs().max()) / max(
            float(b.float().abs().max()), 1.0)
        assert r <= 1 and largest <= K4_BWD_LARGEST[q.dtype], (
            name, r, largest, tuple(q.shape), tuple(k.shape), causal,
            q_offset, window)
    if fault:
        lo = (k.shape[1] // 2) // 64 * 64
        for i in (1, 2):
            bad = got[i].clone()
            bad[:, lo:lo + 64] = 0
            assert _k4_bwd_ratio(bad, want[i], rtol, atols[i]) > 1, i


def test_gpu_flash_attention_bwd_forms():
    """K4's backward over the forms the forward takes, drawn by
    hypothesis: float32 and bf16 at every head width, GQA and MQA, ragged
    S and T with S != T, causal or not, a q_offset, a window, q/k/v as
    views of one packed projection or contiguous.  Every entry within
    ``K4_BWD_TOL``: float32 to its summation order (atomics add dq in any
    order), bf16 to two bf16 steps, and for dq and dk to delta = rowsum(dO
    * O), whose O is the forward's bf16 output with P rounded to bf16 on
    the tensor cores."""
    from hypothesis import given, settings
    from hypothesis import strategies as st
    dev = _cuda()

    @settings(max_examples=80, deadline=None, derandomize=True)
    @given(dtype=st.sampled_from([torch.float32, torch.bfloat16]),
           hd=st.sampled_from(fa_ops.HEAD_DIMS), K=st.integers(1, 3),
           G=st.integers(1, 4), B=st.integers(1, 2), S=st.integers(1, 160),
           T=st.integers(1, 160), causal=st.booleans(),
           offset=st.sampled_from(["zero", "end", "some"]),
           window=st.sampled_from([0, 0, 1, 7, 64, 100]),
           packed=st.booleans(), seed=st.integers(0, 2 ** 16))
    def check(dtype, hd, K, G, B, S, T, causal, offset, window, packed,
              seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        H = K * G
        q_offset = {"zero": 0, "end": max(T - S, 0),
                    "some": seed % 40}[offset]
        if packed:
            qkv = torch.randn(B, max(S, T), H + 2 * K, hd, generator=g,
                              device=dev).to(dtype)
            q, k, v = (qkv[:, :S, :H], qkv[:, :T, H:H + K],
                       qkv[:, :T, H + K:])
        else:
            q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
            k, v = (torch.randn(B, T, K, hd, generator=g,
                                device=dev).to(dtype) for _ in range(2))
        _k4_bwd_check(q, k, v, causal, q_offset, window, g)

    check()


@pytest.mark.parametrize("form", [
    "mqa", "window_seams", "offset", "ragged", "packed", "groups"])
def test_gpu_flash_attention_bwd_hd256_forms(form):
    """K4's bf16 backward at hd 256 on the tensor cores (64-key dK/dV CTAs
    in head groups, 32-key dQ tiles) against the plain version's autograd
    within ``K4_BWD_TOL``, with one 64-key tile of dk, then of dv, zeroed
    failing that (where queries see those keys and dk is not 0 exactly:
    not at S 1 or window 1): MQA 10:1 at S 1, 64, 65 and 200, causal or
    not; windows
    1, 2, 34, 63, 64, 65 and 66 at S 300; S 100 over T 612 at q_offset 512
    with and without a window; ragged S and T (37 over 611 non-causal, 150
    over 170 GQA 3:1 at an offset, window 65); q/k/v as views of one
    packed projection; and S 1024 at window 512, where the head-group rule
    splits the 10 heads into 8 groups."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(256 + len(form))
    bf = torch.bfloat16

    def case(B, S, T, H, K, causal, off, window):
        q = torch.randn(B, S, H, 256, generator=g, device=dev).to(bf)
        k, v = (torch.randn(B, T, K, 256, generator=g, device=dev).to(bf)
                for _ in range(2))
        # the planted fault zeroes keys T // 2 ... of dk and dv: a fault only
        # where some query sees them, and not where each query sees one key
        # (S 1, window 1: P = 1, dS = 0, the exact dk is 0)
        lo = (T // 2) // 64 * 64
        seen = bool(visible(S, T, causal, off, window)[:, lo:lo + 64].any())
        _k4_bwd_check(q, k, v, causal, off, window, g,
                      fault=seen and S > 1 and window != 1)
    if form == "mqa":
        for S in (1, 64, 65, 200):
            for causal in (True, False):
                case(1, S, S, 10, 1, causal, 0, 0)
    elif form == "window_seams":
        for w in (1, 2, 34, 63, 64, 65, 66):
            case(1, 300, 300, 10, 1, True, 0, w)
        case(2, 300, 300, 10, 1, False, 0, 66)
    elif form == "offset":
        for w in (0, 64, 129):
            case(1, 100, 612, 10, 1, True, 512, w)
    elif form == "ragged":
        case(1, 37, 611, 5, 1, False, 0, 0)
        case(2, 150, 170, 6, 2, True, 20, 65)
    elif form == "packed":
        qkv = torch.randn(2, 333, 12 + 2 * 4, 256, generator=g,
                          device=dev).to(bf)
        _k4_bwd_check(qkv[:, :, :12], qkv[:, :, 12:16], qkv[:, :, 16:],
                      True, 0, 100, g, fault=True)
    else:
        assert fa_ops.bwd_head_groups(
            1, 1024, 1, 10, 256,
            torch.cuda.get_device_properties(dev).multi_processor_count) > 1
        case(1, 1024, 1024, 10, 1, True, 0, 512)


# (label, B, S, T, H, K, hd, causal, window): chip_smoke.py's phase
# lm_train (a) shapes
K4_BWD_SHAPES = (
    ("llama3.2-3b layer 0, train_4k", 1, 4096, 4096, 24, 8, 128, True, 0),
    ("whisper-small cross-attention", 2, 64, 1500, 12, 12, 64, False, 0),
    ("recurrentgemma-2b window", 1, 4096, 4096, 10, 1, 256, True, 2048),
    ("ragged small", 3, 37, 53, 6, 2, 8, True, 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K4_BWD_SHAPES, ids=lambda s: s[0])
def test_gpu_flash_attention_bwd_model_shapes(shape, dtype):
    """K4's backward at the training shapes chip_smoke.py times, against
    the plain version's autograd, with the tolerances of
    ``test_gpu_flash_attention_bwd_forms``; a key tile of dk or dv zeroed
    fails them."""
    dev = _cuda()
    _, B, S, T, H, K, hd, causal, window = shape
    g = torch.Generator(device=dev).manual_seed(hd + S)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, T, K, hd, generator=g, device=dev).to(dtype)
            for _ in range(2))
    _k4_bwd_check(q, k, v, causal, 0, window, g, fault=True)


def test_gpu_flash_attention_keeps_grad_fn():
    """On CUDA inputs that require grad, K4's output carries a grad_fn
    (FlashAttentionFn) and its gradient reaches q, k and v; without grad
    (no_grad, or inputs that do not require it) the plain launch records
    nothing."""
    dev = _cuda()
    q = torch.randn(1, 16, 4, 64, device=dev, requires_grad=True)
    k = torch.randn(1, 16, 2, 64, device=dev, requires_grad=True)
    v = torch.randn(1, 16, 2, 64, device=dev)
    out = fa_ops.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.sum().backward()
    assert q.grad.abs().sum() > 0 and k.grad.abs().sum() > 0
    with torch.no_grad():
        assert fa_ops.flash_attention(q, k, v).grad_fn is None
    assert fa_ops.flash_attention(q.detach(), k.detach(), v).grad_fn is None


def test_gpu_wkv_refuses_grad():
    """K5 has no backward: on the card, under grad with an input that
    requires grad, ``wkv`` raises NotImplementedError naming the queued
    backward and launches nothing; under no_grad it runs."""
    dev = _cuda()
    B, T, H, N = 1, 8, 2, 16
    r, k, v = (torch.randn(B, T, H, N, device=dev) for _ in range(3))
    logw = -torch.rand(B, T, H, N, device=dev) - 0.1
    u = torch.randn(H, N, device=dev, requires_grad=True)
    before = wkv_ops.launches
    with pytest.raises(NotImplementedError, match="backward"):
        wkv_ops.wkv(r, k, v, logw, u)
    assert wkv_ops.launches == before
    with torch.no_grad():
        y, _ = wkv_ops.wkv(r, k, v, logw, u)
    assert wkv_ops.launches == before + 1 and y.grad_fn is None


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 80),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 256),
                                      (torch.float32, 128),
                                      (torch.float32, 8)])
def test_gpu_flash_attention_saves_lse(dtype, hd):
    """The forward's saved log-sum-exp (``flash_attention_fwd``) on both
    routes against ``lse_ref`` on the same card tensors: within 1e-4 of 1
    + |lse| (float32 scores, each route's own summation order), +inf
    exactly where a query sees no key (a window past the last keys), and
    the output the same as ``flash_attention``'s, bit for bit."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(hd)
    for S, T, causal, q_offset, window in ((200, 200, True, 0, 0),
                                           (37, 150, False, 0, 0),
                                           (24, 60, True, 70, 16),
                                           (129, 300, True, 171, 0)):
        q = torch.randn(2, S, 6, hd, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(2, T, 2, hd, generator=g, device=dev).to(dtype)
                for _ in range(2))
        route = fa_ops.route_of(q, k, v)
        before = fa_ops.route_launches[route]
        o, lse = fa_ops.flash_attention_fwd(q, k, v, causal, q_offset,
                                            window)
        torch.cuda.synchronize()
        assert fa_ops.route_launches[route] == before + 1
        want = lse_ref(q, k, causal, q_offset, window)
        none = torch.isinf(want)
        assert torch.equal(torch.isinf(lse), none) and (lse[none] > 0).all()
        err = (lse[~none] - want[~none]).abs() / (1 + want[~none].abs())
        assert float(err.max()) <= 1e-4, (S, T, route, float(err.max()))
        assert torch.equal(o, fa_ops.flash_attention(q, k, v, causal,
                                                     q_offset, window))


def test_gpu_flash_attention_bwd_repeats_bit_for_bit():
    """The tensor-core backward adds nothing by atomics: the same backward
    twice on the same inputs gives identical dq, dk and dv, at llama's
    GQA shape (causal) and at a ragged windowed one with q/k/v views of
    one packed projection; and at hd 256, recurrentgemma-2b's layer (MQA
    10:1, S 4096, window 2048: two head groups added in order) and a
    ragged packed one."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(1, 333, 12 + 2 * 4, 128, generator=g,
                      device=dev).to(torch.bfloat16)
    wide = torch.randn(1, 333, 12 + 2 * 4, 256, generator=g,
                       device=dev).to(torch.bfloat16)
    cases = [
        tuple(torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
              for shape in ((2, 1024, 24, 128), (2, 1024, 8, 128),
                            (2, 1024, 8, 128))) + (True, 0, 0),
        (qkv[:, :, :12], qkv[:, :, 12:16], qkv[:, :, 16:], True, 0, 100),
        tuple(torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
              for shape in ((1, 4096, 10, 256), (1, 4096, 1, 256),
                            (1, 4096, 1, 256))) + (True, 0, 2048),
        (wide[:, :, :12], wide[:, :, 12:16], wide[:, :, 16:], True, 0, 100)]
    for q, k, v, causal, q_offset, window in cases:
        do = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
        o, lse = fa_ops.flash_attention_fwd(q, k, v, causal, q_offset,
                                            window)
        before = fa_ops.bwd_route_launches["tensor_cores"]
        a, b = (fa_ops.flash_attention_bwd(q, k, v, o, do, causal, q_offset,
                                           window, lse=lse)
                for _ in range(2))
        torch.cuda.synchronize()
        assert fa_ops.bwd_route_launches["tensor_cores"] == before + 2
        for x, y in zip(a, b):
            assert torch.isfinite(x.float()).all() and torch.equal(x, y)
