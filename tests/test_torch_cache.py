"""The port's ``HeteroCache`` against the reference package's, each over
its own ``FeatureStore`` built with the same arguments and seed.

For every engine mode (helios/gids/cpu) and lookup path — fused (the K1
kernel's plain version on the CPU; the reference runs its host backend,
which the kernel tests hold bit-identical to its Pallas kernel), ``host``
and ``fused=False`` — gathered rows are bit-identical, and the occurrence
stats, IO stats, per-gather ``io_virt`` and virtual seconds are equal.
Refresh, prefetch and the write paths (write_planned, apply_delta, flush)
are held to the same standard."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.hetero_cache import HeteroCache as RefCache  # noqa: E402
from repro.core.iostack import FeatureStore as RefStore  # noqa: E402
from repro.core.iostack import make_engine as ref_engine  # noqa: E402
from repro.core.policy import make_policy as ref_policy  # noqa: E402
from repro_torch.core.hetero_cache import HeteroCache  # noqa: E402
from repro_torch.core.iostack import FeatureStore, make_engine  # noqa: E402
from repro_torch.core.policy import make_policy  # noqa: E402

N_ROWS, ROW_DIM, SHARDS = 2048, 32, 4
PATHS = {   # port kwargs, reference kwargs
    "fused": (dict(fused=True), dict(fused=True, fused_backend="host")),
    "host": (dict(fused=True, fused_backend="host"),
             dict(fused=True, fused_backend="host")),
    "plan": (dict(fused=False), dict(fused=False)),
}


def _stores(root, writable=False):
    kw = dict(n_rows=N_ROWS, row_dim=ROW_DIM, n_shards=SHARDS, create=True,
              rng_seed=11, writable=writable)
    return (RefStore(os.path.join(root, "ref"), **kw),
            FeatureStore(os.path.join(root, "port"), **kw))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    ref, port = _stores(str(tmp_path_factory.mktemp("cache_parity")))
    for s in range(SHARDS):
        with open(os.path.join(ref.path, f"shard_{s}.bin"), "rb") as a, \
                open(os.path.join(port.path, f"shard_{s}.bin"), "rb") as b:
            assert a.read() == b.read()
    return ref, port


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    hot = np.arange(N_ROWS) % 97            # skewed: low ids recur
    out = [rng.choice(hot, 300) * 21 % N_ROWS for _ in range(3)]
    out.append(rng.integers(0, N_ROWS, 250))
    out.append(np.repeat(out[0][:20], 15))   # duplicate-heavy
    out.append(np.array([7]))
    out.append(np.empty(0, np.int64))
    return out


def _no_wall(values: dict) -> dict:
    return {k: v for k, v in values.items() if not k.startswith("wall")}


def _pair(stores, mode, path, policy=None, **kw):
    ref_store, port_store = stores
    hot = np.bincount(np.concatenate(_batches(1)), minlength=N_ROWS)
    pk, rk = PATHS[path]
    caches = []
    for store, eng, cache, pol, extra in (
            (ref_store, ref_engine, RefCache, ref_policy, rk),
            (port_store, make_engine, HeteroCache, make_policy,
             dict(pk, device="cpu"))):
        p = (pol(policy, N_ROWS, presample=hot, refresh_every=1,
                 half_life=2.0, hysteresis=0.0) if policy else None)
        caches.append(cache(store, None if policy else hot, 100, 200,
                            eng(mode, store, chaos=None), policy=p,
                            **extra, **kw))
    return caches


def _close(*caches):
    for c in caches:
        c.close()
        c.io.close()


def _gather_equal(ref, port, ids, n_rows=None, clean=True):
    pr = ref.submit_planned(ids, n_rows=n_rows)
    pp = port.submit_planned(ids, n_rows=n_rows)
    a = ref.complete_planned(pr)
    b = port.complete_planned(pp)
    assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
    np.testing.assert_array_equal(b.numpy(), a)
    if clean:       # no dirty rows: storage holds every current value
        np.testing.assert_array_equal(a[:len(ids)], ref.store.read_rows(ids))
    assert (pp.n_device, pp.n_host, pp.n_storage, pp.n_remote) == \
        (pr.n_device, pr.n_host, pr.n_storage, pr.n_remote)
    assert pp.io_virt == pr.io_virt


def _stats_equal(ref, port):
    assert _no_wall(port.stats()._values()) == _no_wall(ref.stats()._values())
    rs, ps = ref.io.stats, port.io.stats
    assert _no_wall(ps._values()) == _no_wall(rs._values())
    assert ps.by_class == rs.by_class


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("mode", ["helios", "gids", "cpu"])
def test_gathers_and_stats_bit_identical(stores, mode, path):
    ref, port = _pair(stores, mode, path)
    try:
        assert port.device_tier.device.type == "cpu"
        assert not port.host_tier.is_pinned()      # pinned only on a card
        for i, ids in enumerate(_batches()):
            _gather_equal(ref, port, ids, n_rows=len(ids) + 5 if i == 1
                          else None)
        _stats_equal(ref, port)
    finally:
        _close(ref, port)


@pytest.mark.parametrize("path", ["fused", "plan"])
def test_refresh_and_prefetch_bit_identical(stores, path):
    """Online policy: every gather feeds the policy, placement migrates
    rows between tiers (device-tier reads through K2's plain version) and
    prefetch admits rising rows; tables, results and gathers all agree."""
    ref, port = _pair(stores, "helios", path, policy="online")
    try:
        for seed in range(3):
            for ids in _batches(seed)[:4]:
                _gather_equal(ref, port, ids)
                a, b = ref.maybe_refresh(), port.maybe_refresh()
                assert (a is None) == (b is None)
                if a is not None:
                    assert vars(a) == vars(b)
                np.testing.assert_array_equal(ref.loc, port.loc)
                np.testing.assert_array_equal(ref.slot, port.slot)
                a, b = ref.maybe_prefetch(16), port.maybe_prefetch(16)
                assert (a is None) == (b is None)
                if a is not None:
                    assert vars(a) == vars(b)
        np.testing.assert_array_equal(port.device_tier.numpy(),
                                      np.asarray(ref.device_tier))
        np.testing.assert_array_equal(port.host_tier.numpy(),
                                      ref.host_tier)
        assert ref.stats.refreshes > 0 and ref.stats.promotions > 0
        _stats_equal(ref, port)
    finally:
        _close(ref, port)


def test_write_paths_bit_identical(tmp_path):
    """write_planned / apply_delta on device-, host- and storage-resident
    rows, a refresh that demotes dirty rows, an invalidate and the flush
    barrier: gathers, stats and the flushed store agree exactly."""
    stores = _stores(str(tmp_path), writable=True)
    ref, port = _pair(stores, "helios", "fused", policy="online",
                      journal=False)
    rng = np.random.default_rng(4)
    try:
        for step in range(4):
            ids = rng.integers(0, N_ROWS, 120)
            rows = rng.normal(size=(120, ROW_DIM)).astype(np.float32)
            wa = ref.write_planned(ids, rows)
            wb = port.write_planned(ids, rows)
            assert vars(wa) == vars(wb)
            ids = rng.integers(0, N_ROWS, 80)
            delta = rng.normal(size=(80, ROW_DIM)).astype(np.float32)
            assert vars(ref.apply_delta(ids, delta)) == \
                vars(port.apply_delta(ids, delta))
            _gather_equal(ref, port, rng.integers(0, N_ROWS, 200),
                          clean=False)
            a, b = ref.maybe_refresh(), port.maybe_refresh()
            assert (a is None) == (b is None)
            if a is not None:
                assert vars(a) == vars(b)
            assert ref.invalidate_rows(ids[:10]) == \
                port.invalidate_rows(ids[:10])
        assert vars(ref.flush()) == vars(port.flush())
        np.testing.assert_array_equal(
            stores[1].read_rows(np.arange(N_ROWS)),
            stores[0].read_rows(np.arange(N_ROWS)))
        _stats_equal(ref, port)
    finally:
        _close(ref, port)

