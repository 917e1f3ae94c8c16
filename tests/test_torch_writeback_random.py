"""Random interleavings of the cache's read, write, refresh, prefetch,
flush and invalidate legs on both packages' ``HeteroCache`` and on a
plain shadow model (last writer wins, deltas summed): the reference's
``tests/test_writeback.py:382`` and ``:686`` widened to split-phase
gathers, ``apply_delta``, ``wait=False`` writes completed at random,
split-phase prefetches and flushes, and invalidations
(``tests/writeback_compare.py`` drives them).

16 seeds of 60 operations under each ``write_policy`` and
``write_combine_rows`` in {0, 16}; the seed picks the engine mode (the
four of ``test_writeback.py:382``) and the port's lookup (K1's plain
version or the numpy one) so that every pair of the two runs twice in
each cell.  Every gather equals the shadow and the other package bit for
bit; after every operation the caches' state is held equal
(``writeback_compare.compare_caches``); after a final flush each store alone
reproduces the shadow.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.iostack as r_io  # noqa: E402
from repro.core.hetero_cache import HeteroCache as RefCache  # noqa: E402
import repro_torch.core.iostack as t_io  # noqa: E402
from repro_torch.core.hetero_cache import HeteroCache  # noqa: E402
from writeback_compare import Interleaving, compare_caches  # noqa: E402

N_ROWS, ROW_DIM, N_SHARDS = 2048, 16, 4
DEV_ROWS, HOST_ROWS = 48, 96
SEEDS = 16
ENGINES = ("helios", "helios-legacy", "gids", "cpu")
BACKENDS = ("kernel", "host")
TIMED = {"helios", "helios-legacy"}


def _engine(io, store, mode):
    if mode == "gids":
        return io.SyncIOEngine(store, chaos=None)
    if mode == "cpu":
        return io.CPUManagedEngine(store, chaos=None)
    return io.AsyncIOEngine(store, striped=mode == "helios", chaos=None)


@pytest.mark.parametrize("seed", range(SEEDS))
@pytest.mark.parametrize("combine", [0, 16])
@pytest.mark.parametrize("policy", ["writeback", "writethrough"])
def test_random_interleaving_matches_reference(tmp_path, policy, combine,
                                               seed):
    mode = ENGINES[seed % len(ENGINES)]
    backend = BACKENDS[seed // len(ENGINES) % len(BACKENDS)]
    kw_store = dict(n_rows=N_ROWS, row_dim=ROW_DIM, n_shards=N_SHARDS,
                    create=True, rng_seed=seed, writable=True)
    kw = dict(write_policy=policy, write_combine_rows=combine)
    hot = np.arange(N_ROWS)[::-1].astype(float)
    rs = r_io.FeatureStore(str(tmp_path / "ref"), **kw_store)
    ts = t_io.FeatureStore(str(tmp_path / "port"), **kw_store)
    ref = RefCache(rs, hot, DEV_ROWS, HOST_ROWS, _engine(r_io, rs, mode),
                   fused_backend="host", **kw)
    port = HeteroCache(ts, hot.copy(), DEV_ROWS, HOST_ROWS,
                       _engine(t_io, ts, mode), device="cpu",
                       fused_backend=backend, **kw)
    timed = mode in TIMED

    def check(op, results, quiet):
        compare_caches(ref, port, quiet=quiet, timed=timed)

    try:
        it = Interleaving([ref, port], [rs, ts], seed=1000 + seed,
                          check=check, timed=timed)
        counts = it.run()
    finally:
        for c in (ref, port):
            c.close()
            c.io.close()
    assert sum(counts.values()) == it.n_ops
    assert counts["write"] + counts["delta"] > 0
    if combine and policy == "writeback":
        assert ref.stats.flushed_rows > 0
