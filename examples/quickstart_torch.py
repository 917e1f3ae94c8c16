"""Quickstart of the PyTorch/CUDA port: the Helios components in ~80 lines.

The port's twin of ``quickstart.py``: a feature table on the storage tier,
the async IO stack, the policy-placed HBM / host / storage cache (its
lookup is the K1 kernel on the card) and tier migration under a drifting
hot set.  It runs on the card unless ``--device cpu`` is given (then every
kernel runs its plain version).

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \\
        --rows 5000 --dim 32
"""
import argparse
import tempfile

import numpy as np

from repro_torch.core.hetero_cache import HeteroCache
from repro_torch.core.iostack import AsyncIOEngine, FeatureStore
from repro_torch.core.policy import OnlineDecayPolicy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=50_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n = args.rows
    root = tempfile.mkdtemp(prefix="helios_quickstart_torch_")

    # 1. a "terabyte-scale" feature table striped over 12 storage shards
    store = FeatureStore(f"{root}/features", n_rows=n, row_dim=args.dim,
                         n_shards=12, create=True, rng_seed=0)
    print(f"storage tier: {store.n_rows} rows x {store.row_dim} "
          f"({store.n_rows * store.row_bytes / 1e6:.0f} MB over "
          f"{store.n_shards} shards)")

    # 2. the async IO stack: decoupled submission / completion
    io = AsyncIOEngine(store, worker_budget=0.3)     # "30% of cores"
    ticket = io.submit(np.arange(n // 5))            # returns immediately
    print(f"submitted {n // 5} reads (non-blocking); doing other work ...")
    data, virtual_s = ticket.wait()
    print(f"IO complete: {data.shape}, modeled time {virtual_s * 1e3:.2f} ms "
          f"({data.nbytes / virtual_s / 1e9:.1f} GB/s under the 12-SSD "
          f"envelope)")

    # 3. the heterogeneous cache: policy-placed HBM / host / storage tiers;
    # gathered rows come back as a tensor on the cache's device
    rng = np.random.default_rng(0)
    access = (rng.zipf(1.4, 4 * n) - 1) % n                 # skewed accesses
    hot = np.bincount(access, minlength=n)
    dev_rows, host_rows = n // 20, n // 10
    cache = HeteroCache(store, hot, device_rows=dev_rows, host_rows=host_rows,
                        io_engine=io, device=args.device)
    batch = np.unique(access[:3 * n // 5])
    feats = cache.gather(batch)
    st = cache.stats
    print(f"gathered {len(batch)} rows onto {feats.device}: "
          f"{st.device_hits} device / {st.host_hits} host / "
          f"{st.storage_misses} storage (hit rate {st.hit_rate:.0%})")
    print(f"tier times: device {st.virtual_device_s*1e3:.2f} ms, host "
          f"{st.virtual_host_s*1e3:.2f} ms, storage "
          f"{st.virtual_storage_s*1e3:.2f} ms -> pipelined batch time "
          f"{st.virtual_batch_time(True)*1e3:.2f} ms")

    # 4. online policy + tier migration: when the hot set drifts, the cache
    # re-derives placement from the live access stream and migrates rows
    policy = OnlineDecayPolicy(n, init_scores=hot, half_life=4,
                               refresh_every=4, hysteresis=0.05)
    cache = HeteroCache(store, None, device_rows=dev_rows,
                        host_rows=host_rows, io_engine=io, policy=policy,
                        device=args.device)
    drifted = (access + n // 2) % n                         # hot set moved
    step = n // 5
    for i in range(0, 12 * step, step):
        cache.gather(np.unique(drifted[i:i + step])[:2 * n // 25])
        cache.maybe_refresh()
    st = cache.stats
    print(f"after drift: hit rate {st.hit_rate:.0%} with {st.refreshes} "
          f"refreshes, {st.promotions} promotions / {st.demotions} "
          f"demotions ({st.migrated_bytes / 1e6:.0f} MB migrated "
          f"asynchronously)")
    io.close()
    return st


if __name__ == "__main__":
    main()
