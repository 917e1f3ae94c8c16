"""Serve out-of-core GNN inference with SLO-aware micro-batching, on the
PyTorch/CUDA port.

The port's twin of ``serve_gnn.py``: drives an open-loop Zipf workload
(seed popularity matches the synthetic graph's degree skew, so concurrent
requests share hot neighborhoods) through the port's inference server,
comparing the Helios async IO engine against the sync (GIDS-like) and
CPU-managed (Ginex-like) baselines.  It runs on the card unless
``--device cpu`` is given (then every kernel runs its plain version).
``HELIOS_CHAOS`` (e.g. ``seed=7,read_error_rate=0.02``) injects IO faults
that the engines retry; the retries are printed per engine.

    PYTHONPATH=src python examples/serve_gnn_torch.py [--requests 128]
    PYTHONPATH=src python examples/serve_gnn_torch.py --device cpu \\
        --requests 16 --vertices 3000 --dim 32 --trace serve.json
"""
import argparse
import tempfile

from repro_torch.core.iostack import FeatureStore
from repro_torch.gnn.graph import synth_graph
from repro_torch.serving import GNNInferenceServer, ServerConfig, zipf_workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--rate", type=float, default=60_000,
                    help="open-loop arrival rate (virtual req/s)")
    ap.add_argument("--vertices", type=int, default=30_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--model", default="sage", choices=["sage", "gcn"])
    ap.add_argument("--seeds-per-request", type=int, default=32)
    ap.add_argument("--cache-policy", default="static",
                    choices=["static", "online"],
                    help="online re-derives cache placement from the live "
                         "request stream (asynchronous tier migration)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="write a Chrome/Perfetto trace of every span "
                         "(admission, batch build, gather, forward, IO "
                         "tickets) to this path; same as HELIOS_TRACE")
    args = ap.parse_args(argv)

    from repro_torch.obs import trace as _trace
    if args.trace:
        _trace.install(args.trace)

    root = tempfile.mkdtemp(prefix="helios_serve_torch_")
    g = synth_graph(args.vertices, 8, skew=1.2, seed=0)
    store = FeatureStore(f"{root}/features", n_rows=args.vertices,
                         row_dim=args.dim, n_shards=12, create=True,
                         rng_seed=1)
    wl = zipf_workload(g.n_vertices, args.requests, args.seeds_per_request,
                       rate_rps=args.rate, degrees=g.degrees(), seed=1)
    print(f"graph: {g.n_vertices} vertices; {args.requests} requests "
          f"@ {args.rate:.0f} req/s open-loop, "
          f"{args.seeds_per_request} seeds each; device {args.device}")

    report = {}
    for mode in ("helios", "gids", "cpu"):
        cfg = ServerConfig(model=args.model, mode=mode,
                           request_batch_size=args.seeds_per_request,
                           fanouts=(8, 4), hidden=128,
                           device_cache_frac=0.02, host_cache_frac=0.05,
                           cache_policy=args.cache_policy,
                           refresh_every=4, policy_half_life=8.0,
                           max_batch_requests=8, seed=0, device=args.device)
        with GNNInferenceServer(g, store, cfg) as srv:
            for seeds, arrival, klass in wl:
                srv.submit(seeds, klass, arrival)
            st = srv.flush()
            cs = srv.cache.stats
            retries = srv.io.stats.retries
            print(f"[{mode:7s}] {st.served:4d} served, "
                  f"{st.rejected_total:3d} shed | {st.throughput_rps():8.0f} "
                  f"req/s | p50 {st.percentile(50)*1e6:7.0f} us | "
                  f"p99 {st.percentile(99)*1e6:7.0f} us | dedup saves "
                  f"{st.dedup_storage_savings:.0%} storage reads | cache hit "
                  f"{cs.hit_rate:.0%} ({cs.refreshes} refreshes) | IO "
                  f"retries {retries}")
        sm = st.summary()
        print(f"{'':9s} overlap {sm['overlap_efficiency']:.0%}, "
              f"bubble {sm['bubble_frac']:.0%}")
        report[mode] = {"served": st.served, "shed": st.rejected_total,
                        "retries": retries}

    tr = _trace.uninstall() if args.trace else None
    if tr is not None:
        tr.export(args.trace)
        print(f"trace: {len(tr.spans)} spans -> {args.trace} "
              f"(open at https://ui.perfetto.dev)")
    return report


if __name__ == "__main__":
    main()
