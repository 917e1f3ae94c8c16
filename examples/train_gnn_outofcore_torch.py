"""End-to-end driver of the PyTorch/CUDA port: out-of-core GNN training.

The port's twin of ``train_gnn_outofcore.py``: trains GraphSAGE on a
synthetic power-law graph whose features live on the storage tier,
comparing Helios against the serial and CPU-managed baselines.  It runs on
the card unless ``--device cpu`` is given (then every kernel runs its
plain version).

    PYTHONPATH=src python examples/train_gnn_outofcore_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_gnn_outofcore_torch.py --device cpu \\
        --steps 20 --vertices 5000
"""
import argparse
import tempfile

from repro_torch.core.iostack import FeatureStore
from repro_torch.gnn.graph import synth_graph
from repro_torch.gnn.train import OutOfCoreGNNTrainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--vertices", type=int, default=50_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--model", default="sage", choices=["sage", "gcn"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--train-embeddings", action="store_true",
                    help="treat the feature rows as trainable embeddings: "
                         "gradient updates ride the cache write-back tiers "
                         "and flush to storage at the epoch barrier")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="write a Chrome/Perfetto trace of every span "
                         "(pipeline phases, IO tickets, cache ops) to this "
                         "path")
    args = ap.parse_args(argv)

    from repro_torch.obs import trace as _trace
    if args.trace:
        _trace.install(args.trace)

    root = tempfile.mkdtemp(prefix="helios_gnn_torch_")
    g = synth_graph(args.vertices, 10, skew=1.2, seed=0)

    def make_store(tag=""):
        return FeatureStore(f"{root}/features{tag}", n_rows=args.vertices,
                            row_dim=args.dim, n_shards=12, create=True,
                            rng_seed=1, writable=args.train_embeddings)

    store = make_store()
    print(f"graph: {g.n_vertices} vertices, {g.n_edges} edges; features "
          f"{store.n_rows * store.row_bytes / 1e6:.0f} MB on storage tier; "
          f"device {args.device}")

    for mode in ("helios", "helios-nopipe", "cpu"):
        if args.train_embeddings and mode != "helios":
            # trainable embeddings MUTATE the store: each mode gets a fresh
            # identically-seeded copy so the loss comparison stays fair
            store = make_store(f"_{mode}")
        cfg = TrainerConfig(model=args.model, mode=mode, batch_size=512,
                            fanouts=(10, 5), hidden=256,
                            device_cache_frac=0.05, host_cache_frac=0.10,
                            train_embeddings=args.train_embeddings,
                            device=args.device)
        with OutOfCoreGNNTrainer(g, store, cfg) as tr:
            n = args.steps if mode == "helios" else max(20, args.steps // 10)
            out = tr.train(n)
        print(f"[{mode:14s}] {n:4d} steps | loss {out['loss_first']:.3f} -> "
              f"{out['loss_last']:.3f} | virt/batch "
              f"{out['virtual_per_batch_s']*1e3:.2f} ms | cache hit "
              f"{out['cache']['hit_rate']:.0%} | wall {out['wall_s']:.1f}s "
              f"({out['wall_s'] * 1e3 / n:.1f} ms/batch)")
        if args.train_embeddings:
            wb = out["writeback"]
            print(f"{'':16s} wrote {wb['written_rows']} embedding rows "
                  f"({wb['write_through_rows']} through, "
                  f"{wb['flushed_rows']} flushed on demote/barrier)")
        if "obs" in out:
            ob = out["obs"]
            print(f"{'':16s} overlap {ob['overlap_efficiency']:.0%}, bubble "
                  f"{ob['bubble_frac']:.0%}, span coverage {ob['coverage']:.0%}"
                  f" ({ob['n_spans']} spans)")

    tr = _trace.TRACER
    if args.trace and tr is not None:
        tr.export(args.trace)
        print(f"trace: {len(tr.spans)} spans -> {args.trace}")


if __name__ == "__main__":
    main()
