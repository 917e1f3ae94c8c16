"""Perf hillclimb driver: dry-run variant configs, record roofline deltas
(PyTorch port of ``repro.launch.hillclimb``).

Each variant is (name, hypothesis, config-transform), the reference's three
chains (the hypotheses' TPU memory sizes left out), run through the port's ``build_cell`` on fake tensors
(``launch/dryrun.py``).  Results append to
``experiments/perf_iterations_torch.json`` (never the reference's file)
with before/after terms, so each hypothesis -> change -> measure step is
logged.  The terms are the dry run's counts over the H100's rates
(``launch/roofline.py``), not measured times.  Each variant runs at full
width on the 16 x 16 mesh: on the card's machine, or with ``--device cpu``
(the plain versions' program) anywhere, a few minutes a variant.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell llama_train
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh, mesh_size


def run_variant(cfg, shape, mesh, label, device="cuda"):
    t0 = time.time()
    cost = dryrun.count_step(cfg, shape, mesh, device)
    rf = roofline.analyze(label, cost, mesh_size(mesh),
                          model_flops=roofline.model_flops_for(cfg, shape),
                          bytes_floor=roofline.memory_floor_bytes(cfg, shape))
    row = rf.row()
    row["t_run_s"] = round(time.time() - t0, 1)
    return row


# Variant chains per hillclimb cell.  Each entry applies ON TOP of the
# previous (cumulative), mirroring how the iterations were actually run.
def _chain_llama_train():
    base = get_config("llama3.2-3b")
    return "llama3.2-3b", "train_4k", [
        ("baseline", "paper-faithful XLA lowering, fp32 grad accumulation",
         base),
        ("bf16_grads",
         "grad buffers + DP grad all-reduce dominate collective bytes; "
         "bf16 accumulation halves both (predicted coll -45%)",
         dataclasses.replace(base, grad_accum_dtype="bfloat16")),
        ("bf16_probs",
         "fp32 score-chain materialisation dominates HBM bytes; bf16 "
         "normalised probs halve the attention tag (predicted mem -15%)",
         dataclasses.replace(base, grad_accum_dtype="bfloat16",
                             attn_probs_dtype="bfloat16")),
        ("fsdp",
         "params are replicated over the data axis so grad sync is a full "
         "all-reduce; FSDP shards params+grads -> reduce-scatter + "
         "all-gather of 1/16 the bytes (predicted coll -6x on the DP part)",
         dataclasses.replace(base, grad_accum_dtype="bfloat16",
                             attn_probs_dtype="bfloat16", fsdp=True)),
        ("seq_parallel",
         "HLO shows ~6 per-layer all-reduces of the full (mb,S,D) residual "
         "(fwd TP sync x2, remat recompute x2, bwd dx x2+); sequence-"
         "parallel TP turns each AR into RS+AG halves and lets GSPMD keep "
         "norms seq-sharded (predicted coll -40%)",
         dataclasses.replace(base, grad_accum_dtype="bfloat16",
                             attn_probs_dtype="bfloat16", fsdp=True,
                             seq_parallel=True)),
        ("no_remat_mb16",
         "2 of the ~6 per-layer residual ARs and ~1/3 of HBM bytes are the "
         "remat recompute of the layer forward; dropping remat and doubling "
         "microbatches (per-mb activations halve) trades saved-activation "
         "memory for no recompute (predicted coll -25%, mem -25%, "
         "compute -25%)",
         dataclasses.replace(base, grad_accum_dtype="bfloat16",
                             attn_probs_dtype="bfloat16", fsdp=True,
                             remat=False, train_microbatches=16)),
    ]


def _chain_llama_prefill():
    base = get_config("llama3.2-3b")
    return "llama3.2-3b", "prefill_32k", [
        ("baseline", "paper-faithful lowering", base),
        ("seq_parallel",
         "per-layer TP sync all-reduces the full (B,S,D) residual; "
         "sequence-parallel TP keeps it model-sharded on S between blocks "
         "-> RS+AG at half the link bytes (predicted coll -40%)",
         dataclasses.replace(base, seq_parallel=True)),
        ("seq_parallel_bf16probs",
         "remaining memory term is the fp32 score chain (predicted mem -30%)",
         dataclasses.replace(base, seq_parallel=True,
                             attn_probs_dtype="bfloat16")),
    ]


def _chain_kimi_train():
    base = get_config("kimi-k2-1t-a32b")
    return "kimi-k2-1t-a32b", "train_4k", [
        ("baseline",
         "paper-faithful: fp32 grad accum + fp32 dispatch; expected NOT to "
         "fit one pod (parameters and gradients alone)", base),
        ("bf16_grads",
         "the fp32 grad buffer dominates the peak; bf16 accumulation "
         "halves it",
         dataclasses.replace(base, grad_accum_dtype="bfloat16")),
        ("lean_dispatch",
         "dispatch/combine one-hots at fp32 + capacity 1.25 dominate MoE "
         "transients; capacity 1.0 + smaller groups cut them ~35%",
         dataclasses.replace(
             base, grad_accum_dtype="bfloat16",
             moe=dataclasses.replace(base.moe, capacity_factor=1.0,
                                     group_size=512))),
        ("more_microbatches",
         "activation transients scale 1/n_mb; 32 microbatches halve the "
         "per-step working set (flops +0 — weights re-read instead, "
         "acceptable: memory-bound cell)",
         dataclasses.replace(
             base, grad_accum_dtype="bfloat16", train_microbatches=32,
             moe=dataclasses.replace(base.moe, capacity_factor=1.0,
                                     group_size=512))),
    ]


CHAINS = {
    "llama_train": _chain_llama_train,
    "llama_prefill": _chain_llama_prefill,
    "kimi_train": _chain_kimi_train,
}


def _variant_row(cell: str, i: int, device: str) -> dict:
    """Variant ``i`` of ``cell``'s chain on the 16 x 16 mesh, built here
    (a worker process of ``--jobs`` makes its own fake process group)."""
    arch, shape_name, chain = CHAINS[cell]()
    label, hypothesis, cfg = chain[i]
    row = run_variant(cfg, SHAPES[shape_name],
                      make_production_mesh(device=device),
                      f"{arch}/{shape_name}/{label}", device)
    row["hypothesis"] = hypothesis
    row["variant"] = label
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=list(CHAINS))
    ap.add_argument("--out", default="experiments/perf_iterations_torch.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="as launch/dryrun.py's --device")
    ap.add_argument("--jobs", type=int, default=1,
                    help="variants run in this many processes at once")
    args = ap.parse_args(argv)

    tasks = [(args.cell, i, args.device)
             for i in range(len(CHAINS[args.cell]()[2]))]
    if args.jobs > 1:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
            rows = pool.starmap_async(_variant_row, tasks,
                                      chunksize=1).get()
    else:
        rows = [_variant_row(*t) for t in tasks]
    for row in rows:
        label = row["variant"]
        print(f"[{label}] mem {row['t_memory_ms']:.0f}ms "
              f"(floor {row['t_memory_floor_ms']:.0f}) "
              f"coll {row['t_collective_ms']:.0f}ms "
              f"compute {row['t_compute_ms']:.0f}ms "
              f"peak {row['peak_mem_gb_per_chip']:.1f}GB "
              f"mfu {row['mfu_bound']:.2%}")

    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    existing.append({"cell": args.cell, "device": args.device,
                     "rows": rows})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(existing, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
