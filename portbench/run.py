"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload sage-ig.ooc --seed 7 --seconds 30 \
        --trace 0

makes the cell's inputs from ``--seed``, sets up ``repro_torch``'s
out-of-core GNN trainer, warms it up (its first steps are the ones
checked), times one call of ``OutOfCoreGNNTrainer.train`` sized to last
about ``--seconds``, checks the first steps against the plain reference
(``reference.py``) and prints one JSON line last on standard output:
the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics,
read from a ``torch.profiler`` window and the trainer's spans and
counters, with ``--trace 1``.  It needs a CUDA card and exits non-zero
without printing a result where there is none, where the card count is
below the cell's, or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's own settings read from the environment stay at their
# defaults: no fault injection, no tracer installed at import, K1 as built
for var in ("HELIOS_CHAOS", "HELIOS_TRACE", "HELIOS_FUSED_BACKEND"):
    os.environ.pop(var, None)
# caches of any compiler the program may start live at fixed paths in the
# checkout (the program's CUDA kernels build into build/kernels/)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "portbench",
                                              "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "portbench",
                                                  "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on a card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("portbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    res = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
        log=lambda msg: print(f"portbench: {msg}", file=sys.stderr,
                              flush=True))
    found = harness.jax_modules()
    if found:
        print(f"portbench: JAX modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell["chips"]}
    line = harness.result_line(cell, res, bool(args.trace), info)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
