"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload sage-ig.ooc \
        --seeds 11,12,13 --out chiprun_out/calibrate_sage-ig.ooc.jsonl

For each seed it builds the cell's inputs and trainer at the cell's size,
runs the checked steps through the trainer's own call (no timed window)
and reads each number compared by ``correct`` four times, each against
the float32 reference on the program's sampled batches:

- ``program``: the trainer's steps (the lower reading is the largest of
  these over the seeds);
- ``control``: the reference with its dense products in TF32, the
  precision below the configuration's (the upper reading is the smallest);
- ``half_batch``: the reference taking the loss over half of the seeds;
- ``unchanged``: a step that returns its state unchanged (the parameters
  and the optimizer's moments stay as they were);
- ``float64``: the reference in float64, a witness of how far float32's
  rounding alone moves each number.

Each seed's readings go to ``--out`` as one JSON line, with each leaf's
gap beside the worst.  It runs on the device the card gives, or with
``--device cpu`` at whatever size the cell's files give.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def update_flips(d_got: dict, d_want: dict, lr: float) -> dict:
    """{leaf: entries whose change differs by more than lr / 10} for the
    leaves where any does: an entry whose gradient is at rounding level
    moves by about lr either way under Adam."""
    out = {}
    for k in d_want:
        n = int(((d_got[k].double() - d_want[k].double()).abs()
                 > 0.1 * lr).sum())
        if n:
            out[k] = n
    return out


def readings(cell: dict, seed: int, device: str) -> dict:
    import torch

    from portbench import harness, reference
    cfg = cell["config"]
    su = harness.Setup(cell, seed, device)
    try:
        warm = su.warm_up(harness.CHECK_STEPS)
        su.release_trainer()
        records = su.step_tap.records
        faults, row_faults, steps = harness.reference_inputs(
            cell, seed, records, warm, su.rowptr, su.col, su.graph_digest,
            su.row_seed, su.dev)
    finally:
        su.close()
    model, margs, lr = cfg["model"], cfg.get("model_args", {}), cfg["lr"]
    p0 = reference.init_params(model, seed, cfg["feature_dim"],
                               cfg["hidden"], cfg["n_classes"], **margs)
    want = reference.run_steps(p0, steps, model, lr, **margs)
    still = reference.run_steps(p0, steps, model, 0.0, **margs)
    variants = {
        "program": harness.program_steps(records),
        "control": reference.run_steps(p0, steps, model, lr,
                                       precision="tf32", **margs),
        "half_batch": reference.run_steps(p0, steps, model, lr,
                                          half_batch=True, **margs),
        "unchanged": {"losses": still["losses"],
                      "grad1": {k: torch.zeros_like(v)
                                for k, v in want["grad1"].items()},
                      "params": p0},
        "float64": reference.run_steps(p0, steps, model, lr,
                                       precision="f64", **margs),
    }
    moving = reference.moving_leaves(want["grad1"])
    out = {"seed": seed, "sample_faults": faults, "row_faults": row_faults,
           "not_moving": sorted(set(p0) - set(moving))}
    for name, got in variants.items():
        nums = reference.numbers(got, want, p0)
        d_got = {k: got["params"][k] - p0[k] for k in p0}
        d_want = {k: want["params"][k] - p0[k] for k in p0}
        nums["grad_leaves"] = reference.leaf_gaps(got["grad1"],
                                                  want["grad1"])
        nums["update_leaves"] = reference.leaf_gaps(d_got, d_want, moving)
        nums["update_flips"] = update_flips(d_got, d_want, lr)
        nums["losses"] = got["losses"]
        out[name] = nums
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import harness
    cell = harness.load_cell(args.workload)
    with open(args.out, "a") as fh:
        for s in args.seeds.split(","):
            r = readings(cell, int(s), args.device)
            fh.write(json.dumps(r) + "\n")
            fh.flush()
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
