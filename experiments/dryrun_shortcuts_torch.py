"""Check and profile the port's dry-run shortcuts on one cell.

    python experiments/dryrun_shortcuts_torch.py compare ARCH SHAPE MESH
    python experiments/dryrun_shortcuts_torch.py profile ARCH SHAPE MESH \\
        --layers 4 --microbatches 2

``compare`` counts the cell (full width) twice, each in a process of its
own, since DTensor keeps the shardings it chose for the life of a
process: with ``launch/dryrun.py``'s shortcuts (greedy pricing on a 3-D
mesh, train steps of more than 3 microbatches extrapolated from steps of
1 and 2) and without (``count_step(..., shortcuts=False)``).  It prints
both costs and their seconds, and exits 1 unless every count is equal to
the integer.  ``profile`` runs the cell cut to ``--layers`` layers and
``--microbatches`` microbatches once to warm DTensor's caches, then again
under cProfile, and prints the heaviest functions.  MESH is ``DxM`` or
``PxDxM``; ``--device cuda`` (the default) needs a CUDA build of torch
and does no GPU work.  Run with ``PYTHONPATH=src`` from the repository's
root.
"""
import argparse
import cProfile
import dataclasses
import json
import pstats
import subprocess
import sys
import time


def cost_of(arch, shape, mesh_spec, device, shortcuts, layers=0, mbs=0):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if mbs:
        cfg = dataclasses.replace(cfg, train_microbatches=mbs)
    mesh = dryrun._mesh(mesh_spec, device)
    t0 = time.time()
    c = dryrun.count_step(cfg, SHAPES[shape], mesh, device,
                          shortcuts=shortcuts)
    return time.time() - t0, {
        "flops": c.flops, "hbm_bytes": c.hbm_bytes,
        "peak_bytes": c.peak_bytes, "start_bytes": c.start_bytes,
        "ops": c.n_ops, "collectives": sorted(c.coll_count.items()),
        "collective_bytes": sorted(c.coll_bytes.items()),
        "collectives_in_backward": sorted(c.coll_count_backward.items()),
        "flops_by_op": sorted(c.flops_by_op.items())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["compare", "profile", "one"])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("mesh")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--plain", action="store_true",
                    help="(one) without the shortcuts")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=2)
    args = ap.parse_args(argv)
    cell = [args.arch, args.shape, args.mesh, "--device", args.device]
    if args.mode == "one":
        s, cost = cost_of(args.arch, args.shape, args.mesh, args.device,
                          not args.plain)
        print(json.dumps({"s": round(s, 1), "cost": cost}))
        return 0
    if args.mode == "compare":
        procs = {way: subprocess.Popen(
            [sys.executable, __file__, "one", *cell]
            + (["--plain"] if way == "plain" else []),
            stdout=subprocess.PIPE, text=True)
            for way in ("shortcuts", "plain")}
        got = {way: json.loads(p.communicate()[0].strip().splitlines()[-1])
               for way, p in procs.items()}
        same = got["shortcuts"]["cost"] == got["plain"]["cost"]
        print(json.dumps({"cell": "/".join(cell[:3]), "equal": same,
                          **got}))
        return 0 if same else 1
    cost_of(args.arch, args.shape, args.mesh, args.device, True,
            args.layers, args.microbatches)
    prof = cProfile.Profile()
    prof.enable()
    s, cost = cost_of(args.arch, args.shape, args.mesh, args.device, True,
                      args.layers, args.microbatches)
    prof.disable()
    print(json.dumps({"s_under_profile": round(s, 2), "ops": cost["ops"]}))
    stats = pstats.Stats(prof)
    stats.sort_stats("tottime").print_stats(20)
    stats.sort_stats("cumulative").print_stats(40)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
