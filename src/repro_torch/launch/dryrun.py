"""Dry run: one step of every (arch x shape x mesh) cell on fake tensors
(PyTorch port of ``repro.launch.dryrun``).

For every cell this script:
  1. builds the step (train_step / prefill_step / decode_step) and its
     parameters, optimizer state and inputs as fake tensors
     (``FakeTensorMode``: shapes and dtypes, no memory, no data);
  2. on a mesh of more than one rank makes each a ``DTensor`` placed by
     ``distributed/sharding.py``'s rules, over torch's ``fake`` process
     group (no collective runs); on one rank leaves them plain;
  3. runs the step once under ``launch/op_cost.py``'s counter: FLOPs,
     HBM bytes and collectives per rank, and the peak of live bytes on a
     rank (the fit proof: ``fits_80gb``);
  4. extracts the three roofline terms (``launch/roofline.py``).

The reference lowers and compiles each cell with XLA; eager PyTorch has
no compiled program, so the port runs the step's ops themselves on fake
tensors.  ``--device cuda`` (the default, as every entry point of the
port) counts the card's program: the kernels K4 and K5 through their
shape-only dry-run ops (``kernels/dry_run.py``).  It needs a CUDA build of
torch (the card's machine) but does no GPU work.  ``--device cpu`` counts
the CPU program, that is the kernels' plain versions, and runs anywhere;
its defaults are the tests' cut (reduced width, 32 tokens, batch 8, 2
microbatches) on a 2 x 4 mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single  # 40 cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --jobs 8 \\
      --out experiments/dryrun_torch.json     # all 80, 8 processes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch llama3.2-3b,rwkv6-7b,qwen2-moe-a2.7b --shape train_4k
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_configs
from repro_torch.distributed.sharding import (ShardingCtx, param_logical_axes,
                                              param_specs, use_mesh)
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (OneRank, fake_world, make_local_mesh,
                                     make_mesh, mesh_size)
from repro_torch.launch.op_cost import Cost, OpCounter
from repro_torch.models import encdec, lm, steps
from repro_torch.train import optim

REDUCED_SEQ, REDUCED_BATCH, REDUCED_MB = 32, 8, 2    # the tests' cut


# ---------------------------------------------------------------------------
# Input / state construction
# ---------------------------------------------------------------------------

def batch_specs(cfg, shape, ctx: ShardingCtx) -> dict:
    """{name: (shape, dtype, placements)} of the data batch of one cell."""
    out = {}
    for name, (shp, dt) in steps.input_shapes(cfg, shape).items():
        if shape.kind == "train":
            names = ("mb", "batch") + (None,) * (len(shp) - 2)
        else:
            names = ("batch",) + (None,) * (len(shp) - 1)
        names = tuple(n if n != "mb" else None for n in names)
        out[name] = (shp, dt, ctx.sharding(names, shp))
    return out


_CACHE_AXES = {
    "k": (None, "batch", "kv_seq", None, None),
    "v": (None, "batch", "kv_seq", None, None),
    "cross_k": (None, "batch", "kv_seq", None, None),
    "cross_v": (None, "batch", "kv_seq", None, None),
    "wkv": (None, "batch", "rnn", None, None),
    "tm_x": (None, "batch", None),
    "cm_x": (None, "batch", None),
    "h": (None, "batch", "rnn"),
    "conv": (None, "batch", None, "rnn"),
}


def cache_specs(cache, ctx: ShardingCtx) -> dict:
    """{dotted key: placements} of a decode cache (``lm.flat_cache``),
    each leaf by its last key that ``_CACHE_AXES`` names."""
    out = {}
    for key, leaf in lm.flat_cache(cache).items():
        name = next((k for k in reversed(key.split("."))
                     if k in _CACHE_AXES), None)
        axes = _CACHE_AXES.get(name, (None,) * leaf.dim())[:leaf.dim()]
        axes = axes + (None,) * (leaf.dim() - len(axes))
        out[key] = ctx.sharding(axes, tuple(leaf.shape))
    return out


def token_placements(shape, ctx: ShardingCtx) -> tuple:
    """Placements of a decode step's (B, 1) token ids."""
    B = shape.global_batch
    return ctx.sharding(("batch", None), (B, 1))


def microbatches(cfg, shape, ctx: ShardingCtx) -> int:
    """The train step's microbatch count after the reference's clamp.

    Invariant learned in the reference's §Perf (kimi iterations 3/4): a
    per-microbatch batch smaller than the batch-sharding degree silently
    REPLICATES activations across the data axis -- clamp the
    grad-accumulation depth to keep it a shard multiple."""
    shards = ctx.axis_size(("pod", "data"))
    return min(max(cfg.train_microbatches, 1),
               max(shape.global_batch // shards, 1))


def make_optimizer(cfg):
    # the 1T arch uses factored second moments (memory fit, DESIGN.md §7)
    if cfg.tiered_experts or cfg.name.startswith("kimi"):
        return optim.adafactor(1e-2)
    return optim.adamw(3e-4)


def reduce_cell(cfg, shape):
    """The tests' cut of a cell: reduced width, 32 tokens, batch 8, 2
    microbatches, as ``tests/test_dryrun_small.py`` cuts the reference's."""
    cfg = dataclasses.replace(cfg.reduced(), train_microbatches=REDUCED_MB)
    return cfg, ShapeSpec(shape.name, REDUCED_SEQ, REDUCED_BATCH, shape.kind)


def _distributed(mesh):
    return not isinstance(mesh, OneRank)


def _place(t, mesh, placements):
    return distribute_tensor(t, mesh, placements) if _distributed(mesh) else t


def _place_module(model, ctx: ShardingCtx, fsdp: bool):
    """Each parameter of ``model`` as a DTensor placed by ``param_specs``
    (a one-rank mesh leaves them plain)."""
    if not _distributed(ctx.mesh):
        return model
    specs = param_specs(model, ctx, fsdp=fsdp)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute_tensor(p.detach(), ctx.mesh,
                              ctx.placements(specs[name])),
            requires_grad=False)
    return model


def _place_tree(tree, ctx: ShardingCtx, fsdp: bool, path=()):
    """The optimizer's state placed as the reference's ``param_specs``
    places it: each leaf by the logical axes of its path's last name."""
    if isinstance(tree, dict):
        return {k: _place_tree(v, ctx, fsdp, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place_tree(v, ctx, fsdp, path + (str(i),))
                for i, v in enumerate(tree)]
    names = param_logical_axes(path or ("step",), tree.shape, fsdp=fsdp)
    return _place(tree, ctx.mesh, ctx.sharding(names, tuple(tree.shape)))


def build_cell(cfg, shape, ctx: ShardingCtx, device="cuda", optimizer=None):
    """Inside ``FakeTensorMode``: ``(step_fn, args)``, args' tensors fake
    and, on a mesh of more than one rank, DTensors."""
    if shape.kind == "train":
        n_mb = microbatches(cfg, shape, ctx)
        if n_mb != cfg.train_microbatches:
            cfg = dataclasses.replace(cfg, train_microbatches=n_mb)
    dev = torch.device(device)
    model = (encdec.EncDec(cfg, dev) if cfg.enc_dec else lm.LM(cfg, dev))
    model = _place_module(model, ctx, cfg.fsdp)
    mesh = ctx.mesh

    def batch():
        return {name: _place(torch.zeros(shp, dtype=dt, device=dev), mesh,
                             pl)
                for name, (shp, dt, pl) in batch_specs(cfg, shape,
                                                       ctx).items()}

    if shape.kind == "train":
        opt = optimizer or make_optimizer(cfg)
        state = {"params": model,
                 "opt": _place_tree(opt.init(lm.param_tree(model)), ctx,
                                    cfg.fsdp)}
        return steps.make_train_step(cfg, opt), (state, batch())
    if shape.kind == "prefill":
        return steps.make_prefill_step(cfg), (model, batch())
    B, T = shape.global_batch, shape.seq_len
    init = encdec.init_cache if cfg.enc_dec else lm.init_cache
    cache = (init(cfg, B, T, T, device=dev) if cfg.enc_dec
             else init(cfg, B, T, device=dev))
    if _distributed(mesh):
        pl = cache_specs(cache, ctx)
        cache = _map_cache(cache, lambda key, a: distribute_tensor(
            a, mesh, pl[key]))
    tok = _place(torch.zeros((B, 1), dtype=torch.int32, device=dev), mesh,
                 token_placements(shape, ctx))
    return steps.make_decode_step(cfg), (model, cache, tok, 0)


def _map_cache(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_cache(v, fn, f"{prefix}{k}.") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


@contextlib.contextmanager
def _fake_safe_dtensor():
    """DTensor's ``_StridedShard`` (the placement of a sharded dim folded
    into another by a view) works out its offsets by building an index
    tensor and reading it back, which a fake tensor cannot do; run that
    metadata arithmetic on real (tiny, CPU) tensors for the dry run, with
    every dispatch mode off, so that ``OpCounter`` does not count it
    either (DTensor caches the result, so only the first such op of a
    process would have counted it)."""
    from torch.distributed.tensor import placement_types as pt
    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def patched(*args, **kwargs):
        with _disable_current_modes():
            return orig(*args, **kwargs)
    cls.local_shard_size_and_offset = patched
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


@contextlib.contextmanager
def _greedy_plans():
    """DTensor plans a redistribution that involves a ``_StridedShard`` or
    a non-default shard order by a least-cost search over every placement
    of every mesh dim (``DTensorRedistributePlanner.
    generate_graph_based_transform_infos``), and it prices every candidate
    strategy of an op by such a plan (``redistribute_cost``).  On a 3-D
    mesh that pricing can take minutes for one op (torch 2.13: an einsum
    of two sharded 5-D operands on 2 x 2 x 2), seconds on a 2-D mesh.
    There the dry run prices candidates by DTensor's greedy plan, mesh dim
    by mesh dim, as it prices every other redistribution, and
    redistributes by the search as before
    (``experiments/dryrun_shortcuts_torch.py compare`` holds the counts
    against the search's).  A torch without the search runs unpatched."""
    import sys

    from torch.distributed.tensor import _collective_utils, _redistribute
    cls = getattr(_redistribute, "DTensorRedistributePlanner", None)
    search = getattr(cls, "generate_graph_based_transform_infos", None)
    price = getattr(_collective_utils, "redistribute_cost", None)
    if None in (search, price) or not hasattr(
            cls, "generate_greedy_transform_infos"):
        yield
        return

    def greedy(self, src_spec, dst_spec, full_tensor_shape):
        return self.generate_greedy_transform_infos(src_spec, dst_spec)

    @functools.lru_cache(maxsize=None)
    def greedy_price(current_spec, target_spec):
        cls.generate_graph_based_transform_infos = greedy
        try:
            return price(current_spec, target_spec)
        finally:
            cls.generate_graph_based_transform_infos = search
    users = [m for name, m in list(sys.modules.items())
             if name.startswith("torch.distributed.tensor")
             and getattr(m, "redistribute_cost", None) is price]
    for m in users:
        m.redistribute_cost = greedy_price
    try:
        yield
    finally:
        for m in users:
            m.redistribute_cost = price


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def _count(cfg, shape, mesh, device, optimizer, runs=None):
    """One step of the cell under ``OpCounter``; with ``runs``, a train
    step over the first ``runs`` microbatches of the whole batch (which
    is held from the start all the same)."""
    with _fake_safe_dtensor(), FakeTensorMode(), use_mesh(mesh) as ctx:
        fn, args = build_cell(cfg, shape, ctx, device, optimizer)
        counter = OpCounter()
        counter.track(args)
        if runs:
            state, batch = args
            args = (state, {k: v[:runs] for k, v in batch.items()})
        rep = (implicit_replication() if _distributed(mesh)
               else contextlib.nullcontext())
        with rep, counter:
            fn(*args)
        del fn, args
    return counter.cost


def _extrapolate(one: Cost, two: Cost, n: int) -> Cost:
    """The cost of a train step of ``n`` microbatches from steps of one
    and two: every microbatch after the first runs the second's ops, and
    starts from the same live bytes (parameters, optimizer state, batch,
    gradient accumulators, the last microbatch's metrics), so it adds
    ``two - one`` and reaches the second's peak."""
    def lin(a, b):
        return b + (n - 2) * (b - a)

    def lin_dict(a, b):
        return {k: lin(a.get(k, 0), b.get(k, 0)) for k in {*a, *b}}
    return Cost(flops=lin(one.flops, two.flops),
                hbm_bytes=lin(one.hbm_bytes, two.hbm_bytes),
                peak_bytes=max(one.peak_bytes, two.peak_bytes),
                start_bytes=two.start_bytes,
                coll_bytes=lin_dict(one.coll_bytes, two.coll_bytes),
                coll_count=lin_dict(one.coll_count, two.coll_count),
                coll_count_backward=lin_dict(one.coll_count_backward,
                                             two.coll_count_backward),
                flops_by_op=lin_dict(one.flops_by_op, two.flops_by_op),
                n_ops=lin(one.n_ops, two.n_ops))


def count_step(cfg, shape, mesh, device="cuda", optimizer=None,
               shortcuts=True):
    """One step of the cell on fake tensors under ``OpCounter``: the
    counter's ``Cost`` per rank.  Two shortcuts, which
    ``shortcuts=False`` leaves out (to check that both count alike):

    * on a mesh of three axes or more, candidate shardings are priced by
      greedy plans (``_greedy_plans``);
    * a train step of more than 3 microbatches (after the clamp) runs
      steps of 1 and 2 and extrapolates (``_extrapolate``): the step's
      time goes into dispatching each op through DTensor and the fake
      tensor mode, and kimi-k2 runs 16 microbatches on 16 x 16."""
    plans = (_greedy_plans() if shortcuts and len(mesh.shape) >= 3
             else contextlib.nullcontext())
    with plans:
        n = 0
        if shape.kind == "train":
            with use_mesh(mesh) as ctx:
                n = microbatches(cfg, shape, ctx)
        if not (shortcuts and n > 3):
            return _count(cfg, shape, mesh, device, optimizer)
        one = _count(cfg, shape, mesh, device, optimizer, runs=1)
        two = _count(cfg, shape, mesh, device, optimizer, runs=2)
    return _extrapolate(one, two, n)


# ---------------------------------------------------------------------------
# Cell execution
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, mesh, verbose: bool = True, *,
             device: str = "cuda", cfg=None, shape=None,
             optimizer=None) -> dict:
    """One cell's roofline row.  ``cfg``/``shape`` replace the registered
    ones (a cut); ``optimizer`` replaces ``make_optimizer``'s choice."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    chips = mesh_size(mesh)
    cell = f"{arch}/{shape_name}/{mesh_name(mesh)}"
    if not cfg.supports(shape):
        return {"cell": cell, "status": "skip",
                "reason": "full-attention arch: 500k decode requires "
                          "sub-quadratic attention (see DESIGN.md §7)"}
    t0 = time.time()
    try:
        cost = count_step(cfg, shape, mesh, device, optimizer)
        t_run = time.time() - t0
        mf = roofline.model_flops_for(cfg, shape)
        floor = roofline.memory_floor_bytes(cfg, shape)
        rf = roofline.analyze(cell, cost, chips, model_flops=mf,
                              bytes_floor=floor)
        row = rf.row()
        row.update({
            "status": "ok", "device": device, "t_run_s": round(t_run, 1),
            "ops_per_chip": cost.n_ops,
            "start_gb_per_chip": cost.start_bytes / 1e9,
            "flops_per_chip": cost.flops,
            "flops_by_op": dict(cost.flops_by_op),
            "fits_80gb": row["peak_mem_gb_per_chip"] <= roofline.HBM_BYTES
            / 1e9,
            "collectives": dict(rf.coll.count_by_kind),
            "collectives_in_backward": dict(cost.coll_count_backward),
            "collective_gb_by_kind": {k: v * chips / 1e9 for k, v in
                                      rf.coll.bytes_by_kind.items()},
        })
        if verbose:
            print(f"[ok] {cell}: peak {row['peak_mem_gb_per_chip']:.2f} "
                  f"GB/chip, compute {row['t_compute_ms']:.1f} ms, "
                  f"memory {row['t_memory_ms']:.1f} ms "
                  f"(floor {row['t_memory_floor_ms']:.1f}), "
                  f"collective {row['t_collective_ms']:.1f} ms, "
                  f"bottleneck={row['bottleneck']}, "
                  f"mfu_bound={row['mfu_bound']:.2%} (run {t_run:.0f}s)")
        return row
    except Exception as e:
        if verbose:
            print(f"[FAIL] {cell}: {type(e).__name__}: {str(e)[:300]}")
            traceback.print_exc(limit=4)
        return {"cell": cell, "status": "fail",
                "error": f"{type(e).__name__}: {str(e)[:500]}"}


PRODUCTION = {"single": ["16x16"], "multi": ["2x16x16"],
              "both": ["16x16", "2x16x16"]}


def _mesh(spec: str, device: str):
    """The mesh a spec names: ``DxM`` (``data, model``) or ``PxDxM`` (a
    leading ``pod`` axis, as the 2 x 16 x 16 production mesh)."""
    sizes = tuple(int(x) for x in spec.split("x"))
    if len(sizes) == 3:
        return make_mesh(sizes, ("pod", "data", "model"), device)
    return make_local_mesh(*sizes, device)


def _meshes(spec: str, device: str) -> list:
    return [_mesh(s, device) for s in PRODUCTION.get(spec, [spec])]


def _cell_row(mesh_spec, arch, shape, device, reduced) -> dict:
    """One cell of the sweep: its mesh built here, so that a worker
    process of ``--jobs`` makes its own fake process group."""
    cfg, sp = get_config(arch), SHAPES[shape]
    if reduced:
        cfg, sp = reduce_cell(cfg, sp)
    return run_cell(arch, shape, _mesh(mesh_spec, device), device=device,
                    cfg=cfg, shape=sp)


def _work(cell) -> int:
    """A cell's share of the sweep's time, for ``--jobs`` to start the
    longest first: the layers a step runs times its microbatches."""
    _, arch, shape, _, _ = cell
    cfg = get_config(arch)
    n = cfg.n_layers + cfg.n_enc_layers
    return n * (cfg.train_microbatches if SHAPES[shape].kind == "train"
                else 1)


def _world(n: int) -> None:
    if n > 1:
        fake_world(n)


def sweep(cells, jobs: int = 1) -> list:
    """The rows of ``cells`` (``_cell_row``'s arguments), in their order;
    with ``jobs`` above 1 from that many spawned processes, the longest
    cells first.  Each process makes the fake process group of the largest
    mesh first, so that meshes of every size live in it."""
    n = max(math.prod(int(x) for x in c[0].split("x")) for c in cells)
    if jobs <= 1:
        _world(n)
        return [_cell_row(*c) for c in cells]
    import multiprocessing
    order = sorted(range(len(cells)), key=lambda i: -_work(cells[i]))
    rows = [None] * len(cells)
    with multiprocessing.get_context("spawn").Pool(
            jobs, initializer=_world, initargs=(n,)) as pool:
        results = pool.starmap_async(_cell_row, [cells[i] for i in order],
                                     chunksize=1).get()
    for i, row in zip(order, results):
        rows[i] = row
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="One step of each (arch x shape x mesh) cell on fake "
        "tensors: FLOPs, HBM bytes, collectives and peak memory per rank.")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default): the card's program, K4/K5 "
                    "through their dry-run ops; needs a CUDA build of "
                    "torch, does no GPU work.  cpu: the CPU program, that "
                    "is the kernels' plain versions; runs anywhere")
    ap.add_argument("--mesh", default=None,
                    help="single (16x16), multi (2x16x16), both, DxM, or "
                    "PxDxM (a pod axis); "
                    "default single on cuda, 2x4 on cpu")
    ap.add_argument("--width", default=None, choices=["full", "reduced"],
                    help="reduced: the tests' cut (reduced config, 32 "
                    "tokens, batch 8, 2 microbatches); default full on "
                    "cuda, reduced on cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run in this many processes at once, the "
                    "longest first; each row keeps its own t_run_s")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    mesh_spec = args.mesh or ("2x4" if cpu else "single")
    reduced = (args.width or ("reduced" if cpu else "full")) == "reduced"

    archs = list_configs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")

    cells = [(spec, arch, shape, args.device, reduced)
             for spec in PRODUCTION.get(mesh_spec, [mesh_spec])
             for arch in archs for shape in shapes]
    t0 = time.time()
    rows = sweep(cells, args.jobs)
    print(f"sweep: {len(rows)} cells in {time.time() - t0:.1f} s "
          f"({args.jobs} process{'es' if args.jobs > 1 else ''})")
    ok = sum(r.get("status") == "ok" for r in rows)
    skip = sum(r.get("status") == "skip" for r in rows)
    fail = sum(r.get("status") == "fail" for r in rows)
    print(f"\n== dry-run: {ok} ok, {skip} skip (documented), {fail} FAIL ==")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print("wrote", args.out)
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
