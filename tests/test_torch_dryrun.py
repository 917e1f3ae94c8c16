"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* The reference's three cells (``tests/test_dryrun_small.py``: llama3.2-3b
  train_4k, rwkv6-7b decode_32k, qwen2-moe-a2.7b train_4k), reduced, at 32
  tokens and batch 8, on a 2 x 4 ``cpu`` mesh over torch's fake process
  group: positive FLOPs and bytes, a valid bottleneck, and the llama train
  cell's gradient collectives.  The same run holds the per-rank counts:
  on 1 x 1 against 2 x 4, FLOPs times ranks agree within 5% where every
  head count divides the model axis, and replicated work (llama's 2 kv
  heads on the 4-way axis) counts on every rank.  It runs in a subprocess,
  so the fake process group never reaches another test.
* K4's and K5's dry-run ops (``kernels/dry_run.py``) under
  ``FakeTensorMode``: the shapes, dtypes and saved tensors of the plain
  versions' outputs, the registered FLOPs, and the routing (only a fake
  tensor takes them).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.kernels import dry_run  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.rwkv_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv_scan import ref as wkv_ref  # noqa: E402
from repro_torch.launch.op_cost import OpCounter  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import dataclasses, json, sys
import math
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh

out = {}
if sys.argv[1] == "cells":
    # the CLI, as the docs give it: --device cpu defaults to the reduced
    # cut on a 2 x 4 mesh
    for arch, shape in (("llama3.2-3b,qwen2-moe-a2.7b", "train_4k"),
                        ("rwkv6-7b", "decode_32k")):
        path = f"{sys.argv[2]}/{shape}.json"
        rc = dryrun.main(["--device", "cpu", "--arch", arch, "--shape",
                          shape, "--out", path])
        for row in json.load(open(path)):
            out[row["cell"]] = dict(row, rc=rc)
elif sys.argv[1].startswith("pod:"):
    # the reduced cut of each cell on a 2 x 2 x 2 mesh (a pod axis), and of
    # each train cell on 2 x 2 too; the PxDxM spec names the pod axis
    mesh = dryrun._meshes("2x2x2", "cpu")[0]
    out["mesh"] = [list(mesh.mesh_dim_names), list(mesh.shape)]
    for arch in sys.argv[1][4:].split(","):
        for shape in SHAPES:
            cfg, sp = dryrun.reduce_cell(get_config(arch), SHAPES[shape])
            meshes = ("2x2x2", "2x2") if sp.kind == "train" else ("2x2x2",)
            for spec in meshes:
                mesh = dryrun._mesh(spec, "cpu")
                row = dryrun.run_cell(arch, shape, mesh, verbose=False,
                                      device="cpu", cfg=cfg, shape=sp)
                out[row["cell"]] = {k: row.get(k) for k in (
                    "status", "error", "start_gb_per_chip",
                    "collectives_in_backward", "t_run_s")}
                if sp.kind == "train":
                    # the batch's bytes a rank, each leaf's shard
                    ctx = ShardingCtx(mesh)
                    small = dataclasses.replace(
                        cfg, train_microbatches=dryrun.microbatches(cfg, sp,
                                                                    ctx))
                    n = 0
                    for shp, dt, pl in dryrun.batch_specs(small, sp,
                                                          ctx).values():
                        local = list(shp)
                        for axis, p in enumerate(pl):
                            if p.is_shard():
                                local[p.dim] //= mesh.shape[axis]
                        n += math.prod(local) * dt.itemsize
                    out[row["cell"]]["batch_bytes"] = n
elif sys.argv[1].startswith("mb:"):
    # train steps of 4 microbatches on 2 x 2, extrapolated from steps of 1
    # and 2 (the dry run's default) or run whole; before them, a train
    # cell counted cold and again warm
    if sys.argv[1] == "mb:short":
        cfg, sp = dryrun.reduce_cell(get_config("llama3.2-3b"),
                                     SHAPES["train_4k"])
        for way in ("cold", "warm"):
            c = dryrun.count_step(cfg, sp, make_local_mesh(2, 2, "cpu"),
                                  "cpu")
            out[way] = [c.flops, c.hbm_bytes, c.peak_bytes, c.n_ops,
                        c.coll_count, c.coll_bytes]
    for arch in ("llama3.2-3b", "qwen2-moe-a2.7b"):
        cfg, sp = dryrun.reduce_cell(get_config(arch), SHAPES["train_4k"])
        cfg = dataclasses.replace(cfg, train_microbatches=4)
        c = dryrun.count_step(cfg, sp, make_local_mesh(2, 2, "cpu"), "cpu",
                              shortcuts=sys.argv[1] == "mb:short")
        out[arch] = [c.flops, c.hbm_bytes, c.peak_bytes, c.start_bytes,
                     c.n_ops, c.coll_count, c.coll_bytes,
                     c.coll_count_backward, c.flops_by_op]
elif sys.argv[1].startswith("plans:"):
    # the counts of reduced decode cells on 2 x 2 x 2 with candidates
    # priced by greedy plans or by DTensor's search (one process each:
    # DTensor keeps the shardings it chose for the process's life)
    greedy = sys.argv[1] == "plans:greedy"
    for arch in ("llama3.2-3b", "recurrentgemma-2b", "rwkv6-7b"):
        cfg, sp = dryrun.reduce_cell(get_config(arch), SHAPES["decode_32k"])
        c = dryrun.count_step(cfg, sp, dryrun._mesh("2x2x2", "cpu"), "cpu",
                              shortcuts=greedy)
        out[f"{arch}/decode_32k"] = [
            c.flops, c.hbm_bytes, c.peak_bytes, c.start_bytes, c.n_ops,
            c.coll_count, c.coll_bytes, c.coll_count_backward,
            c.flops_by_op]
else:
    base, sp = dryrun.reduce_cell(get_config("llama3.2-3b"),
                                  SHAPES["train_4k"])
    for kv in (int(sys.argv[1][-1]),):
        cfg = dataclasses.replace(base, n_kv_heads=kv)
        for shape in ((1, 1), (2, 4)):
            cost = dryrun.count_step(cfg, sp, make_local_mesh(*shape, "cpu"),
                                     "cpu")
            out[f"kv{kv}/{shape[0]}x{shape[1]}"] = {
                "flops": cost.flops, "ranks": shape[0] * shape[1],
                "peak": cost.peak_bytes, "start": cost.start_bytes}
print(json.dumps(out))
"""


ARCHS = ["kimi-k2-1t-a32b", "llama3.2-3b", "phi-3-vision-4.2b",
         "qwen2-moe-a2.7b", "qwen2.5-3b", "qwen3-32b", "recurrentgemma-2b",
         "rwkv6-7b", "stablelm-3b", "whisper-small"]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
# the pod-axis cells in four processes, each config's cells in one (most
# of a cell's time is DTensor's first sharding of each op, shared by a
# config's cells)
POD_PARTS = ("pod:kimi-k2-1t-a32b,whisper-small",
             "pod:rwkv6-7b,llama3.2-3b,qwen2.5-3b",
             "pod:recurrentgemma-2b,stablelm-3b",
             "pod:qwen3-32b,qwen2-moe-a2.7b,phi-3-vision-4.2b")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The cells, the two per-rank comparisons, the pod-axis cells and the
    planners' comparison at once, each in a process of its own."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    tmp = str(tmp_path_factory.mktemp("dry"))
    procs = {part: subprocess.Popen([sys.executable, "-c", SCRIPT, part, tmp],
                                    env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for part in ("cells", "kv2", "kv4", "plans:greedy",
                          "plans:search", "mb:short", "mb:plain")
             + POD_PARTS}
    out = {"per_rank": {}, "pod": {}}
    for part, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stderr[-3000:]
        got = json.loads(stdout.strip().splitlines()[-1])
        if part.startswith(("cells", "plans", "mb")):
            out[part] = got
        elif part.startswith("pod:"):
            out["pod"].update(got)
        else:
            out["per_rank"].update(got)
    return out


def test_dryrun_small_mesh(run):
    cells = run["cells"]
    assert set(cells) == {"llama3.2-3b/train_4k/2x4",
                          "qwen2-moe-a2.7b/train_4k/2x4",
                          "rwkv6-7b/decode_32k/2x4"}
    for cell, row in cells.items():
        assert row["rc"] == 0 and row["status"] == "ok", row
        assert row["gflops"] > 0, cell
        assert row["gbytes"] > 0, cell
        assert row["bottleneck"] in ("compute", "memory", "collective")
        assert 0 < row["peak_mem_gb_per_chip"] and row["fits_80gb"]
    # the train cells must have gradient collectives
    llama = cells["llama3.2-3b/train_4k/2x4"]
    assert llama["coll_gbytes"] > 0
    assert llama["collectives"].get("all-reduce", 0) > 0


def test_per_rank_flops_times_ranks(run):
    """Each rank counts the ops on its shards: where every head count
    divides the model axis, 2 x 4 ranks' FLOPs add up to one rank's; with
    llama's 2 kv heads on the 4-way axis attention is replicated and counts
    on every rank."""
    pr = run["per_rank"]
    one, eight = pr["kv4/1x1"], pr["kv4/2x4"]
    assert eight["ranks"] == 8
    assert abs(eight["flops"] * 8 / one["flops"] - 1) < 0.05
    assert pr["kv2/2x4"]["flops"] * 8 > 1.05 * pr["kv2/1x1"]["flops"]
    # a rank holds its shards: less than one rank holding everything
    assert eight["start"] < one["start"]
    assert one["start"] < one["peak"]


def test_pod_axis_mesh_spec(run):
    """``PxDxM`` makes a ("pod", "data", "model") mesh."""
    assert run["pod"]["mesh"] == [["pod", "data", "model"], [2, 2, 2]]


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_cells_on_a_pod_mesh(run, arch, shape_name):
    """The tests' cut of every cell on a 2 x 2 x 2 mesh: ``ok``, or
    skipped where and only where the reference's ``cfg.supports`` skips."""
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    row = run["pod"][f"{arch}/{shape_name}/2x2x2"]
    if ref_config(arch).supports(REF_SHAPES[shape_name]):
        assert row["status"] == "ok", row
    else:
        assert row["status"] == "skip", row


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_axis_keeps_start_bytes(run, arch):
    """Parameters and optimizer state take no pod axis: a rank holds the
    same bytes of them at the start of a train step on 2 x 2 x 2 as on
    2 x 2, to the byte, and half the batch's (its shards over pod x data);
    the backward holds collectives on both.  (At the tests' cut the batch
    is a few percent of a rank's bytes, phi-3-vision's stub embeddings;
    at full width ``chip_smoke.py`` holds the whole to 1%.)"""
    pod = run["pod"][f"{arch}/train_4k/2x2x2"]
    flat = run["pod"][f"{arch}/train_4k/2x2"]
    assert pod["status"] == flat["status"] == "ok", (pod, flat)
    held = [round(r["start_gb_per_chip"] * 1e9) - r["batch_bytes"]
            for r in (pod, flat)]
    assert held[0] == held[1] > 0, (pod, flat)
    assert 2 * pod["batch_bytes"] == flat["batch_bytes"], (pod, flat)
    assert pod["collectives_in_backward"] and \
        flat["collectives_in_backward"], (pod, flat)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "recurrentgemma-2b",
                                  "rwkv6-7b"])
def test_greedy_pricing_counts_as_dtensors_search(run, arch):
    """On a 3-D mesh the dry run prices candidate shardings by greedy
    plans (``_greedy_plans``): on these decode cells FLOPs, HBM bytes,
    peak and start bytes, ops and collectives by kind equal those of a
    process that prices by DTensor's own search, to the integer."""
    cell = f"{arch}/decode_32k"
    assert run["plans:greedy"][cell] == run["plans:search"][cell]


def test_counts_do_not_depend_on_a_warm_process(run):
    """A cell counts the same in a process that has run it before: the
    index arithmetic DTensor caches for ``_StridedShard`` (a cache miss
    runs it) is kept out of the counts."""
    assert run["mb:short"]["cold"] == run["mb:short"]["warm"]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-moe-a2.7b"])
def test_microbatches_extrapolate_exactly(run, arch):
    """A train step of 4 microbatches counted from steps of 1 and 2
    (``dryrun._extrapolate``) equals the whole step's count to the
    integer: FLOPs, HBM bytes, peak and start bytes, ops, collectives by
    kind and FLOPs by op."""
    assert run["mb:short"][arch] == run["mb:plain"][arch]


# ---------------------------------------------------------------------------
# K4's and K5's dry-run ops
# ---------------------------------------------------------------------------

def _k4_inputs(device, grad=False, dtype=torch.bfloat16):
    shapes = ((1, 48, 4, 64), (1, 48, 2, 64), (1, 48, 2, 64))
    return [torch.zeros(s, dtype=dtype, device=device, requires_grad=grad)
            for s in shapes]


def _k5_inputs(device, grad=False):
    B, T, H, N = 2, 37, 2, 8
    ts = [torch.zeros((B, T, H, N), device=device) for _ in range(4)]
    ts.append(torch.zeros((H, N), device=device))
    return [t.requires_grad_(grad) for t in ts]


def _meta(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


def test_k4_dry_ops_give_the_plain_versions_shapes():
    """Fake CUDA tensors through the public entries: the forward's output
    and saved log-sum-exp and the backward's gradients have the plain
    versions' shapes and dtypes, on the fake tensors' device, with the
    registered FLOPs (4 hd a visible pair forward, 10 backward)."""
    q, k, v = _k4_inputs("cpu")
    o_ref = fa_ref.attention_ref(q, k, v, True, 0, 20)
    lse_ref = fa_ref.lse_ref(q, k, True, 0, 20)
    before = (fa_ops.launches, fa_ops.bwd_launches)
    with FakeTensorMode():
        fq, fk, fv = _k4_inputs("cuda")
        with OpCounter() as c:
            o, lse = fa_ops.flash_attention_fwd(fq, fk, fv, window=20)
            grads = fa_ops.flash_attention_bwd(fq, fk, fv, o, o, True, 0,
                                               20, lse=lse)
        assert o.device.type == lse.device.type == "cuda"
        assert _meta([o, lse]) == _meta([o_ref, lse_ref])
        assert _meta(grads) == _meta([q, k, v])
    pairs = dry_run.visible_pairs(48, 48, True, 0, 20)
    assert pairs == 20 * 21 // 2 + 28 * 20
    assert c.cost.flops_by_op == {"k4_fwd": 4 * 4 * 64 * pairs,
                                  "k4_bwd": 10 * 4 * 64 * pairs}
    assert (fa_ops.launches, fa_ops.bwd_launches) == before


def test_k4_dry_op_under_autograd_saves_the_forwards_outputs():
    """Under autograd the forward op keeps o and the log-sum-exp for the
    backward (as ``FlashAttentionFn`` saves them) and its backward runs the
    backward op (FLOPs counted, gradients shaped)."""
    with FakeTensorMode():
        q, k, v = _k4_inputs("cpu", grad=True)
        with OpCounter() as c:
            c.track([q, k, v])
            o = dry_run.flash_attention(q, k, v, True, 0, 0)
            held = c.held_bytes - c.cost.start_bytes
            grads = torch.autograd.grad(o.float().sum(), (q, k, v))
        assert _meta(grads) == _meta([q, k, v])
    assert held == q.numel() * 2 + 1 * 4 * 48 * 4     # o and lse
    pairs = 48 * 49 // 2
    assert c.cost.flops_by_op["k4_fwd"] == 4 * 4 * 64 * pairs
    assert c.cost.flops_by_op["k4_bwd"] == 10 * 4 * 64 * pairs


def test_k5_dry_ops_give_the_plain_versions_shapes():
    """The forward's y, final state and checkpoints (the state before
    every 16th token, what the backward reads) and the backward's six
    gradients have the plain versions' shapes and dtypes; FLOPs 4 a state
    element and token forward, 14 backward."""
    r, k, v, logw, u = _k5_inputs("cpu")
    y_ref, s_ref = wkv_ref.wkv_ref(r, k, v, logw, u, None)
    ck_ref = wkv_ref.checkpoints_ref(k, v, logw, None, wkv_ops.CKPT_TOKENS)
    g_ref = wkv_ref.wkv_bwd_ref(r, k, v, logw, u, None, y_ref, None)
    before = (wkv_ops.launches, wkv_ops.bwd_launches)
    with FakeTensorMode():
        fr, fk, fv, fw, fu = _k5_inputs("cuda")
        with OpCounter() as c:
            y, s, ck = wkv_ops.wkv_fwd(fr, fk, fv, fw, fu)
            grads = wkv_ops.wkv_bwd(fr, fk, fv, fw, fu, None, y, ckpt=ck)
        assert y.device.type == "cuda"
        assert _meta([y, s, ck]) == _meta([y_ref, s_ref, ck_ref])
        assert _meta(grads) == _meta([g for g in g_ref if g is not None]
                                     + [s_ref])[:len(grads)]
    elems = 2 * 37 * 2 * 8 * 8
    assert c.cost.flops_by_op == {"k5_fwd": 4 * elems, "k5_bwd": 14 * elems}
    assert (wkv_ops.launches, wkv_ops.bwd_launches) == before


def test_k5_dry_op_under_autograd_holds_the_checkpoints():
    """Under autograd the forward op's checkpoints stay alive for the
    backward (they are what the card's backward reads) and the backward
    op's scratch is counted while it runs."""
    B, T, H, N = 2, 37, 2, 8
    ck_bytes = B * H * (-(-T // 16)) * N * N * 4
    with FakeTensorMode():
        r, k, v, logw, u = _k5_inputs("cpu", grad=True)
        with OpCounter() as c:
            c.track([r, k, v, logw, u])
            y, s = dry_run.wkv(r, k, v, logw, u, None)
            held = c.held_bytes
            grads = torch.autograd.grad(y.sum(), (r, k, v, logw, u))
        assert _meta(grads) == _meta([r, k, v, logw, u])
    inputs = 4 * B * T * H * N * 4 + H * N * 4
    # y, the final state, the zero initial state and the checkpoints
    assert held - inputs >= B * T * H * N * 4 + ck_bytes
    assert c.cost.peak_bytes > held


def test_real_tensors_never_take_the_dry_route():
    """A real CPU tensor runs the plain version through the public entry,
    and the dry-run op itself refuses a real tensor."""
    q, k, v = _k4_inputs("cpu", dtype=torch.float32)
    q.normal_()
    want = fa_ref.attention_ref(q, k, v, True, 0, 0)
    assert torch.equal(fa_ops.flash_attention(q, k, v), want)
    with pytest.raises(RuntimeError, match="shape-only"):
        dry_run.k4_fwd(q, k, v, True, 0, 0)
    r, k5, v5, logw, u = _k5_inputs("cpu")
    with pytest.raises(RuntimeError, match="shape-only"):
        dry_run.k5_fwd(r, k5, v5, logw, u, torch.zeros((2, 2, 8, 8)))


def test_hillclimb_variants_run():
    """The reference's three variant chains, each variant a cumulative
    change of the last, run through the port's dry run (here: the first
    two of llama's train chain at the tests' cut on one CPU rank)."""
    import dataclasses

    from repro_torch.configs import SHAPES
    from repro_torch.launch import hillclimb
    from repro_torch.launch.dryrun import reduce_cell
    from repro_torch.launch.mesh import make_local_mesh
    chains = {name: make() for name, make in hillclimb.CHAINS.items()}
    assert [v[0] for v in chains["llama_train"][2]] == [
        "baseline", "bf16_grads", "bf16_probs", "fsdp", "seq_parallel",
        "no_remat_mb16"]
    assert [v[0] for v in chains["kimi_train"][2]][-1] == "more_microbatches"
    arch, shape_name, chain = chains["llama_train"]
    rows = []
    for label, _, cfg in chain[:2]:
        small, sp = reduce_cell(cfg, SHAPES[shape_name])
        small = dataclasses.replace(small,
                                    grad_accum_dtype=cfg.grad_accum_dtype)
        rows.append(hillclimb.run_variant(small, sp, make_local_mesh(
            1, 1, "cpu"), f"{arch}/{label}", "cpu"))
    assert all(r["gflops"] > 0 and r["peak_mem_gb_per_chip"] > 0
               for r in rows)
    # bf16 gradient accumulators hold half the bytes of float32 ones
    assert rows[1]["peak_mem_gb_per_chip"] < rows[0]["peak_mem_gb_per_chip"]


# ---------------------------------------------------------------------------
# The dry run's input placements against the reference's, spec by spec
# ---------------------------------------------------------------------------

SHAPE_TABLES = {"16x16": {"data": 16, "model": 16},
                "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class _Table:
    """A production mesh's shape table (``test_torch_sharding.FakeMesh``);
    no process group."""

    def __init__(self, shape):
        self.shape = shape


def _ref_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` for 512 host
    devices: set back at once, so that no later test or subprocess of this
    worker inherits it (nothing here compiles)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _ref_specs(ref, cfg, shape, table, monkeypatch):
    """The reference's own ``batch_specs``, ``cache_specs``, token spec and
    microbatch clamp on a shape table: its ``ShardingCtx.spec`` in place of
    the ``NamedSharding`` a real mesh would give, each leaf's
    ``ShapeDtypeStruct`` kept as (shape, dtype name, spec)."""
    import jax
    from repro.distributed import sharding as ref_sharding
    from repro.models import steps as ref_steps

    class Leaf(tuple):
        pass

    class Ctx(ref_sharding.ShardingCtx):
        def sharding(self, names, shp, memory_kind=None):
            return self.spec(names, shp)

    monkeypatch.setattr(ref, "_sds", lambda shp, dt, sh: Leaf(
        (tuple(shp), jax.numpy.dtype(dt).name, sh)))
    ctx = Ctx(_Table(table))
    # repro/launch/dryrun.py:105-115, the clamp inside build_cell
    shards = ctx.axis_size(("pod", "data"))
    n_mb = min(max(cfg.train_microbatches, 1),
               max(shape.global_batch // shards, 1))
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, train_microbatches=n_mb)
    batch = ref.batch_specs(cfg, shape, ctx)
    B, T = shape.global_batch, shape.seq_len
    cache = {}
    if shape.kind == "decode":
        leaves = jax.tree_util.tree_flatten_with_path(
            ref.cache_specs(ref_steps.eval_cache_shapes(cfg, B, T), ctx),
            is_leaf=lambda x: isinstance(x, Leaf))[0]
        cache = {".".join(str(p.key) for p in path): leaf
                 for path, leaf in leaves}
    return {"batch": batch, "cache": cache, "n_mb": n_mb,
            "token": ctx.spec(("batch", None), (B, 1))}


@pytest.mark.parametrize("table", list(SHAPE_TABLES))
@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_placements_match_reference(arch, shape_name, table,
                                          monkeypatch):
    """For every config and shape on both production shape tables: the
    microbatch count after the clamp, the batch's shapes, dtypes and
    placements, the decode cache's placements leaf by leaf and the token's
    equal the reference's specs (as the port places a spec)."""
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import DEFAULT_RULES, ShardingCtx
    from repro_torch.launch import dryrun
    from repro_torch.models import encdec, lm

    ref = _ref_specs(_ref_dryrun(), ref_config(arch), REF_SHAPES[shape_name],
                     SHAPE_TABLES[table], monkeypatch)
    cfg, shape = get_config(arch), SHAPES[shape_name]
    ctx = ShardingCtx(_Table(SHAPE_TABLES[table]), dict(DEFAULT_RULES))
    n_mb = dryrun.microbatches(cfg, shape, ctx)
    assert n_mb == ref["n_mb"]
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, train_microbatches=n_mb)
    got = dryrun.batch_specs(cfg, shape, ctx)
    assert sorted(got) == sorted(ref["batch"])
    for name, (shp, dt, placements) in got.items():
        r_shape, r_dtype, r_spec = ref["batch"][name]
        assert (tuple(shp), str(dt).removeprefix("torch.")) == \
            (r_shape, r_dtype), name
        assert placements == ctx.placements(r_spec), name
    assert dryrun.token_placements(shape, ctx) == \
        ctx.placements(ref["token"])
    if shape.kind != "decode":
        return
    B, T = shape.global_batch, shape.seq_len
    cache = (encdec.init_cache(cfg, B, T, T, device="meta") if cfg.enc_dec
             else lm.init_cache(cfg, B, T, device="meta"))
    got = dryrun.cache_specs(cache, ctx)
    assert sorted(got) == sorted(ref["cache"])
    flat = lm.flat_cache(cache)
    for key, placements in got.items():
        r_shape, _, r_spec = ref["cache"][key]
        assert tuple(flat[key].shape) == r_shape, key
        assert placements == ctx.placements(r_spec), key
