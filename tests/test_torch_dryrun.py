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
from repro_torch.configs import SHAPES, get_config
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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The cells and the two per-rank comparisons at once, each in a
    process of its own."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    tmp = str(tmp_path_factory.mktemp("dry"))
    procs = {part: subprocess.Popen([sys.executable, "-c", SCRIPT, part, tmp],
                                    env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for part in ("cells", "kv2", "kv4")}
    out = {"per_rank": {}}
    for part, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        got = json.loads(stdout.strip().splitlines()[-1])
        if part == "cells":
            out["cells"] = got
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
