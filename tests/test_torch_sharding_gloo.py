"""The sharding layer with real values: the train step of reduced configs
on a 2 x 2 ``cpu`` mesh of 4 processes over ``gloo`` (parameters,
optimizer state and batch as DTensors placed by ``distributed/sharding.
py``'s rules, as the dry run places them) against the same step in one
process on plain tensors.

This holds what the dry run only counts: ``annotate`` and its gradient,
``split_heads`` on heads the axis divides (the reduced configs' 4 query
and 2 kv heads on the 2-way ``model`` axis), the vocab-sharded embedding
and gold logit (``take_rows``, ``take_last``), the MoE dispatch, and the
accumulators placed as the parameters.  Float32; the loss and every
gradient agree to float32 rounding (the mesh sums in another order), the
parameters after one AdamW step within 1e-4 (AdamW divides each entry by
its own gradient's scale, which lifts those roundings)."""
import json
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("llama3.2-3b", "qwen2-moe-a2.7b")

SCRIPT = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import param_specs, use_mesh
from repro_torch.launch import dryrun
from repro_torch.models import lm, steps
from repro_torch.train import optim

rank, port, archs = int(sys.argv[1]), sys.argv[2], sys.argv[3].split(",")


def setup(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              train_microbatches=2)
    model = lm.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 4, 16), generator=gen,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    return cfg, model, batch


def run(cfg, model, batch, ctx=None):
    # one microbatch's gradients, then one train step
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    mb = {k: v[0] for k, v in batch.items()}
    loss, _ = steps.compute_loss(model, cfg, mb)
    grads = torch.autograd.grad(loss, list(named.values()))
    opt = optim.adamw(1e-2)
    state = steps.init_train_state(model, opt)
    if ctx is not None:
        state["opt"] = dryrun._place_tree(state["opt"], ctx, False)
    state, m = steps.make_train_step(cfg, opt)(state, batch)

    def full(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().double()
    out = {"loss": full(loss), "step_loss": full(m["loss"]),
           "grad_norm": full(m["grad_norm"])}
    out.update({"grad." + n: full(g) for n, g in zip(named, grads)})
    out.update({"param." + n: full(p) for n, p in named.items()})
    return out


dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
got = {}
for arch in archs:
    cfg, model, batch = setup(arch)
    with use_mesh(mesh) as ctx:
        specs = param_specs(model, ctx)
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            mod._parameters[leaf] = torch.nn.Parameter(
                distribute_tensor(p.detach(), mesh,
                                  ctx.placements(specs[name])),
                requires_grad=False)
        pl = ctx.sharding((None, "batch", None), (2, 4, 16))
        batch = {k: distribute_tensor(v, mesh, pl) for k, v in batch.items()}
        with implicit_replication():
            got[arch] = run(cfg, model, batch, ctx)
dist.destroy_process_group()
if rank == 0:
    report = {}
    for arch in archs:
        want = run(*setup(arch))
        g = got[arch]
        report[arch] = {
            "keys": sorted(want) == sorted(g),
            "loss": float(abs(g["loss"] - want["loss"])),
            "step_loss": float(abs(g["step_loss"] - want["step_loss"])),
            "grad_norm_rel": float(abs(g["grad_norm"] / want["grad_norm"]
                                       - 1)),
            "grad": max(float((g[k] - want[k]).abs().max()
                              / max(float(want[k].abs().max()), 1e-30))
                        for k in want if k.startswith("grad.")),
            "param": max(float((g[k] - want[k]).abs().max())
                         for k in want if k.startswith("param."))}
    print(json.dumps(report))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def report():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT, str(r), port,
                               ",".join(ARCHS)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_one_process(report, arch):
    r = report[arch]
    assert r["keys"]
    assert r["loss"] < 1e-6 and r["step_loss"] < 1e-6
    assert r["grad_norm_rel"] < 1e-5
    assert r["grad"] < 1e-5          # of each gradient's largest entry
    assert r["param"] < 1e-4
