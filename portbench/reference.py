"""The plain reference that decides ``correct``, and the numbers compared.

Plain PyTorch and NumPy: it imports nothing of the program.  It works out
again, from the run's seed and the benchmark's own inputs, what the
trainer's first steps should have produced:

- the seed draw of each checked batch, and that every sampled edge is an
  edge of the graph, with the fanout and the node array the sampler's
  contract gives (sampling itself is not repeated: the trainer keeps two
  batches in flight, and their draws interleave on one generator);
- the feature rows, regenerated from the seed, against the rows the cache
  and the IO engines gathered, bit for bit;
- the parameters' initialisation, the forward and its loss, the gradient
  by autograd (clipped as the optimizer clips it), and AdamW's update, all
  in float32 with TF32 off, on the program's sampled blocks.

``precision="tf32"`` computes the dense products in TF32 instead (on a CPU
by rounding their operands to TF32's 10-bit mantissa): that is the
control, which the limits must fail.  ``precision="f64"`` computes all of
it in float64: a witness of how far float32's rounding alone moves each
number.  ``half_batch=True`` takes the loss
over the first half of the seeds only: a planted fault.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from portbench import models

ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_WD, MAX_GRAD_NORM = 0.9, 0.95, 1e-8, 0.1, 1.0


# ------------------------------------------------------------------ params
def init_params(model: str, seed: int, in_dim: int, hidden: int,
                n_classes: int, n_layers: int = 2, **args) -> dict:
    """The initial parameters, named leaf by leaf: N(0, 1/fan_in) weights
    ``(d_in, d_out)`` drawn in order from a CPU generator seeded with the
    trainer's seed, each layer's leaves as ``models/<model>.py`` gives
    them, zero biases."""
    gen = torch.Generator().manual_seed(seed)

    def dense(d_in, d_out):
        w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32)
        return w / math.sqrt(max(d_in, 1))

    mod = models.load(model)
    out = {}
    for i in range(n_layers):
        out.update(mod.init_layer(dense, i, in_dim if i == 0 else hidden,
                                  hidden, **args))
    out["head.w"] = dense(hidden, n_classes)
    out["head.b"] = torch.zeros(n_classes)
    return out


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict/list of tensors as ``{"a.0.b": tensor}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


# ----------------------------------------------------------------- forward
def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), nearest; the
    gradient passes through unchanged."""
    xd = x.detach().contiguous()
    r = ((xd.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - xd)


@contextlib.contextmanager
def _matmul_precision(precision: str):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _mm(a, b, precision):
    if precision == "tf32" and a.device.type == "cpu":
        return _round_tf32(a) @ _round_tf32(b)
    return a @ b


def forward_loss(p: dict, x: torch.Tensor, blocks, labels: torch.Tensor,
                 model: str, precision: str = "f32",
                 half_batch: bool = False, **args) -> torch.Tensor:
    """Mean cross-entropy of the seeds.  ``x``: (n, F) rows of the batch's
    nodes; ``blocks``: outer hop first, ``(src, dst)`` int64 positions of
    the VALID edges only; the seeds are positions ``0..len(labels)-1``.
    Each layer is ``models/<model>.py``'s."""
    mod = models.load(model)

    def mm(a, b):
        return _mm(a, b, precision)

    h = x
    for i, (src, dst) in enumerate(reversed(blocks)):
        h = mod.layer(p, i, h, src, dst, x.shape[0], mm, **args)
    b = len(labels)
    if half_batch:
        b //= 2
    logits = _mm(h[:b], p["head.w"], precision) + p["head.b"]
    gold = logits.gather(1, labels[:b, None].long())[:, 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)


def adamw_step(p: dict, g: dict, m: dict, v: dict, t: int, lr: float):
    """One AdamW update in place, as the trainer's optimizer states it:
    gradients clipped to a global norm of 1, weight decay on every leaf
    inside the step, bias corrections in float32."""
    gn = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
    scale = torch.clamp(MAX_GRAD_NORM / torch.clamp(gn, min=1e-9), max=1.0)
    tt = torch.tensor(float(t), dtype=torch.float32)
    bc1 = (1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** tt).item()
    bc2 = (1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** tt).item()
    for k in p:
        gk = g[k] * scale
        g[k] = gk
        m[k] = m[k] * ADAM_B1 + (1 - ADAM_B1) * gk
        v[k] = v[k] * ADAM_B2 + (1 - ADAM_B2) * gk * gk
        u = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + ADAM_EPS)
        p[k] = p[k] - lr * (u + ADAM_WD * p[k])


def run_steps(p0: dict, steps: list, model: str, lr: float,
              precision: str = "f32", half_batch: bool = False,
              **args) -> dict:
    """The reference's first steps from ``p0``.  ``steps``: one dict a
    step with ``x`` (rows), ``blocks`` (valid edges) and ``labels``, all on
    one device.  Returns the losses, the clipped first gradient and the
    parameters after the last step (as CPU float32)."""
    dev = steps[0]["x"].device
    dt = torch.float64 if precision == "f64" else torch.float32
    p = {k: t.to(dev, dt) for k, t in p0.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    losses, g1 = [], None
    with _matmul_precision(precision):
        for t, st in enumerate(steps, start=1):
            leaves = {k: t_.detach().requires_grad_(True)
                      for k, t_ in p.items()}
            with torch.enable_grad():
                loss = forward_loss(leaves, st["x"].to(dt), st["blocks"],
                                    st["labels"], model, precision,
                                    half_batch, **args)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            g = {k: gr.detach() for k, gr in zip(leaves, grads)}
            adamw_step(p, g, m, v, t, lr)
            losses.append(float(loss.detach()))
            if g1 is None:
                g1 = {k: x.cpu() for k, x in g.items()}
    return {"losses": losses, "grad1": g1,
            "params": {k: x.cpu() for k, x in p.items()}}


# ------------------------------------------------------------- comparison
def leaf_gaps(got: dict, want: dict, leaves=None) -> dict:
    """{leaf: the gap between the norms of the leaf on the two sides, over
    the larger of the reference's norm of that leaf and of the median
    leaf}."""
    keys = list(want) if leaves is None else list(leaves)
    ref = {k: float(torch.linalg.vector_norm(want[k].double())) for k in want}
    med = float(np.median(list(ref.values())))
    return {k: abs(float(torch.linalg.vector_norm(got[k].double())) - ref[k])
            / max(ref[k], med, 1e-30) for k in keys}


def worst_leaf_gap(got: dict, want: dict, leaves=None) -> float:
    """The largest of ``leaf_gaps``."""
    return max(leaf_gaps(got, want, leaves).values())


def moving_leaves(grad1: dict) -> list:
    """Leaves whose first gradient is at least a thousandth of the median
    leaf's (by norm): the others move under Adam by rounding alone."""
    norms = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in grad1.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, x in norms.items() if x >= 1e-3 * med]


def direction_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The distance between the two tensors scaled to unit norm (0 to 2;
    1 where the program's is all zeros)."""
    a, b = got.double().flatten(), want.double().flatten()
    na, nb = torch.linalg.vector_norm(a), torch.linalg.vector_norm(b)
    if na == 0 or nb == 0:
        return 1.0
    return float(torch.linalg.vector_norm(a / na - b / nb))


def numbers(got: dict, want: dict, p0: dict) -> dict:
    """The numbers that hold a run of steps against the reference's: the
    largest relative gap of a step's loss, and that of the first step's
    alone (before any update, which rounding-level gradient entries turn
    into whole steps under Adam), the worst leaf's gap of the first
    gradient's norm, the largest gap of the output layer's first
    gradients' directions, and the worst moving leaf's gap of the norm of
    the parameters' change over the steps.  The output layer's gradients
    are continuous in the rounding below them (a ReLU's output is; its
    derivative, which the gradients of the layers below go through, is
    not), and a direction is free of the global-norm clip."""
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(got["losses"], want["losses"])]
    grad_gap = worst_leaf_gap(got["grad1"], want["grad1"])
    d_got = {k: got["params"][k] - p0[k] for k in p0}
    d_want = {k: want["params"][k] - p0[k] for k in p0}
    upd_gap = worst_leaf_gap(d_got, d_want, moving_leaves(want["grad1"]))
    head = max(direction_gap(got["grad1"][k], want["grad1"][k])
               for k in want["grad1"] if k.startswith("head."))
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad_gap": grad_gap,
            "head_grad_gap": head, "update_gap": upd_gap}


# ---------------------------------------------------------------- sampling
class EdgeIndex:
    """Membership of (dst, src) pairs in a CSR graph, on a device."""

    def __init__(self, rowptr: np.ndarray, col: np.ndarray, device):
        n = len(rowptr) - 1
        self.n = n
        rp = torch.from_numpy(rowptr).to(device)
        self.deg = rp[1:] - rp[:-1]
        rows = torch.repeat_interleave(torch.arange(n, device=device),
                                       self.deg)
        self.keys = torch.sort(rows * n + torch.from_numpy(col).to(device))[0]

    def contains(self, dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        """True where src is a neighbour of dst, or equals an isolated dst
        (the sampler's self loop)."""
        q = dst * self.n + src
        pos = torch.searchsorted(self.keys, q).clamp(max=len(self.keys) - 1)
        hit = self.keys[pos] == q if len(self.keys) else torch.zeros_like(
            q, dtype=torch.bool)
        return hit | ((self.deg[dst] == 0) & (src == dst))


def sample_faults(edges: EdgeIndex, nodes: np.ndarray, n_real: int,
                  seeds: np.ndarray, blocks, fanouts, device) -> int:
    """Departures of one sampled batch from the sampler's contract: node
    array (the seeds first, every touched vertex once, nothing else), and
    each hop's edges (``fanout`` of them from every frontier vertex, in
    frontier order, each an edge of the graph), padding masked off."""
    faults = 0
    b = len(seeds)
    real = nodes[:n_real]
    faults += int(np.count_nonzero(real[:b] != seeds))
    faults += n_real - len(np.unique(real))
    frontier = seeds
    touched = [seeds]
    for (src_pos, dst_pos, em), f in zip(blocks, fanouts):
        k = len(frontier) * f
        faults += int(np.count_nonzero(em != (np.arange(len(em)) < k)))
        sp, dp = src_pos[:k], dst_pos[:k]
        if sp.size and (sp.max() >= n_real or dp.max() >= n_real):
            return faults + k
        src, dst = real[sp], real[dp]
        faults += int(np.count_nonzero(dst != np.repeat(frontier, f)))
        ok = edges.contains(torch.from_numpy(dst).to(device),
                            torch.from_numpy(src).to(device))
        faults += int((~ok).sum())
        touched.append(src)
        frontier = np.unique(src)
    faults += abs(n_real - len(np.unique(np.concatenate(touched))))
    return faults
