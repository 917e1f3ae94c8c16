"""The port's LM train step against the reference package on the CPU: the
loss (``fused_xent``, ``compute_loss``), every parameter's gradient, one
``make_train_step`` under AdamW and under Adafactor with two microbatches,
the optimizers' in-place updates against their functional form, Adafactor
against ``repro.train.optim``, the input and cache signatures of every
(config, shape) cell, one bfloat16 case per family, and the launcher, its
resume and checkpoints across the two packages.

Every registered config at ``.reduced()`` width, in float32 unless a test
says otherwise; parameters are the reference's, carried over by
``params_from_numpy``; batches are made with numpy from a seed.  rwkv6-7b
is compared only where its log-decays lie in [-4, -1e-4] (checked): the
reference's chunked WKV overflows below (ROADMAP.md §3).

Tolerances (float32; the two frameworks sum in other orders):
- loss, nll, z, aux, the train step's loss and grad_norm: 1e-5 relative;
- each gradient leaf: within 1e-4 of the leaf's largest entry;
- the train step's new parameters and optimizer state: 1e-6 absolute plus
  1e-5 relative, with two kinds of entries held to 2 lr + 1e-6 instead
  (at most 64 of them a config).  AdamW's first step moves an entry by
  lr * g / (|g| + 1e-8) (plus weight decay): about +-lr wherever |g| is
  well above 1e-8, but the quotient's slope is 1e-8 / (|g| + 1e-8)^2, so
  where the clipped gradient is under 1e-5 it magnifies g's float32
  rounding.  And a key bias's exact gradient is zero (softmax ignores a
  shift common to every key): both sides hand the optimizer rounding
  noise there, which Adafactor normalises to a step of up to lr.
- bfloat16 (one config per family): the loss within 2e-2 relative, each
  gradient leaf within 1e-1 of its largest entry (bf16 keeps 8 bits and
  the two frameworks round at other places through every layer).  A key
  bias's exact gradient is zero (softmax ignores a shift common to every
  key), so both sides give bf16 rounding noise there, up to a tenth of
  the leaf's own largest entry apart: each side is held under 5e-2 of the
  whole tree's largest gradient entry instead.  The MoE config runs on
  the reference's top-k choices with its own weights there
  (``_feed_routing_differentiably``), without remat.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lm_ref_compare import (configs, feed_reference_routing,  # noqa: E402
                            params, t)
from repro.checkpoint.checkpoint import \
    CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import steps as ref_steps  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.core.tree import (Stacked, full, slices,  # noqa: E402
                                   tree_clone, tree_leaves, tree_map)
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import lm, moe, rwkv6, steps  # noqa: E402
from repro_torch.train import optim  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_configs()
N_MB, MB, S, Q_CHUNK = 2, 2, 16, 8
LR = 1e-3
FAMILIES_BF16 = ("llama3.2-3b", "qwen2-moe-a2.7b", "recurrentgemma-2b",
                 "rwkv6-7b", "phi-3-vision-4.2b", "whisper-small")


def _batch(cfg, seed):
    """A train batch in numpy, every leaf (N_MB, MB, ...)."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (N_MB, MB, S))
           .astype(np.int32)}
    if cfg.enc_dec or not cfg.frontend:
        out["tokens"] = rng.integers(0, cfg.vocab, (N_MB, MB, S)) \
            .astype(np.int32)
    if cfg.frontend:
        x = (rng.normal(size=(N_MB, MB, S, cfg.d_model)) * 0.5) \
            .astype(np.float32)
        out["enc_embeds" if cfg.enc_dec else "embeds"] = x
    return out


def _ref_batch(b, dtype):
    return {k: jnp.asarray(v) if v.dtype == np.int32
            else jnp.asarray(v, dtype) for k, v in b.items()}


def _port_batch(b, dtype):
    return {k: t(v).long() if v.dtype == np.int32 else t(v).to(dtype)
            for k, v in b.items()}


def _mb(b, i=0):
    return {k: v[i] for k, v in b.items()}


@pytest.fixture
def logw_range(monkeypatch):
    """The log-decays every RWKV time-mix of the port hands its WKV scan,
    as (min, max) pairs."""
    seen = []
    wkv = rwkv6.wkv

    def record(r, k, v, logw, u, state=None):
        seen.append((float(logw.min()), float(logw.max())))
        return wkv(r, k, v, logw, u, state)
    monkeypatch.setattr(rwkv6, "wkv", record)
    return seen


def _feed_routing_differentiably(monkeypatch):
    """``feed_reference_routing`` with the port's own weights at the
    reference's choices: the top-k indices are the reference's, the
    weights the port's router probabilities gathered there and
    renormalised, so the gradient still reaches the router and the
    layer's input through them (the fed numpy weights carry none)."""
    fifo, seen = feed_reference_routing(monkeypatch)
    fed = moe.router_weights

    def call(logits, mcfg, valid):
        _, idx, aux, z = fed(logits, mcfg, valid)
        E = logits.shape[-1]
        if valid < E:
            logits = torch.where(torch.arange(E) < valid, logits, -1e30)
        w = torch.softmax(logits, dim=-1).gather(-1, idx)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx, \
            aux, z
    monkeypatch.setattr(moe, "router_weights", call)
    return fifo, seen


def _check_logw(name, seen):
    if name == "rwkv6-7b":
        assert seen and all(-4.0 <= lo and hi <= -1e-4 for lo, hi in seen), \
            seen


def _rel(got, want, tol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(abs(want), 1e-30), (what, got, want)


def _ref_layout(named: dict) -> dict:
    """{dotted name: tensor} of the port as the reference's tree of
    float32 numpy arrays (stacked leaves stacked)."""
    return tree_map(lambda x: full(x).detach().float().numpy(),
                          lm.param_tree(named))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def _grads_close(got_tree, want_tree, tol, noise=None):
    """Each leaf within ``tol`` of its largest entry.  With ``noise``, a
    key bias (exact gradient zero) is held on both sides under ``noise``
    times the whole tree's largest entry instead."""
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(np.asarray(w, np.float32)).max())
              for w in want.values() if np.size(w))
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = np.asarray(got[k], np.float32)
        assert g.shape == w.shape, k
        if noise is not None and k.endswith(".bk"):
            assert max(np.abs(g).max(), np.abs(w).max()) <= noise * top, k
            continue
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= tol * max(float(np.abs(w).max()), 1e-7), (k, err)


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------

def test_fused_xent_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    rn, rz = ref_steps.fused_xent(jnp.asarray(logits), jnp.asarray(labels))
    pn, pz = steps.fused_xent(t(logits), t(labels).long())
    _rel(pn, rn, 1e-6, "nll")
    _rel(pz, rz, 1e-6, "z")
    assert steps.Z_LOSS == ref_steps.Z_LOSS


@pytest.mark.parametrize("name", ARCHS)
def test_compute_loss_matches_reference(name, logw_range):
    """loss, nll, z and the MoE aux loss of one microbatch."""
    cfg_r, cfg_p = configs(name)
    tree, model = params(cfg_r, cfg_p)
    b = _batch(cfg_r, 1)
    rl, rparts = ref_steps.compute_loss(tree, cfg_r, _ref_batch(_mb(b),
                                                               jnp.float32),
                                        Q_CHUNK)
    pl, pparts = steps.compute_loss(model, cfg_p,
                                    _port_batch(_mb(b), torch.float32),
                                    Q_CHUNK)
    _check_logw(name, logw_range)
    _rel(pl, rl, 1e-5, "loss")
    for k in ("nll", "z"):
        _rel(pparts[k], rparts[k], 1e-5, k)
    assert abs(float(pparts["aux"]) - float(rparts["aux"])) <= \
        1e-5 * max(abs(float(rparts["aux"])), 1e-6)
    if cfg_p.moe is not None:
        assert float(pparts["aux"]) > 0


@pytest.mark.parametrize("name", ARCHS)
def test_gradients_match_reference(name, logw_range):
    """Every parameter's gradient of one microbatch's loss (through
    checkpointed layers: ``remat`` is on in every reduced config) against
    ``jax.grad``."""
    cfg_r, cfg_p = configs(name)
    assert cfg_p.remat
    tree, model = params(cfg_r, cfg_p)
    b = _batch(cfg_r, 2)
    want = jax.grad(lambda p: ref_steps.compute_loss(
        p, cfg_r, _ref_batch(_mb(b), jnp.float32), Q_CHUNK)[0])(tree)
    named = dict(model.requires_grad_(True).named_parameters())
    loss, _ = steps.compute_loss(model, cfg_p,
                                 _port_batch(_mb(b), torch.float32), Q_CHUNK)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    got = {n: (g if g is not None else torch.zeros_like(p))
           for (n, p), g in zip(named.items(), grads)}
    _check_logw(name, logw_range)
    _grads_close(_ref_layout(got), jax.tree.map(np.asarray, want), 1e-4)


def test_remat_changes_no_gradient():
    """The same gradients with and without per-layer checkpointing (the
    hybrid checkpoints whole repeat groups and not its tail)."""
    for name in ("llama3.2-3b", "recurrentgemma-2b", "whisper-small"):
        out = []
        for remat in (True, False):
            cfg_r, cfg_p = configs(name, remat=remat)
            _, model = params(cfg_r, cfg_p)
            named = dict(model.requires_grad_(True).named_parameters())
            loss, _ = steps.compute_loss(
                model, cfg_p, _port_batch(_mb(_batch(cfg_r, 3)),
                                          torch.float32), Q_CHUNK)
            out.append(torch.autograd.grad(loss, list(named.values())))
        for a, b in zip(*out):
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-7), name


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _optimizers(kind):
    if kind == "adamw":
        return ref_optim.adamw(LR), optim.adamw(LR)
    return ref_optim.adafactor(1e-2), optim.adafactor(1e-2)


def _params_close(got, want, grads, lr):
    """New parameters (or state) within 1e-6 + 1e-5 relative, but the
    entries the module docstring names, within 2 lr + 1e-6: with
    ``grads`` (AdamW's clipped gradient), those under 1e-5; and a key
    bias, whose exact gradient is zero, under either optimizer.  Returns
    how many entries took the wider bound."""
    wide = 0
    for k, w in _leaves(want).items():
        w = np.asarray(w, np.float32)
        g = np.asarray(got[k], np.float32)
        err = np.abs(g - w)
        bad = err > 1e-6 + 1e-5 * np.abs(w)
        loose = np.full(w.shape, k.endswith(".bk"))
        if grads is not None:
            loose |= np.abs(np.asarray(grads[k], np.float32)) < 1e-5
        assert (err[loose] <= 2 * lr + 1e-6).all(), k
        wide += int((bad & loose).sum())
        bad &= ~loose
        assert not bad.any(), (k, float(err.max()), int(bad.sum()))
    return wide


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference(name, kind, logw_range):
    """One ``make_train_step`` with two microbatches: loss and grad_norm,
    the new parameters and the optimizer's state (the state in the
    reference's layout, leaf for leaf)."""
    cfg_r, cfg_p = configs(name)
    tree, model = params(cfg_r, cfg_p)
    ref_opt, port_opt = _optimizers(kind)
    b = _batch(cfg_r, 4)
    rstate, rm = jax.jit(ref_steps.make_train_step(cfg_r, ref_opt, Q_CHUNK))(
        {"params": tree, "opt": ref_opt.init(tree)},
        _ref_batch(b, jnp.float32))
    pstate = steps.init_train_state(model, port_opt)
    pstate, pm = steps.make_train_step(cfg_p, port_opt, Q_CHUNK)(
        pstate, _port_batch(b, torch.float32))
    _check_logw(name, logw_range)
    _rel(pm["loss"], rm["loss"], 1e-5, "loss")
    _rel(pm["grad_norm"], rm["grad_norm"], 1e-5, "grad_norm")
    assert pstate["params"] is model and int(pstate["opt"]["step"]) == 1
    # the clipped averaged gradient, where AdamW's sign turns on rounding
    grads = None
    if kind == "adamw":
        g = jax.grad(lambda p: sum(
            ref_steps.compute_loss(p, cfg_r, _ref_batch(_mb(b, i),
                                                        jnp.float32),
                                   Q_CHUNK)[0] for i in range(N_MB)) / N_MB)(
            tree)
        g, _ = ref_optim.clip_by_global_norm(g, 1.0)
        grads = _leaves(jax.tree.map(np.asarray, g))
    got = _leaves(tree_map(
        lambda x: np.asarray(x, np.float32), lm.params_to_numpy(model)))
    lr = LR if kind == "adamw" else 1e-2
    wide = _params_close(got, rstate["params"], grads, lr)
    assert wide <= 64, wide
    want_opt = _leaves(jax.tree.map(np.asarray, rstate["opt"]))
    got_opt = _leaves(tree_map(lambda x: x.float().numpy(),
                                     pstate["opt"]))
    assert sorted(got_opt) == sorted(want_opt)
    _params_close(got_opt, want_opt, None, lr)


def test_train_step_lowers_the_loss():
    """Three steps on one batch lower its loss (the reference's
    ``test_train_step_smoke``), in the config's own bfloat16."""
    cfg = get_config("llama3.2-3b").reduced()
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = optim.adamw(1e-2)
    state = steps.init_train_state(model, opt)
    step = steps.make_train_step(cfg, opt, Q_CHUNK)
    b = _port_batch(_batch(cfg, 5), torch.bfloat16)
    losses = [float(step(state, b)[1]["loss"]) for _ in range(3)]
    assert losses[2] < losses[0]


# ---------------------------------------------------------------------------
# The optimizers
# ---------------------------------------------------------------------------

def _random_like(tree, rng, scale):
    return tree_map(
        lambda x: Stacked(torch.from_numpy(
            (scale * rng.normal(size=s.shape)).astype(np.float32)).to(s.dtype)
            for s in x) if isinstance(x, Stacked)
        else torch.from_numpy((scale * rng.normal(size=x.shape))
                              .astype(np.float32)).to(x.dtype), tree)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        for xs, ys in zip(slices(x), slices(y)):
            assert xs.dtype == ys.dtype and torch.equal(xs, ys)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["adamw", "adamw_bf16", "adafactor"])
def test_update_in_place_is_bit_identical(kind, dtype, monkeypatch):
    """``update_`` against ``update`` (``update_`` on copies), bit for
    bit, over three steps: the reduced hybrid's parameter tree (stacked
    leaves as ``Stacked``, a repeat stack deeper than 8 for Adafactor's
    per-slice path), with gradients that need clipping.  ``update`` leaves
    its inputs as they were; ``update_`` walks AdamW's leaves in chunks
    smaller than the leaves, ``update`` takes each whole."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              n_layers=28, dtype=dtype)
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = optim.get_optimizer(kind, lr=optim.warmup_cosine(1e-2, 2, 10))
    tree = lm.param_tree(model)
    assert any(isinstance(x, Stacked) and x.shape[0] > 8
               and len(x.shape) >= 3 for x in tree_leaves(tree))
    assert max(x.numel() for x in model.parameters()) < optim.CHUNK
    p_fun, p_in = tree_clone(tree), tree_clone(tree)
    s_fun, s_in = opt.init(p_fun), opt.init(p_in)
    rng = np.random.default_rng(7)
    for _ in range(3):
        g = _random_like(tree, rng, 3.0)
        assert float(optim.global_norm(g)) > 1.0
        before = [tree_clone(x) for x in (g, s_fun, p_fun)]
        new_p, new_s = opt.update(g, s_fun, p_fun)
        for x, y in zip(before, (g, s_fun, p_fun)):
            _equal(x, y)
        p_fun, s_fun = new_p, new_s
        with monkeypatch.context() as m:
            m.setattr(optim, "CHUNK", 1000)
            opt.update_(tree_clone(g), s_in, p_in)
        _equal(p_in, p_fun)
        _equal(s_in, s_fun)


@pytest.mark.parametrize("opt_name", ["adafactor", "adamw", "adamw_bf16"])
def test_optimizer_converges_on_the_reference_quadratic(opt_name):
    """``tests/test_substrate.py``'s quadratic, 60 steps on both packages:
    the same parameters at every step (1e-4 relative, 1e-6 absolute: a
    last-bit difference in a step, from ``pow`` or a mean, carries through
    the later steps) and the loss under 5% of its start."""
    kw = {"lr": 0.5} if opt_name == "adafactor" else {"lr": 0.1}
    ref = (ref_optim.adamw(0.1, moment_dtype=jnp.bfloat16)
           if opt_name == "adamw_bf16" else
           getattr(ref_optim, opt_name)(**kw))
    port = optim.get_optimizer(opt_name, **kw)
    rp = {"w": jnp.array([3.0, -2.0]), "b": jnp.array([[1.0, 2.0],
                                                       [3.0, 4.0]])}
    tp = {k: t(np.asarray(v)) for k, v in rp.items()}
    rs, ts = ref.init(rp), port.init(tp)

    def loss(p):
        return sum((v ** 2).sum() for v in p.values())
    l0 = float(loss(tp))
    for _ in range(60):
        rp, rs = ref.update(jax.grad(loss)(rp), rs, rp)
        tp, ts = port.update({k: 2 * v for k, v in tp.items()}, ts, tp)
        for k in rp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                       rtol=1e-4, atol=1e-6)
    assert float(loss(tp)) < 0.05 * l0


@pytest.mark.parametrize("scan_stacked", [True, False])
def test_adafactor_stacked_leaf_matches_reference(scan_stacked):
    """A rank-3 leaf with a leading axis of 12 (> 8: the reference scans
    it, each slice clipped by its own RMS), a matrix and a vector, five
    steps with weight decay; parameters and factored state within 1e-5
    relative (1e-7 absolute), as plain tensors and with the stack held as
    ``Stacked`` slices."""
    rng = np.random.default_rng(11)
    p0 = {"stack": rng.normal(size=(12, 6, 10)).astype(np.float32),
          "mat": rng.normal(size=(7, 5)).astype(np.float32),
          "vec": rng.normal(size=(9,)).astype(np.float32)}
    kw = dict(lr=3e-2, weight_decay=0.01, scan_stacked=scan_stacked)
    ref, port = ref_optim.adafactor(**kw), optim.adafactor(**kw)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    rs = ref.init(rp)
    plain = {k: t(v) for k, v in p0.items()}
    held = dict(plain, stack=Stacked(t(p0["stack"]).unbind(0)))
    ps, hs = port.init(plain), port.init(held)
    for _ in range(5):
        g = {k: (rng.normal(size=v.shape) * 2).astype(np.float32)
             for k, v in p0.items()}
        rp, rs = ref.update({k: jnp.asarray(v) for k, v in g.items()}, rs, rp)
        plain, ps = port.update({k: t(v) for k, v in g.items()}, ps, plain)
        port.update_(dict({k: t(v) for k, v in g.items()}), hs, held)
        for k in p0:
            for got in (plain[k], full(held[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(rp[k]),
                                           rtol=1e-5, atol=1e-7)
        for k, v in _leaves(jax.tree.map(np.asarray, rs["v"])).items():
            for st in (ps, hs):
                np.testing.assert_allclose(_leaves(st["v"])[k].numpy(), v,
                                           rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_input_shapes_match_reference(name):
    """Every (config, shape) cell at the published widths, and the train
    cells at 1, 2 and 8 microbatches."""
    cfg_r, cfg_p = ref_get_config(name), get_config(name)
    for key, shape in SHAPES.items():
        for n_mb in ((None, 2, 8) if shape.kind == "train" else (None,)):
            want = ref_steps.input_shapes(cfg_r, REF_SHAPES[key], n_mb)
            got = steps.input_shapes(cfg_p, shape, n_mb)
            assert sorted(got) == sorted(want), (key, n_mb)
            for k, (shp, dt) in want.items():
                assert got[k][0] == tuple(shp), (key, k)
                assert str(got[k][1]).removeprefix("torch.") == \
                    str(jnp.dtype(dt)), (key, k)


@pytest.mark.parametrize("name", ARCHS)
def test_eval_cache_shapes_match_reference(name):
    """The decode cache of decode_32k at the published widths, on the meta
    device (nothing allocated), leaf for leaf against ``jax.eval_shape``."""
    cfg_r, cfg_p = ref_get_config(name), get_config(name)
    shape = SHAPES["decode_32k"]
    want = _leaves(ref_steps.eval_cache_shapes(cfg_r, shape.global_batch,
                                               shape.seq_len))
    got = _leaves(steps.eval_cache_shapes(cfg_p, shape.global_batch,
                                          shape.seq_len))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k


# ---------------------------------------------------------------------------
# bfloat16, one config per family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES_BF16)
def test_bf16_loss_and_gradients(name, monkeypatch, logw_range):
    """The loss within 2e-2 relative and each gradient leaf within 1e-1 of
    its largest entry, in bfloat16; the MoE config on the reference's
    routing (a rounding difference can flip a top-k choice), with remat
    off so each router runs once per layer on each side."""
    fed = name == "qwen2-moe-a2.7b"
    cfg_r, cfg_p = configs(name, "bfloat16", remat=not fed)
    if fed:
        fifo, seen = _feed_routing_differentiably(monkeypatch)
    tree, model = params(cfg_r, cfg_p)
    b = _mb(_batch(cfg_r, 6))
    (rl, _), want = jax.value_and_grad(
        lambda p: ref_steps.compute_loss(p, cfg_r,
                                         _ref_batch(b, jnp.bfloat16),
                                         Q_CHUNK), has_aux=True)(tree)
    named = dict(model.requires_grad_(True).named_parameters())
    loss, _ = steps.compute_loss(model, cfg_p,
                                 _port_batch(b, torch.bfloat16), Q_CHUNK)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    got = {n: (g if g is not None else torch.zeros_like(p))
           for (n, p), g in zip(named.items(), grads)}
    _check_logw(name, logw_range)
    _rel(loss, rl, 2e-2, "bf16 loss")
    _grads_close(_ref_layout(got), jax.tree.map(
        lambda a: np.asarray(a, np.float32), want), 1e-1, noise=5e-2)
    if fed:
        assert not fifo and seen["calls"] == cfg_p.n_layers


# ---------------------------------------------------------------------------
# The launcher, the example and checkpoints across the two packages
# ---------------------------------------------------------------------------

def test_launcher_runs_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch llama3.2-3b --steps 3
    --device cpu`` runs and checkpoints its last step."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + os.environ.get("PYTHONPATH", "")
        .split(os.pathsep)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-3b", "--steps", "3", "--device", "cpu", "--ckpt-dir",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300, check=True).stdout
    assert "device=cpu" in out and "step    2 loss" in out
    assert "checkpoints: [2]" in out


def test_launcher_resumes_exactly(tmp_path):
    """A run resumed from its step-2 checkpoint gives the losses the
    uninterrupted run gives at steps 3 and 4 (float32 parameters and the
    data cursor of the consumed batches restored; the schedule spans the
    same five steps)."""
    common = ["--arch", "llama3.2-3b", "--device", "cpu"]
    whole = launcher.main(common + ["--steps", "5", "--ckpt-dir",
                                    str(tmp_path / "a")])
    first = launcher.main(common + ["--steps", "3", "--ckpt-dir",
                                    str(tmp_path / "b")])
    rest = launcher.main(common + ["--steps", "2", "--resume", "--ckpt-dir",
                                   str(tmp_path / "b")])
    assert first == whole[:3]
    assert rest == whole[3:]


@pytest.mark.parametrize("arch", ["whisper-small", "phi-3-vision-4.2b",
                                  "rwkv6-7b", "qwen2-moe-a2.7b"])
def test_launcher_trains_every_family_on_the_cpu(arch):
    losses = launcher.main(["--arch", arch, "--steps", "2", "--batch", "4",
                            "--seq", "16", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_consumed_state_skips_no_batch(tmp_path):
    """An iterator rebuilt from ``consumed_state`` yields the batches the
    original yields next, across an epoch boundary."""
    from repro_torch.data.tokens import OutOfCoreTokenIterator, TokenStore
    store = TokenStore(str(tmp_path / "tok"), n_sequences=20, seq_len=4,
                       vocab=50, n_shards=2, create=True)
    it = OutOfCoreTokenIterator(store, 4, 2)
    for n in range(9):
        state = launcher.consumed_state(it)
        again = OutOfCoreTokenIterator(
            store, 4, 2, state=OutOfCoreTokenIterator.restore_state(state))
        a, b = next(it), next(again)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_example_runs_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "train_llm_tiered_torch",
        os.path.join(ROOT, "examples", "train_llm_tiered_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.main(["--steps", "20", "--arch", "llama3.2-3b", "--device",
                        "cpu"])
    assert len(out["losses"]) == 20 and out["checkpoints"] == [19]
    assert out["losses"][-1] < out["losses"][0]


def test_checkpoints_cross_packages(tmp_path):
    """A reference train state after one step, saved by ``repro``'s
    CheckpointManager, restores in the port (``params_from_numpy``; the
    optimizer state as tensors) and gives the reference's next step's loss
    and grad_norm; the port's state after that step (``params_to_numpy``)
    restores in ``repro`` and gives the port's loss on a third batch."""
    cfg_r, cfg_p = configs("llama3.2-3b")
    tree, _ = params(cfg_r, cfg_p)
    ref_opt, port_opt = _optimizers("adamw")
    ref_step = jax.jit(ref_steps.make_train_step(cfg_r, ref_opt, Q_CHUNK))
    b1, b2, b3 = (_batch(cfg_r, s) for s in (7, 8, 9))
    rstate, _ = ref_step({"params": tree, "opt": ref_opt.init(tree)},
                         _ref_batch(b1, jnp.float32))
    RefCheckpointManager(str(tmp_path / "r"), async_write=False).save(
        1, rstate)
    restored, extra = CheckpointManager(str(tmp_path / "r")).restore(
        device="cpu")
    assert extra["step"] == 1
    model = lm.params_from_numpy(restored["params"], cfg_p, "cpu")
    pstate = {"params": model, "opt": restored["opt"]}
    _, rm = ref_step(rstate, _ref_batch(b2, jnp.float32))
    pstate, pm = steps.make_train_step(cfg_p, port_opt, Q_CHUNK)(
        pstate, _port_batch(b2, torch.float32))
    _rel(pm["loss"], rm["loss"], 1e-5, "loss after restore")
    _rel(pm["grad_norm"], rm["grad_norm"], 1e-5, "grad_norm after restore")
    assert int(pstate["opt"]["step"]) == 2

    CheckpointManager(str(tmp_path / "p"), async_write=False).save(
        2, {"params": lm.params_to_numpy(model), "opt": pstate["opt"]})
    back, _ = RefCheckpointManager(str(tmp_path / "p")).restore()
    assert int(back["opt"]["step"]) == 2
    rl, _ = ref_steps.compute_loss(
        jax.tree.map(jnp.asarray, back["params"]), cfg_r,
        _ref_batch(_mb(b3), jnp.float32), Q_CHUNK)
    with torch.no_grad():
        pl, _ = steps.compute_loss(model, cfg_p,
                                   _port_batch(_mb(b3), torch.float32),
                                   Q_CHUNK)
    _rel(pl, rl, 1e-5, "loss of the port's state in the reference")


def test_params_to_numpy_inverts_params_from_numpy():
    """The reference's tree, bf16 leaves included (CPU tensors on the
    port's side), round-trips exactly."""
    cfg_r, cfg_p = ref_get_config("recurrentgemma-2b").reduced(), \
        get_config("recurrentgemma-2b").reduced()
    tree, model = params(cfg_r, cfg_p)
    back = lm.params_to_numpy(model)
    want, got = _leaves(jax.tree.map(np.asarray, tree)), _leaves(back)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if str(w.dtype) == "bfloat16":
            assert g.dtype == torch.bfloat16
            g = g.float().numpy()
        np.testing.assert_array_equal(g, np.asarray(w, np.float32), k)
    again = lm.params_from_numpy(back, cfg_p, "cpu")
    for (na, a), (nb, b) in zip(model.named_parameters(),
                                again.named_parameters()):
        assert na == nb and torch.equal(a, b)
