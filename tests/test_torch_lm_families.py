"""The port's MoE, RG-LRU hybrid, vision-frontend and encoder-decoder LM
families against the reference package on the CPU: the MoE router and
both dispatch paths, the RG-LRU blocks, K4's plain version with a window
and non-causal at S != T, the whisper encoder and decoder, prefill plus 8
decode steps and the forward of every family, decode against the
teacher-forced forward, and the serving example for every arch (the
launcher's are in ``tests/test_torch_lm.py``).
Inputs are made with numpy from a seed; parameters are the reference's,
carried over by ``params_from_numpy`` (or copied by name).

Tolerances, as ``tests/test_torch_lm.py``: float32 within 1e-4 (rtol and
atol), bfloat16 within 5e-2 of the largest magnitude
(``lm_ref_compare.close``).  The router's top-k indices must be equal.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lm_ref_compare import (close, configs, flat, params,  # noqa: E402
                            prefill_decode, t)
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import frontends as ref_frontends  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro_torch.configs import list_configs  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    flash_attention  # noqa: E402
from repro_torch.models import encdec, frontends, lm, moe, rglru  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "recurrentgemma-2b",
            "phi-3-vision-4.2b", "whisper-small")
D = 32


def _load(module, tree):
    """Copy a reference pytree into ``module``'s parameters by dotted
    name; every name must match."""
    want = {k: np.asarray(v, np.float32) for k, v in flat(tree).items()}
    got = dict(module.named_parameters())
    assert sorted(want) == sorted(got)
    with torch.no_grad():
        for k, a in want.items():
            got[k].copy_(t(a))
    return module


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,e,valid,k", [
    ((2, 12), 8, 8, 2), ((1, 16), 8, 6, 2), ((4, 1), 64, 60, 4),
    ((1, 30), 384, 384, 8)])
def test_router_weights_match_reference(shape, e, valid, k):
    """top-k indices equal; weights, aux and z losses within 1e-4."""
    logits = np.random.default_rng(e + k).normal(
        size=shape + (e,)).astype(np.float32) * 2
    mcfg = moe.MoEConfig(n_experts=valid, top_k=k, d_expert=8,
                         n_experts_padded=e)
    rcfg = ref_moe.MoEConfig(n_experts=valid, top_k=k, d_expert=8,
                             n_experts_padded=e)
    pw, pi, pa, pz = moe.router_weights(t(logits), mcfg, valid)
    rw, ri, ra, rz = ref_moe.router_weights(logits, rcfg, valid)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    assert int(pi.max()) < valid
    close(pw, rw)
    close(pa, ra)
    close(pz, rz)


def _moe_pair(mcfg_kw, seed, act="swiglu", bias_expert0=0.0):
    rcfg = ref_moe.MoEConfig(**mcfg_kw)
    tree = ref_moe.init_moe(jax.random.key(seed), D, rcfg, jnp.float32, act)
    if bias_expert0:
        tree = dict(tree, router=tree["router"].at[:, 0].add(bias_expert0))
    port = _load(moe.MoE(D, moe.MoEConfig(**mcfg_kw), torch.float32, act),
                 tree)
    return rcfg, tree, moe.MoEConfig(**mcfg_kw), port


BASE = dict(n_experts=8, top_k=2, d_expert=16, n_shared=1,
            capacity_factor=16.0, group_size=4)


@pytest.mark.parametrize("case", ["loose", "tight", "padded", "decode",
                                  "ragged_group", "geglu", "gelu"])
def test_gshard_moe_matches_reference(case):
    """The GShard path (after ``tests/test_moe.py``): routing biased to
    expert 0 so a tight capacity drops assignments, padded experts never
    routed to, decode (S = 1, one group per token), a group size that does
    not divide S (one group per sequence), and the other activations."""
    kw, S, act, bias = dict(BASE), 12, "swiglu", 0.0
    if case in ("loose", "tight"):
        bias, kw["group_size"] = 100.0, 12
        if case == "tight":
            kw["capacity_factor"] = 0.25
    elif case == "padded":
        kw.update(n_experts=6, n_experts_padded=8, capacity_factor=8.0)
    elif case == "decode":
        S = 1
    elif case == "ragged_group":
        kw["group_size"] = 5
    else:
        act = case
    rcfg, tree, pcfg, port = _moe_pair(kw, 3, act, bias)
    x = np.random.default_rng(4).normal(size=(2, S, D)).astype(np.float32)
    ry, rl = ref_moe.moe_block(x, tree, rcfg, act)
    py, pl = moe.moe_block(t(x), port, pcfg, act)
    close(py, ry, what=case)
    for k in ("moe_aux", "moe_z"):
        close(pl[k], rl[k], what=k)
    if case == "tight":       # the drop shows: the loose capacity differs
        loose = dataclasses.replace(pcfg, capacity_factor=16.0)
        assert float((moe.moe_block(t(x), port, loose, act)[0]
                      - py).abs().max()) > 1e-4
    if case == "padded":
        _, topi, _, _ = moe.router_weights(t(x).reshape(-1, D) @ port.router,
                                           pcfg, pcfg.n_experts)
        assert int(topi.max()) < 6


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_dropless_matches_gshard_and_reference(act):
    """At one device the dropless path keeps every assignment: equal to
    GShard at a capacity that drops nothing, and to the reference's
    dropless path."""
    kw = dict(BASE, impl="dropless")
    rcfg, tree, pcfg, port = _moe_pair(kw, 5, act)
    x = np.random.default_rng(6).normal(size=(2, 12, D)).astype(np.float32)
    py, pl = moe.moe_block(t(x), port, pcfg, act)
    ry, rl = ref_moe.moe_block(x, tree, rcfg, act)
    close(py, ry)
    close(pl["moe_aux"], rl["moe_aux"])
    gy, gl = moe.moe_block(t(x), port, dataclasses.replace(pcfg,
                                                           impl="gshard"),
                           act)
    np.testing.assert_allclose(py.numpy(), gy.numpy(), rtol=1e-5, atol=1e-5)
    assert float(pl["moe_aux"]) == pytest.approx(float(gl["moe_aux"]),
                                                 rel=1e-5)


@pytest.mark.parametrize("case", ["loose", "tight", "decode", "dropless"])
def test_moe_block_bf16_matches_reference(case):
    """bf16 parameters and activations: the routing (float32 router on
    the same bf16 x) must agree, top-k indices equal, and then y is held
    to the bf16 tolerance, which checks the bf16 choices after the router:
    ``dispatch`` in x's dtype, ``combine`` float32 until the last einsum,
    the expert products in bf16, and the dropless path's."""
    kw, S = dict(BASE), 12
    if case in ("loose", "tight"):      # biased to expert 0, as above
        kw["group_size"] = 12
        if case == "tight":
            kw["capacity_factor"] = 0.25
    elif case == "decode":
        S = 1
    else:
        kw["impl"] = "dropless"
    rcfg = ref_moe.MoEConfig(**kw)
    tree = ref_moe.init_moe(jax.random.key(7), D, rcfg, jnp.bfloat16,
                            "swiglu")
    if case in ("loose", "tight"):
        tree = dict(tree, router=tree["router"].at[:, 0].add(100.0))
    pcfg = moe.MoEConfig(**kw)
    port = moe.MoE(D, pcfg, torch.bfloat16, "swiglu")
    want = {k: np.asarray(v.astype(jnp.float32))
            for k, v in flat(tree).items()}
    with torch.no_grad():
        for k, p in port.named_parameters():
            p.copy_(t(want[k]).to(p.dtype))
    x = np.random.default_rng(8).normal(size=(2, S, D)).astype(np.float32)
    xr, xp = jnp.asarray(x, jnp.bfloat16), t(x).to(torch.bfloat16)
    _, ri, _, _ = ref_moe.router_weights(
        xr.astype(jnp.float32) @ tree["router"], rcfg, rcfg.n_experts)
    _, pi, _, _ = moe.router_weights(xp.float() @ port.router, pcfg,
                                     pcfg.n_experts)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    ry, rl = ref_moe.moe_block(xr, tree, rcfg, "swiglu")
    py, pl = moe.moe_block(xp, port, pcfg, "swiglu")
    assert py.dtype == torch.bfloat16
    close(py, ry, "bfloat16", case)
    for k in ("moe_aux", "moe_z"):
        close(pl[k], rl[k], what=k)
    if case == "tight":       # the drop shows: the loose capacity differs
        loose = dataclasses.replace(pcfg, capacity_factor=16.0)
        assert float((moe.moe_block(xp, port, loose)[0].float()
                      - py.float()).abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 17, 64])
def test_rglru_blocks_match_reference(T):
    """``rglru`` (the log-depth scan against the reference's
    associative_scan) and ``recurrent_block`` from a nonzero state, then 3
    ``recurrent_block_step``s, with the float32 biases and decay moved off
    their initial values."""
    B, Dr = 2, 24
    tree = ref_rglru.init_recurrent_block(jax.random.key(T), D, Dr,
                                          jnp.float32)
    rng = np.random.default_rng(T)
    tree = {k: np.asarray(v, np.float32) + (
        0.3 * rng.normal(size=v.shape).astype(np.float32)
        if k in ("conv_b", "b_a", "b_x", "lambda_p") else 0)
        for k, v in tree.items()}
    port = _load(rglru.RecurrentBlock(D, Dr, torch.float32), tree)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    h0 = rng.normal(size=(B, Dr)).astype(np.float32)
    conv = rng.normal(size=(B, rglru.CONV_W - 1, Dr)).astype(np.float32)
    xr = rng.normal(size=(B, T, Dr)).astype(np.float32)
    got, glast = rglru.rglru(t(xr), port, t(h0))
    want, wlast = ref_rglru.rglru(xr, tree, h0)
    close(got, want)
    close(glast, wlast)
    st = {"h": h0, "conv": conv}
    want, rs = ref_rglru.recurrent_block(x, tree, st)
    got, ps = rglru.recurrent_block(t(x), port, {k: t(v)
                                                 for k, v in st.items()})
    close(got, want)
    for k in ("h", "conv"):
        close(ps[k], rs[k], what=k)
    for i in range(3):
        xt = rng.normal(size=(B, D)).astype(np.float32)
        want, rs = ref_rglru.recurrent_block_step(xt, tree, rs)
        got, ps = rglru.recurrent_block_step(t(xt), port, ps)
        close(got, want, what=f"step {i}")
        close(ps["h"], rs["h"])
        close(ps["conv"], rs["conv"])


def test_linear_scan_is_the_recurrence():
    """The log-depth scan against the sequential loop it stands for."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 37, 5)).astype(np.float32))
    h, want = torch.zeros(2, 5), []
    for i in range(37):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    close(rglru.linear_scan(a, b), torch.stack(want, 1).numpy())


# ---------------------------------------------------------------------------
# K4's plain version: window, non-causal S != T
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,q_offset,S,T", [
    (True, 8, 0, 24, 24), (True, 5, 0, 40, 40), (True, 8, 6, 18, 24),
    (False, 6, 0, 24, 24), (False, 0, 0, 24, 37), (False, 0, 0, 9, 50)])
def test_flash_attention_plain_window_and_cross(causal, window, q_offset, S,
                                                T):
    """``flash_attention`` on CPU tensors (K4's plain version) against the
    reference's chunked ``attend``: the local-attention window on top of
    the causal mask, and the encoder's / cross-attention's non-causal
    ragged S != T, GQA groups of 3."""
    rng = np.random.default_rng(S + T + window)
    q = rng.normal(size=(2, S, 6, 8)).astype(np.float32)
    k = rng.normal(size=(2, T, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, T, 2, 8)).astype(np.float32)
    got = flash_attention(t(q), t(k), t(v), causal, q_offset, window)
    want = ref_attn.attend(q, k, v, causal=causal, window=window,
                           q_chunk=16, q_offset=q_offset)
    close(got.reshape(2, S, -1), want)


def test_flash_attention_plain_row_without_keys_is_zero():
    """A query that sees no key (past the keys under a window) gets zeros,
    as the kernel gives, and the wrapper refuses a negative window."""
    q = torch.randn(1, 4, 2, 8)
    k = torch.randn(1, 3, 2, 8)
    out = flash_attention(q, k, k, True, 4, 2)
    assert bool((out == 0).all())
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, k, True, 0, -1)


# ---------------------------------------------------------------------------
# Encoder-decoder and frontends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_matches_reference(dtype):
    """``encode`` (frames 30), ``decode_train`` (prompt 12), the forward,
    the cross cache, then ``decode_one`` for 6 tokens from the reference's
    cache layout (self-attention zeros, cross from the encoder)."""
    cfg_r, cfg_p = configs("whisper-small", dtype)
    tree, model = params(cfg_r, cfg_p, 3)
    rng = np.random.default_rng(4)
    frames = (rng.normal(size=(2, 30, cfg_r.d_model)) * 0.5).astype(
        np.float32)
    toks = rng.integers(0, cfg_r.vocab, (2, 12))
    jd, pd = jnp.dtype(dtype), getattr(torch, dtype)
    enc_r = ref_encdec.encode(tree, cfg_r, jnp.asarray(frames, jd))
    enc_p = encdec.encode(model, cfg_p, t(frames).to(pd))
    close(enc_p, enc_r, dtype, "encode")
    emb_r = ref_lm.embed_tokens(tree, cfg_r, jnp.asarray(toks))
    emb_p = lm.embed_tokens(model, cfg_p, t(toks))
    close(encdec.decode_train(model, cfg_p, emb_p, enc_p),
          ref_encdec.decode_train(tree, cfg_r, emb_r, enc_r), dtype,
          "decode_train")
    hp, ap = encdec.forward(model, cfg_p, t(frames).to(pd), emb_p)
    hr, ar = ref_encdec.forward(tree, cfg_r, jnp.asarray(frames, jd), emb_r)
    close(hp, hr, dtype, "forward")
    assert float(ap) == float(ar) == 0.0
    ck_r, cv_r = ref_encdec.build_cross_cache(tree, cfg_r, enc_r)
    ck_p, cv_p = encdec.build_cross_cache(model, cfg_p, enc_p)
    close(ck_p, ck_r, dtype, "cross_k")
    close(cv_p, cv_r, dtype, "cross_v")
    rc = ref_encdec.init_cache(cfg_r, 2, 8, 30)
    rc["cross_k"], rc["cross_v"] = ck_r, cv_r
    pc = encdec.init_cache(cfg_p, 2, 8, 30, device="cpu")
    pc["cross_k"], pc["cross_v"] = ck_p, cv_p
    for pos in range(6):
        x = toks[:, pos:pos + 1]
        hr, rc = ref_encdec.decode_one(
            tree, cfg_r, ref_lm.embed_tokens(tree, cfg_r, jnp.asarray(x)),
            rc, jnp.int32(pos))
        hp, pc = encdec.decode_one(model, cfg_p,
                                   lm.embed_tokens(model, cfg_p, t(x)), pc,
                                   pos)
        close(hp, hr, dtype, f"decode_one {pos}")
        close(pc["self"]["k"], rc["self"]["k"], dtype, f"self k {pos}")


def test_frontend_stub_matches_reference():
    """``embed_patches`` against the reference's stub with its projection;
    ``synthetic_patches`` draws PATCH_DIM-wide normals from the given
    generator, the same numbers for the same seed."""
    assert frontends.PATCH_DIM == ref_frontends.PATCH_DIM
    ref_p = ref_frontends.init_frontend(jax.random.key(0), D, jnp.float32)
    patches = np.random.default_rng(1).normal(
        size=(2, 5, frontends.PATCH_DIM)).astype(np.float32)
    port_p = frontends.init_frontend(torch.Generator().manual_seed(0), D,
                                     torch.float32, device="cpu")
    assert tuple(port_p["proj"].shape) == ref_p["proj"].shape
    port_p["proj"] = t(np.asarray(ref_p["proj"]))
    close(frontends.embed_patches(port_p, t(patches)),
          ref_frontends.embed_patches(ref_p, patches))
    a, b = (frontends.synthetic_patches(torch.Generator().manual_seed(3), 2,
                                        7) for _ in range(2))
    assert a.shape == (2, 7, frontends.PATCH_DIM)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The families end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in FAMILIES for dtype in ("float32", "bfloat16")])
def test_families_prefill_decode_match_reference(name, dtype, monkeypatch):
    """Prefill (prompt 24) then 8 greedy decode steps, logits and every
    cache leaf after each, at ``.reduced()`` width; recurrentgemma at
    window 8, so the band masks the prompt and the ring buffer wraps.  The
    MoE configs in bf16 run the port on the reference's routing
    (``lm_ref_compare.feed_reference_routing``)."""
    kw = {"window": 8} if name == "recurrentgemma-2b" else {}
    prefill_decode(name, dtype, 8, monkeypatch=monkeypatch, **kw)


@pytest.mark.parametrize("name", FAMILIES)
def test_families_forward_matches_reference(name):
    """The forward trunk (hidden and aux loss) in float32; the MoE configs'
    aux is the summed load-balance and z losses, nonzero."""
    kw = {"window": 8} if name == "recurrentgemma-2b" else {}
    cfg_r, cfg_p = configs(name, **kw)
    tree, model = params(cfg_r, cfg_p, 4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 20, cfg_r.d_model)).astype(np.float32)
    if cfg_r.enc_dec:
        frames = rng.normal(size=(2, 26, cfg_r.d_model)).astype(np.float32)
        want, ra = ref_encdec.forward(tree, cfg_r, frames, x)
        got, pa = encdec.forward(model, cfg_p, t(frames), t(x))
    else:
        want, ra = ref_lm.forward(tree, cfg_r, x, q_chunk=8)
        got, pa = lm.forward(model, cfg_p, t(x), q_chunk=8)
    close(got, want)
    close(pa, ra)
    assert (float(pa) > 0) == (cfg_r.moe is not None)


def _fp32(name, **kw):
    cfg = configs(name, **kw)[1]
    return cfg, lm.init_params(torch.Generator().manual_seed(1), cfg,
                               device="cpu")


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "whisper-small"])
def test_decode_matches_teacher_forced_forward(name):
    """Token-by-token decode through the port's caches reproduces its
    forward's logits (after ``tests/test_serve_consistency.py``), within
    2e-3 as there: the hybrid at window 8 over 20 tokens, so its ring
    buffer wraps twice; whisper against 20 encoder frames."""
    B, S = 2, 20
    kw = {"window": 8} if name == "recurrentgemma-2b" else {}
    cfg, model = _fp32(name, **kw)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    x = lm.embed_tokens(model, cfg, toks)
    if cfg.enc_dec:
        frames = torch.randn(B, S, cfg.d_model, generator=gen) * 0.1
        hid, _ = encdec.forward(model, cfg, frames, x)
        cache = encdec.init_cache(cfg, B, S, S, device="cpu")
        enc = encdec.encode(model, cfg, frames)
        cache["cross_k"], cache["cross_v"] = encdec.build_cross_cache(
            model, cfg, enc)
        step = encdec.decode_one
    else:
        hid, _ = lm.forward(model, cfg, x, q_chunk=8)
        cache = lm.init_cache(cfg, B, S, device="cpu")
        step = lm.decode_one
    full = lm.logits_fn(model, cfg, hid)
    outs = []
    with torch.no_grad():
        for i in range(S):
            h, cache = step(model, cfg, x[:, i:i + 1], cache, i)
            outs.append(lm.logits_fn(model, cfg, h)[:, 0])
    assert float((torch.stack(outs, 1) - full).abs().max()) < 2e-3


@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_layout_matches_reference(name):
    """init_params draws every parameter the reference tree has, by name,
    shape and dtype (the tree loads into the same module layout), with
    the reference's rules for the new leaves: float32 routers and RG-LRU
    gates, RG-LRU's lambda_p of -1, zero biases."""
    cfg_r, cfg_p = configs(name, "bfloat16")
    init = ref_encdec.init_params if cfg_r.enc_dec else ref_lm.init_params
    tree = jax.tree.map(np.asarray, init(jax.random.key(0), cfg_r))
    drawn = dict(lm.init_params(torch.Generator().manual_seed(0), cfg_p,
                                device="cpu").named_parameters())
    loaded = dict(lm.params_from_numpy(tree, cfg_p, "cpu").named_parameters())
    assert {k: (tuple(v.shape), v.dtype) for k, v in drawn.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in loaded.items()}
    for k, v in drawn.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "lambda_p":
            assert bool((v == -1.0).all()), k
        elif leaf.startswith("b") and leaf != "bias":
            assert float(v.abs().max()) == 0.0, k
        elif leaf in ("router", "w_gate", "w_up", "w_down", "wq", "w_a"):
            assert float(v.float().std()) > 0, k


def test_params_from_numpy_is_strict_for_stacked_families():
    """A hybrid tree with a repeat too many, or an MoE tree with a missing
    expert, is refused by name or shape."""
    cfg_r, cfg_p = configs("recurrentgemma-2b")
    tree = jax.tree.map(np.asarray, ref_lm.init_params(jax.random.key(0),
                                                       cfg_r))
    g = tree["blocks"]["repeat"]["p0_rec"]
    bad = jax.tree.map(lambda a: np.concatenate([a, a[:1]]), g)
    with pytest.raises(ValueError, match="p0_rec.1"):
        lm.params_from_numpy(dict(tree, blocks=dict(
            tree["blocks"], repeat=dict(tree["blocks"]["repeat"],
                                        p0_rec=bad))), cfg_p, device="cpu")
    cfg_r, cfg_p = configs("qwen2-moe-a2.7b")
    tree = jax.tree.map(np.asarray, ref_lm.init_params(jax.random.key(0),
                                                       cfg_r))
    ex = tree["blocks"]["moe"]["experts"]
    cut = dict(ex, w_up=ex["w_up"][:, :-1])
    with pytest.raises(ValueError, match="w_up"):
        lm.params_from_numpy(dict(tree, blocks=dict(
            tree["blocks"], moe=dict(tree["blocks"]["moe"], experts=cut))),
            cfg_p, device="cpu")


# ---------------------------------------------------------------------------
# Launcher and example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_configs())
def test_serve_example_runs_every_arch_on_the_cpu(arch, capsys):
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch",
        os.path.join(ROOT, "examples", "serve_decode_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    tokens = example.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "8", "--tokens", "4"])
    assert tuple(tokens.shape) == (2, 5)
    cfg = configs(arch)[1]
    assert bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "serving state size" in out
