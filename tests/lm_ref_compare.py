"""Helpers shared by the port's LM tests (``test_torch_lm.py``,
``test_torch_lm_families.py``): the reference's parameters carried into
the port by ``params_from_numpy``, prefill batches made with numpy from a
seed for every family, and prefill + greedy decode run on both packages
and compared after every step.

Tolerances (``close``).  float32: within 1e-4 (rtol and atol); the two
frameworks sum in other orders.  bfloat16: within 5e-2 of the largest
magnitude of each compared tensor: bf16 keeps 8 significant bits, the two
frameworks round at other places, and a few steps of difference in every
activation carry through the layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import encdec as ref_encdec
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models import steps as ref_steps
from repro_torch.configs import get_config
from repro_torch.models import lm, moe, steps


def f32(a):
    return np.asarray(a, np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, dtype="float32", what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else f32(got)
    want = f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        err = np.abs(got - want).max()
        assert err <= 5e-2 * max(np.abs(want).max(), 1e-6), (what, err)


def flat(tree, prefix=""):
    """{dotted key: leaf} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def feed_reference_routing(monkeypatch):
    """The reference's router choices (top-k weights and indices), in call
    order, fed to the port's router in place of its own.  A bf16 rounding
    difference upstream can flip a top-k choice, a discontinuity rather
    than a fault; fed the reference's routing, the port's bf16 MoE after
    the router (dispatch, capacity, expert products, combine) compares
    within the bf16 tolerance.  Returns (the choices not yet fed, the
    count of the port's router calls)."""
    fifo, seen = [], {"calls": 0}
    ref_route, port_route = ref_moe.router_weights, moe.router_weights

    def ref_call(logits, mcfg, valid):
        out = ref_route(logits, mcfg, valid)
        jax.debug.callback(lambda w, i: fifo.append((np.asarray(w),
                                                     np.asarray(i))),
                           out[0], out[1], ordered=True)
        return out

    def port_call(logits, mcfg, valid):
        _, _, aux, z = port_route(logits, mcfg, valid)
        jax.effects_barrier()       # the reference's callbacks have run
        w, i = fifo.pop(0)
        seen["calls"] += 1
        return t(w), t(i).long(), aux, z

    monkeypatch.setattr(ref_moe, "router_weights", ref_call)
    monkeypatch.setattr(moe, "router_weights", port_call)
    return fifo, seen


def configs(name, dtype="float32", **kw):
    """The reduced config of ``name`` in both packages, with ``dtype`` and
    any other field replaced."""
    return (dataclasses.replace(ref_config(name).reduced(), dtype=dtype, **kw),
            dataclasses.replace(get_config(name).reduced(), dtype=dtype, **kw))


def params(cfg_r, cfg_p, seed=0):
    """(reference pytree, the port's model on the CPU) from one draw."""
    init = ref_encdec.init_params if cfg_r.enc_dec else ref_lm.init_params
    tree = init(jax.random.key(seed), cfg_r)
    return tree, lm.params_from_numpy(jax.tree.map(np.asarray, tree), cfg_p,
                                      device="cpu")


def batch(cfg, B, P, enc_len, seed):
    """A prefill batch in numpy: tokens, and (B, P, D) embeddings for a
    frontend config or (B, enc_len, D) encoder frames for whisper."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)}
    if cfg.frontend:
        n = enc_len if cfg.enc_dec else P
        x = (rng.normal(size=(B, n, cfg.d_model)) * 0.5).astype(np.float32)
        out["enc_embeds" if cfg.enc_dec else "embeds"] = x
    return out


def _ref_batch(b, dtype):
    return {k: jnp.asarray(v, jnp.int32) if k == "tokens"
            else jnp.asarray(v, dtype) for k, v in b.items()}


def _port_batch(b, dtype):
    return {k: t(v).long() if k == "tokens" else t(v).to(dtype)
            for k, v in b.items()}


def prefill_decode(name, dtype, n_decode, seed=0, B=2, P=24, enc_len=30,
                   monkeypatch=None, **cfg_kw):
    """Prefill then ``n_decode`` greedy steps on both packages from the
    same parameters and inputs; logits and every cache leaf compared after
    each step.

    whisper: the reference's prefill returns only the cross caches, and the
    port's also the prompt's self-attention cache.  The reference's is
    built by teacher-forcing the prompt through its ``decode_one`` (the
    reference launcher's path) and compared with the port's before
    decoding on.

    An MoE config in bf16 runs the port on the reference's routing
    (``feed_reference_routing``, through ``monkeypatch``), and every
    routing the reference made must have been fed, one per layer and
    step."""
    cfg_r, cfg_p = configs(name, dtype, **cfg_kw)
    fed = cfg_p.moe is not None and dtype == "bfloat16"
    if fed:
        fifo, seen = feed_reference_routing(monkeypatch)
    tree, model = params(cfg_r, cfg_p, seed)
    b = batch(cfg_r, B, P, enc_len, seed + 1)
    rl, rc = jax.jit(ref_steps.make_prefill_step(
        cfg_r, q_chunk=16, extra_len=n_decode))(tree, _ref_batch(b, dtype))
    pl, pc = steps.make_prefill_step(cfg_p, q_chunk=16, extra_len=n_decode)(
        model, _port_batch(b, getattr(torch, dtype)))
    assert pl.dtype == getattr(torch, dtype)
    close(pl, rl, dtype, "prefill logits")
    ref_dec = jax.jit(ref_steps.make_decode_step(cfg_r))
    if cfg_r.enc_dec:
        for k in ("cross_k", "cross_v"):
            close(pc[k], rc[k], dtype, f"prefill {k}")
        full = ref_encdec.init_cache(cfg_r, B, P + n_decode, enc_len)
        full["cross_k"], full["cross_v"] = rc["cross_k"], rc["cross_v"]
        for i in range(P):
            _, full = ref_dec(tree, full, jnp.asarray(b["tokens"][:, i:i + 1]),
                              jnp.int32(i))
        rc = full
    want, got = flat(rc), flat(pc)
    assert sorted(got) == sorted(want)
    for k in got:
        close(got[k], want[k], dtype, f"prefill cache {k}")
    for i in range(n_decode):
        nxt = np.asarray(jnp.argmax(rl, -1))[:, None]
        rl, rc = ref_dec(tree, rc, jnp.asarray(nxt, jnp.int32),
                         jnp.int32(P + i))
        pl, pc = steps.make_decode_step(cfg_p)(model, pc, t(nxt).long(),
                                               P + i)
        close(pl, rl, dtype, f"decode {i} logits")
        want = flat(rc)
        for k, a in flat(pc).items():
            close(a, want[k], dtype, f"decode {i} cache {k}")
    if fed:
        assert not fifo and seen["calls"] == cfg_p.n_layers * (1 + n_decode)
