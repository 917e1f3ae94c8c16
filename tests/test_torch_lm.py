"""The port's LM serving path (configs, layers, attention, RWKV6, lm, steps,
launcher) against the reference package on the CPU, with the reference's
parameters carried over by ``params_from_numpy`` and inputs made with numpy
from a seed.

Tolerances.  float32: logits, caches and block outputs within 1e-4 (rtol
and atol); the two frameworks sum in other orders, and K5's plain version
is the exact recurrence where the reference factors it into 16-token
chunks.  bfloat16: within 5e-2 of the largest magnitude of each compared
tensor.  bf16 keeps 8 significant bits (a relative step of 2^-8), the two
frameworks round at other places (fused or separate ops, bf16 or f32
intermediates), and a few steps of difference in every activation carry
through the layers: across seeds the logits differed by at most 1.7% and
the caches by at most 2.5% of their largest magnitude.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import list_configs as ref_list  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import rwkv6 as ref_rwkv  # noqa: E402
from repro.models import steps as ref_steps  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, layers, lm, rwkv6, steps  # noqa: E402

SERVED = ("llama3.2-3b", "stablelm-3b", "qwen2.5-3b", "rwkv6-7b")
UNSERVED = ("kimi-k2-1t-a32b", "phi-3-vision-4.2b", "qwen2-moe-a2.7b",
            "recurrentgemma-2b", "whisper-small")


def _f32(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, dtype="float32", what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else _f32(got)
    want = _f32(want)
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        err = np.abs(got - want).max()
        assert err <= 5e-2 * max(np.abs(want).max(), 1e-6), (what, err)


def _configs(name, dtype):
    return (dataclasses.replace(ref_config(name).reduced(), dtype=dtype),
            dataclasses.replace(get_config(name).reduced(), dtype=dtype))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_config_registry_matches_reference():
    assert list_configs() == ref_list()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for name in list_configs():
        for port, ref in ((get_config(name), ref_config(name)),
                          (get_config(name).reduced(),
                           ref_config(name).reduced())):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
            assert port.shape_names() == ref.shape_names()
            assert port.attention_free == ref.attention_free
            if ref.moe is not None:
                assert port.moe.e_pad == ref.moe.e_pad


@pytest.mark.parametrize("name", UNSERVED)
def test_unserved_families_raise(name):
    cfg = get_config(name).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lm.init_params(torch.Generator(), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        steps.make_prefill_step(cfg)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act,bias", [("swiglu", False), ("geglu", False),
                                      ("gelu", True)])
def test_norms_rope_mlp_match_reference(act, bias):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32) * 0.1
    b = rng.normal(size=16).astype(np.float32) * 0.1
    _close(layers.rmsnorm(_t(x), _t(scale)), ref_layers.rmsnorm(x, scale))
    _close(layers.layernorm(_t(x), _t(scale), _t(b)),
           ref_layers.layernorm(x, scale, b))
    q = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5)[None, :] + 7
    _close(layers.apply_rope(_t(q), _t(pos), 10000.0),
           ref_layers.apply_rope(q, pos, 10000.0))
    ref_p = ref_layers.init_mlp(jax.random.key(1), 16, 32, act, jnp.float32,
                                bias=bias)
    ref_p = {k: v + 0.1 if k.startswith("b_") else v
             for k, v in ref_p.items()}
    port_p = layers.MLP(16, 32, act, torch.float32, bias=bias)
    with torch.no_grad():
        for k, v in ref_p.items():
            getattr(port_p, k).copy_(_t(_f32(v)))
    _close(layers.mlp(_t(x), port_p, act), ref_layers.mlp(x, ref_p, act),
           what=act)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,q_offset,T", [
    (True, 0, 0, 24), (False, 0, 0, 31), (True, 5, 0, 24), (True, 0, 7, 31),
    (False, 6, 0, 24)])
@pytest.mark.parametrize("probs", ["float32", "bfloat16"])
def test_attend_plain_matches_reference(causal, window, q_offset, T, probs):
    """The CPU path of ``attend`` keeps the reference's chunked semantics:
    causal and window masks, query offset, probabilities dtype."""
    rng = np.random.default_rng(T + window)
    q = rng.normal(size=(2, 24, 6, 8)).astype(np.float32)
    k = rng.normal(size=(2, T, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, T, 2, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=16, q_offset=q_offset)
    got = attention.attend(_t(q), _t(k), _t(v), probs_dtype=getattr(
        torch, probs), **kw)
    want = ref_attn.attend(q, k, v, probs_dtype=jnp.dtype(probs), **kw)
    _close(got, want, probs)


@pytest.mark.parametrize("window", [0, 6])
def test_attention_blocks_match_reference(window):
    """Prefill block, then decode steps into the cache (a ring buffer when
    windowed), with QK-norm and QKV bias switched on."""
    cfg_r = dataclasses.replace(ref_config("qwen3-32b").reduced(),
                                dtype="float32", qkv_bias=True)
    cfg_p = dataclasses.replace(get_config("qwen3-32b").reduced(),
                                dtype="float32", qkv_bias=True)
    ref_p = ref_attn.init_attention(
        jax.random.key(2), cfg_r.d_model, cfg_r.n_heads, cfg_r.n_kv_heads,
        cfg_r.head_dim, jnp.float32, qkv_bias=True, qk_norm=True)
    rng = np.random.default_rng(3)
    ref_p = {k: _f32(v) + (0.1 * rng.normal(size=v.shape).astype(np.float32)
                           if not k.startswith("w") else 0)
             for k, v in ref_p.items()}
    port_p = attention.Attention(cfg_p.d_model, cfg_p.n_heads,
                                 cfg_p.n_kv_heads, cfg_p.head_dim,
                                 torch.float32, qkv_bias=True, qk_norm=True)
    with torch.no_grad():
        for k, v in ref_p.items():
            getattr(port_p, k).copy_(_t(v))
    S, T = 10, window or 16
    x = rng.normal(size=(2, S, cfg_r.d_model)).astype(np.float32)
    got, (pk, pv) = attention.attention_block(_t(x), port_p, cfg_p,
                                              window=window, q_chunk=4)
    want, (rk, rv) = ref_attn.attention_block(x, ref_p, cfg_r, window=window,
                                              q_chunk=4)
    _close(got, want)
    _close(pk, rk)
    shape = (2, T, cfg_r.n_kv_heads, cfg_r.head_dim)
    rc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    pc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for pos in range(T + 3 if window else 6):
        xt = rng.normal(size=(2, 1, cfg_r.d_model)).astype(np.float32)
        want, rc = ref_attn.attention_decode_block(xt, ref_p, cfg_r, rc, pos,
                                                   window=window)
        got, pc = attention.attention_decode_block(_t(xt), port_p, cfg_p, pc,
                                                   pos, window=window)
        _close(got, want, what=f"pos {pos}")
        _close(pc["v"], rc["v"])


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _rwkv_params(seed, D):
    ref_tm = ref_rwkv.init_time_mix(jax.random.key(seed), D, jnp.float32)
    ref_cm = ref_rwkv.init_channel_mix(jax.random.key(seed + 1), D, 2 * D,
                                       jnp.float32)
    rng = np.random.default_rng(seed)
    # move the zero-initialised mixes and norms off zero so they count
    ref_tm = {k: _f32(v) + (0.1 * rng.normal(size=v.shape).astype(np.float32)
                            if k in ("mu_x", "ln_x_scale", "ln_x_bias")
                            else 0) for k, v in ref_tm.items()}
    ref_cm = {k: _f32(v) + (0.1 * rng.normal(size=v.shape).astype(np.float32)
                            if k.startswith("mu") else 0)
              for k, v in ref_cm.items()}
    tm, cm = rwkv6.TimeMix(D, torch.float32), rwkv6.ChannelMix(D, 2 * D,
                                                               torch.float32)
    with torch.no_grad():
        for mod, tree in ((tm, ref_tm), (cm, ref_cm)):
            for k, v in tree.items():
                getattr(mod, k).copy_(_t(v))
    return (ref_tm, ref_cm), (tm, cm)


@pytest.mark.parametrize("T", [1, 17, 32])
def test_rwkv_blocks_match_reference(T):
    """time_mix (K5's plain version on the CPU; the reference's
    wkv_chunked) from a nonzero state, then decode steps."""
    B, D, N = 2, 32, 8
    (ref_tm, ref_cm), (tm, cm) = _rwkv_params(T, D)
    rng = np.random.default_rng(T)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    xp = rng.normal(size=(B, D)).astype(np.float32)
    s0 = rng.normal(size=(B, D // N, N, N)).astype(np.float32)
    want, (rxl, rs) = ref_rwkv.time_mix(x, ref_tm, N, xp, s0)
    got, (pxl, ps) = rwkv6.time_mix(_t(x), tm, N, _t(xp), _t(s0))
    _close(got, want)
    _close(pxl, rxl)
    _close(ps, rs)
    want, rxl = ref_rwkv.channel_mix(x, ref_cm, xp)
    got, pxl = rwkv6.channel_mix(_t(x), cm, _t(xp))
    _close(got, want)
    for _ in range(3):
        xt = rng.normal(size=(B, D)).astype(np.float32)
        want, (rxl, rs) = ref_rwkv.time_mix_step(xt, ref_tm, N, rxl, rs)
        got, (pxl, ps) = rwkv6.time_mix_step(_t(xt), tm, N, pxl, ps)
        _close(got, want)
        _close(ps, rs)
        want, _ = ref_rwkv.channel_mix_step(xt, ref_cm, rxl)
        got, _ = rwkv6.channel_mix_step(_t(xt), cm, pxl)
        _close(got, want)


# ---------------------------------------------------------------------------
# lm + steps: prefill and decode against the reference
# ---------------------------------------------------------------------------

def _leaves(cache):
    return {k: cache[k] for k in sorted(cache)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", SERVED)
def test_prefill_decode_match_reference(name, dtype):
    """Prefill logits and cache, then 4 greedy decode steps (logits and
    cache after each), at ``.reduced()`` widths."""
    cfg_r, cfg_p = _configs(name, dtype)
    params = ref_lm.init_params(jax.random.key(0), cfg_r)
    model = lm.params_from_numpy(jax.tree.map(np.asarray, params), cfg_p,
                                 device="cpu")
    B, P, N = 2, 24, 4
    tok = np.random.default_rng(1).integers(0, cfg_r.vocab, (B, P))
    rl, rc = jax.jit(ref_steps.make_prefill_step(cfg_r, q_chunk=16,
                                                 extra_len=N))(
        params, {"tokens": jnp.asarray(tok, jnp.int32)})
    pl, pc = steps.make_prefill_step(cfg_p, q_chunk=16, extra_len=N)(
        model, {"tokens": _t(tok)})
    assert pl.dtype == getattr(torch, dtype)
    _close(pl, rl, dtype, "prefill logits")
    assert sorted(pc) == sorted(rc)
    for k in pc:
        _close(pc[k], rc[k], dtype, f"prefill cache {k}")
    ref_dec = jax.jit(ref_steps.make_decode_step(cfg_r))
    port_dec = steps.make_decode_step(cfg_p)
    for i in range(N):
        nxt = np.asarray(jnp.argmax(rl, -1))[:, None]
        rl, rc = ref_dec(params, rc, jnp.asarray(nxt, jnp.int32),
                         jnp.int32(P + i))
        pl, pc = port_dec(model, pc, _t(nxt), P + i)
        _close(pl, rl, dtype, f"decode {i} logits")
        for k in pc:
            _close(pc[k], rc[k], dtype, f"decode {i} cache {k}")


@pytest.mark.parametrize("name", ["llama3.2-3b", "rwkv6-7b"])
def test_forward_matches_reference(name):
    cfg_r, cfg_p = _configs(name, "float32")
    params = ref_lm.init_params(jax.random.key(4), cfg_r)
    model = lm.params_from_numpy(jax.tree.map(np.asarray, params), cfg_p,
                                 device="cpu")
    x = np.random.default_rng(5).normal(
        size=(2, 20, cfg_r.d_model)).astype(np.float32)
    want, _ = ref_lm.forward(params, cfg_r, x, q_chunk=8)
    got, aux = lm.forward(model, cfg_p, _t(x), q_chunk=8)
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("name", ["llama3.2-3b", "rwkv6-7b"])
def test_init_params_layout_matches_reference(name):
    """init_params draws every parameter the reference pytree has, with its
    shape and dtype and the reference's init rule (bf16 model)."""
    cfg_r, cfg_p = ref_config(name).reduced(), get_config(name).reduced()
    tree = jax.tree.map(np.asarray, ref_lm.init_params(jax.random.key(0),
                                                       cfg_r))
    model = lm.init_params(torch.Generator().manual_seed(0), cfg_p,
                           device="cpu")
    # the reference's own leaves load into it by name, shape and dtype
    lm.params_from_numpy(tree, cfg_p, device="cpu")
    p = dict(model.named_parameters())
    assert p["embed"].dtype == torch.bfloat16
    assert abs(float(p["embed"].float().std()) - 0.02) < 0.002
    assert float(p["final_norm.scale"].abs().max()) == 0.0
    if cfg_p.block == "rwkv":
        assert bool((p["blocks.1.tm.w0"] == -6.0).all())
        assert bool((p["blocks.0.tm.u"] == 0.5).all())
        w = p["blocks.0.cm.w_out"].float()
        assert abs(float(w.std()) * cfg_p.d_ff ** 0.5 - 1.0) < 0.1
    else:
        w = p["blocks.1.attn.wo"].float()
        fan_in = cfg_p.n_heads * cfg_p.head_dim
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.1


def test_params_from_numpy_rejects_a_mismatched_tree():
    cfg_r, cfg_p = _configs("llama3.2-3b", "float32")
    tree = jax.tree.map(np.asarray, ref_lm.init_params(jax.random.key(0),
                                                       cfg_r))
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        lm.params_from_numpy(bad, cfg_p, device="cpu")
    with pytest.raises(ValueError, match="embed"):
        lm.params_from_numpy(dict(tree, embed=tree["embed"][:, :4]), cfg_p,
                             device="cpu")


@pytest.mark.parametrize("name", ["llama3.2-3b", "rwkv6-7b"])
def test_init_cache_matches_reference_shapes(name):
    cfg_r, cfg_p = ref_config(name).reduced(), get_config(name).reduced()
    want = ref_lm.init_cache(cfg_r, 3, 40)
    got = lm.init_cache(cfg_p, 3, 40, device="cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-7b"])
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    tok = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--tokens", "3"])
    assert tuple(tok.shape) == (2, 1)
    assert "tok/s" in capsys.readouterr().out
