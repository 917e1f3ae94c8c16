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
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import rwkv6 as ref_rwkv  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, encdec, layers, lm, rwkv6  # noqa: E402
from lm_ref_compare import (close, configs, f32, flat,  # noqa: E402
                            prefill_decode, t)

SERVED = tuple(list_configs())


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
    close(layers.rmsnorm(t(x), t(scale)), ref_layers.rmsnorm(x, scale))
    close(layers.layernorm(t(x), t(scale), t(b)),
           ref_layers.layernorm(x, scale, b))
    q = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5)[None, :] + 7
    close(layers.apply_rope(t(q), t(pos), 10000.0),
           ref_layers.apply_rope(q, pos, 10000.0))
    ref_p = ref_layers.init_mlp(jax.random.key(1), 16, 32, act, jnp.float32,
                                bias=bias)
    ref_p = {k: v + 0.1 if k.startswith("b_") else v
             for k, v in ref_p.items()}
    port_p = layers.MLP(16, 32, act, torch.float32, bias=bias)
    with torch.no_grad():
        for k, v in ref_p.items():
            getattr(port_p, k).copy_(t(f32(v)))
    close(layers.mlp(t(x), port_p, act), ref_layers.mlp(x, ref_p, act),
           what=act)


def test_normal_draws_large_tensors_in_slices(monkeypatch):
    """Above ``DRAW_CHUNK`` elements a parameter is drawn slice by slice
    along its first axis (kimi-k2's experts would need 2 x 21 GiB of
    float32 beside the model otherwise): the numbers are the generator's
    successive draws of each slice, scaled, and a small tensor is one
    draw, as before."""
    monkeypatch.setattr(layers, "DRAW_CHUNK", 12)
    big = torch.empty(7, 5)
    layers.normal_(big, torch.Generator().manual_seed(3), 0.5)
    g = torch.Generator().manual_seed(3)
    want = torch.cat([torch.randn((2, 5), generator=g) for _ in range(3)]
                     + [torch.randn((1, 5), generator=g)]) * 0.5
    assert torch.equal(big, want)
    small = torch.empty(2, 5)
    layers.normal_(small, torch.Generator().manual_seed(3), 0.5)
    assert torch.equal(small, torch.randn(
        (2, 5), generator=torch.Generator().manual_seed(3)) * 0.5)


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
    got = attention.attend(t(q), t(k), t(v), probs_dtype=getattr(
        torch, probs), **kw)
    want = ref_attn.attend(q, k, v, probs_dtype=jnp.dtype(probs), **kw)
    close(got, want, probs)


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
    ref_p = {k: f32(v) + (0.1 * rng.normal(size=v.shape).astype(np.float32)
                           if not k.startswith("w") else 0)
             for k, v in ref_p.items()}
    port_p = attention.Attention(cfg_p.d_model, cfg_p.n_heads,
                                 cfg_p.n_kv_heads, cfg_p.head_dim,
                                 torch.float32, qkv_bias=True, qk_norm=True)
    with torch.no_grad():
        for k, v in ref_p.items():
            getattr(port_p, k).copy_(t(v))
    S, T = 10, window or 16
    x = rng.normal(size=(2, S, cfg_r.d_model)).astype(np.float32)
    got, (pk, pv) = attention.attention_block(t(x), port_p, cfg_p,
                                              window=window, q_chunk=4)
    want, (rk, rv) = ref_attn.attention_block(x, ref_p, cfg_r, window=window,
                                              q_chunk=4)
    close(got, want)
    close(pk, rk)
    shape = (2, T, cfg_r.n_kv_heads, cfg_r.head_dim)
    rc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    pc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for pos in range(T + 3 if window else 6):
        xt = rng.normal(size=(2, 1, cfg_r.d_model)).astype(np.float32)
        want, rc = ref_attn.attention_decode_block(xt, ref_p, cfg_r, rc, pos,
                                                   window=window)
        got, pc = attention.attention_decode_block(t(xt), port_p, cfg_p, pc,
                                                   pos, window=window)
        close(got, want, what=f"pos {pos}")
        close(pc["v"], rc["v"])


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _rwkv_params(seed, D):
    ref_tm = ref_rwkv.init_time_mix(jax.random.key(seed), D, jnp.float32)
    ref_cm = ref_rwkv.init_channel_mix(jax.random.key(seed + 1), D, 2 * D,
                                       jnp.float32)
    rng = np.random.default_rng(seed)
    # move the zero-initialised mixes and norms off zero so they count
    ref_tm = {k: f32(v) + (0.1 * rng.normal(size=v.shape).astype(np.float32)
                            if k in ("mu_x", "ln_x_scale", "ln_x_bias")
                            else 0) for k, v in ref_tm.items()}
    ref_cm = {k: f32(v) + (0.1 * rng.normal(size=v.shape).astype(np.float32)
                            if k.startswith("mu") else 0)
              for k, v in ref_cm.items()}
    tm, cm = rwkv6.TimeMix(D, torch.float32), rwkv6.ChannelMix(D, 2 * D,
                                                               torch.float32)
    with torch.no_grad():
        for mod, tree in ((tm, ref_tm), (cm, ref_cm)):
            for k, v in tree.items():
                getattr(mod, k).copy_(t(v))
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
    got, (pxl, ps) = rwkv6.time_mix(t(x), tm, N, t(xp), t(s0))
    close(got, want)
    close(pxl, rxl)
    close(ps, rs)
    want, rxl = ref_rwkv.channel_mix(x, ref_cm, xp)
    got, pxl = rwkv6.channel_mix(t(x), cm, t(xp))
    close(got, want)
    for _ in range(3):
        xt = rng.normal(size=(B, D)).astype(np.float32)
        want, (rxl, rs) = ref_rwkv.time_mix_step(xt, ref_tm, N, rxl, rs)
        got, (pxl, ps) = rwkv6.time_mix_step(t(xt), tm, N, pxl, ps)
        close(got, want)
        close(ps, rs)
        want, _ = ref_rwkv.channel_mix_step(xt, ref_cm, rxl)
        got, _ = rwkv6.channel_mix_step(t(xt), cm, pxl)
        close(got, want)


# ---------------------------------------------------------------------------
# lm + steps: prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in SERVED for dtype in ("float32", "bfloat16")])
def test_prefill_decode_match_reference(name, dtype, monkeypatch):
    """Prefill logits and cache, then 4 greedy decode steps (logits and
    cache after each), at ``.reduced()`` widths, for every registered
    config (``lm_ref_compare.prefill_decode``; MoE configs in bf16 on the
    reference's routing)."""
    prefill_decode(name, dtype, 4, monkeypatch=monkeypatch)


@pytest.mark.parametrize("name", ["llama3.2-3b", "rwkv6-7b"])
def test_forward_matches_reference(name):
    cfg_r, cfg_p = configs(name, "float32")
    params = ref_lm.init_params(jax.random.key(4), cfg_r)
    model = lm.params_from_numpy(jax.tree.map(np.asarray, params), cfg_p,
                                 device="cpu")
    x = np.random.default_rng(5).normal(
        size=(2, 20, cfg_r.d_model)).astype(np.float32)
    want, _ = ref_lm.forward(params, cfg_r, x, q_chunk=8)
    got, aux = lm.forward(model, cfg_p, t(x), q_chunk=8)
    close(got, want)
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
    cfg_r, cfg_p = configs("llama3.2-3b", "float32")
    tree = jax.tree.map(np.asarray, ref_lm.init_params(jax.random.key(0),
                                                       cfg_r))
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        lm.params_from_numpy(bad, cfg_p, device="cpu")
    with pytest.raises(ValueError, match="embed"):
        lm.params_from_numpy(dict(tree, embed=tree["embed"][:, :4]), cfg_p,
                             device="cpu")


@pytest.mark.parametrize("name", SERVED)
def test_init_cache_matches_reference_shapes(name):
    """Every leaf of the decode cache, nested for the hybrid (ring buffers
    of min(window, max_len) slots) and whisper (self and cross caches)."""
    cfg_r, cfg_p = ref_config(name).reduced(), get_config(name).reduced()
    if cfg_r.enc_dec:
        want = ref_encdec.init_cache(cfg_r, 3, 40, 11)
        got = encdec.init_cache(cfg_p, 3, 40, 11, device="cpu")
    else:
        want = ref_lm.init_cache(cfg_r, 3, 40)
        got = lm.init_cache(cfg_p, 3, 40, device="cpu")
    want, got = flat(want), flat(got)
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)


@pytest.mark.parametrize("arch", SERVED)
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    tok = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--tokens", "3"])
    assert tuple(tok.shape) == (2, 1)
    assert "tok/s" in capsys.readouterr().out
