"""Decoder-only LM assembly (PyTorch port of ``repro.models.lm``) for the
two block families this slice serves:

  * ``attn`` — GQA transformer with a dense MLP, uniform layers
    (llama3.2-3b, stablelm-3b, qwen2.5-3b, qwen3-32b);
  * ``rwkv`` — RWKV6 time-mix/channel-mix, uniform layers (rwkv6-7b).

The parameters are one ``LM`` module whose names follow the reference
pytree (``embed``, ``unembed``, ``final_norm.scale``, ``ln0``, and per layer
``blocks.<i>.ln1``, ``.attn.wq``, ``.mlp.w_up``, ``.tm.w_r``, ...); the
reference's layer-stacked leaves with a leading ``L`` dimension become an
``nn.ModuleList`` and its ``lax.scan`` over them a Python loop.
``forward`` (prefill trunk) and ``decode_one`` share the parameters.

Prefill attention runs the K4 kernel on the card and RWKV's WKV scan the K5
kernel; decode is plain PyTorch, as in the reference.  Hybrid patterns,
MoE, modality frontends and encoder-decoder configs raise
``NotImplementedError``: they come with later slices of the port
(ROADMAP.md).  The decode caches are updated in place.

TF32 is off for float32 products and convolutions on the card (set here,
for the whole process), so float32 logits match the CPU within float32
rounding.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import rwkv6
from repro_torch.models.attention import (Attention, attention_block,
                                          attention_decode_block)
from repro_torch.models.layers import (MLP, Norm, apply_norm, embed_init_,
                                       mlp, param)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_LATER = ("the rest of the LLM substrate in ROADMAP.md")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config this slice does not
    serve, naming the slice of the port that brings it."""
    missing = [what for what, on in (
        ("hybrid layer patterns with windowed attention", bool(cfg.pattern)),
        ("mixture-of-experts layers", cfg.moe is not None),
        (f"the {cfg.frontend} frontend", bool(cfg.frontend)),
        ("encoder-decoder models", cfg.enc_dec)) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} are not ported yet; they "
            f"come with {_LATER}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class AttnLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, dtype, qkv_bias=cfg.qkv_bias,
                              qk_norm=cfg.qk_norm, bias=cfg.bias,
                              device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, bias=cfg.bias,
                       device=device)


class RWKVLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.tm = rwkv6.TimeMix(cfg.d_model, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.cm = rwkv6.ChannelMix(cfg.d_model, cfg.d_ff, dtype, device)


class LM(nn.Module):
    """The parameters of one decoder-only LM, allocated but not drawn
    (``init_params`` draws them, ``params_from_numpy`` loads them)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        check_supported(cfg)
        dtype = getattr(torch, cfg.dtype)
        self.embed = param((cfg.vocab, cfg.d_model), dtype, device)
        self.unembed = param((cfg.d_model, cfg.vocab), dtype, device)
        self.final_norm = Norm(cfg.d_model, cfg.norm, device)
        layer = RWKVLayer if cfg.block == "rwkv" else AttnLayer
        self.blocks = nn.ModuleList(layer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        if cfg.block == "rwkv":
            self.ln0 = Norm(cfg.d_model, cfg.norm, device)


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> LM:
    """Random parameters as the reference's initializers draw them
    (normal 0.02 embeddings, 1/sqrt(fan_in) weights, zero norms, RWKV's
    constant decays), from ``generator``, on ``device``.  The generator may
    live on the CPU or on the card (a CUDA generator draws full-width
    weights in place, without a trip through host memory).  Not the numbers
    of ``jax.random``: load the reference's with ``params_from_numpy`` to
    compare the two."""
    model = LM(cfg, resolve_device(device))
    embed_init_(model.embed, generator)
    embed_init_(model.unembed, generator)
    for mod in model.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(generator)
    return model


@torch.no_grad()
def params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> LM:
    """The reference's ``lm.init_params`` pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``) as the port's ``LM`` on
    ``device``: each layer-stacked leaf is split along its leading ``L``
    dimension into ``blocks.<i>``.  Every leaf must match one parameter by
    name, shape and dtype, and every parameter must get one."""
    model = LM(cfg, resolve_device(device))
    state = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        a = np.asarray(node)
        if path[0] == "blocks":
            for i in range(cfg.n_layers):
                state[".".join(("blocks", str(i)) + path[1:])] = a[i]
        else:
            state[".".join(path)] = a

    walk(tree, ())
    params = dict(model.named_parameters())
    if set(state) != set(params):
        raise ValueError(f"parameter names differ from the reference's: "
                         f"only in the tree {sorted(set(state) - set(params))}"
                         f", only in the port {sorted(set(params) - set(state))}")
    for name, a in state.items():
        p = params[name]
        if tuple(a.shape) != tuple(p.shape) or \
                str(a.dtype) != str(p.dtype).removeprefix("torch."):
            raise ValueError(f"{name}: reference {a.shape} {a.dtype}, port "
                             f"{tuple(p.shape)} {p.dtype}")
        # bfloat16 (ml_dtypes) goes through float32, exact both ways
        p.copy_(torch.from_numpy(np.array(a, np.float32)))
    return model


# ---------------------------------------------------------------------------
# Layer applications
# ---------------------------------------------------------------------------

def _attn_layer_fwd(x, lp: AttnLayer, cfg: ModelConfig, q_chunk: int):
    """One transformer layer over (B, S, D); returns (x', (k, v))."""
    h = apply_norm(x, lp.ln1, cfg.norm)
    h, kv = attention_block(h, lp.attn, cfg, window=cfg.window,
                            q_chunk=q_chunk)
    x = x + h
    h = apply_norm(x, lp.ln2, cfg.norm)
    return x + mlp(h, lp.mlp, cfg.act), kv


def _rwkv_layer_fwd(x, lp: RWKVLayer, cfg: ModelConfig):
    """One RWKV6 layer over (B, S, D) from zero state; returns
    (x', {"tm_x", "wkv", "cm_x"}) with the states after the last token."""
    B, _, D = x.shape
    N = cfg.rwkv_head_size
    z = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    s0 = torch.zeros((B, D // N, N, N), dtype=torch.float32, device=x.device)
    h = apply_norm(x, lp.ln1, cfg.norm)
    h, (tmx, wkv) = rwkv6.time_mix(h, lp.tm, N, z, s0)
    x = x + h
    h = apply_norm(x, lp.ln2, cfg.norm)
    h, cmx = rwkv6.channel_mix(h, lp.cm, z)
    return x + h, {"tm_x": tmx, "wkv": wkv, "cm_x": cmx}


# ---------------------------------------------------------------------------
# Forward (prefill trunk)
# ---------------------------------------------------------------------------

def forward(params: LM, cfg: ModelConfig, x, q_chunk: int = 512):
    """x: (B, S, D) embeddings -> (hidden (B,S,D), aux_loss), aux_loss 0
    (no MoE)."""
    if cfg.block == "rwkv":
        x = apply_norm(x, params.ln0, cfg.norm)
    for lp in params.blocks:
        if cfg.block == "rwkv":
            x, _ = _rwkv_layer_fwd(x, lp, cfg)
        else:
            x, _ = _attn_layer_fwd(x, lp, cfg, q_chunk)
    x = apply_norm(x, params.final_norm, cfg.norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params: LM, cfg: ModelConfig, tokens):
    return params.embed[tokens]


def logits_fn(params: LM, cfg: ModelConfig, hidden):
    return hidden @ params.unembed


# ---------------------------------------------------------------------------
# Decode caches, prefill and decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Decode-time state of one model, zeros: attention caches
    ``{"k", "v"}`` of (L, B, max_len, K, hd), or RWKV states
    ``{"tm_x", "wkv", "cm_x"}``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    L = cfg.n_layers
    if cfg.block == "rwkv":
        N = cfg.rwkv_head_size
        return {
            "tm_x": torch.zeros((L, batch, cfg.d_model), dtype=dtype,
                                device=dev),
            "wkv": torch.zeros((L, batch, cfg.d_model // N, N, N),
                               dtype=torch.float32, device=dev),
            "cm_x": torch.zeros((L, batch, cfg.d_model), dtype=dtype,
                                device=dev),
        }
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def prefill(params: LM, cfg: ModelConfig, x, extra_len: int = 0,
            q_chunk: int = 512):
    """Run the trunk over a prompt and build the decode cache.

    x: (B, S, D) embeddings.  Returns (hidden (B,S,D), cache) where
    attention caches have length S + extra_len (room for decode)."""
    if cfg.block == "rwkv":
        return _prefill_rwkv(params, cfg, x)
    B, S, _ = x.shape
    cache = init_cache(cfg, B, S + extra_len, x.device)
    for i, lp in enumerate(params.blocks):
        x, (k, v) = _attn_layer_fwd(x, lp, cfg, q_chunk)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return apply_norm(x, params.final_norm, cfg.norm), cache


def _prefill_rwkv(params: LM, cfg: ModelConfig, x):
    x = apply_norm(x, params.ln0, cfg.norm)
    states = []
    for lp in params.blocks:
        x, st = _rwkv_layer_fwd(x, lp, cfg)
        states.append(st)
    cache = {k: torch.stack([st[k] for st in states])
             for k in ("tm_x", "wkv", "cm_x")}
    return apply_norm(x, params.final_norm, cfg.norm), cache


def _attn_layer_decode(x, lp: AttnLayer, cfg, cache, pos, window):
    h = apply_norm(x, lp.ln1, cfg.norm)
    h, cache = attention_decode_block(h, lp.attn, cfg, cache, pos,
                                      window=window)
    x = x + h
    h = apply_norm(x, lp.ln2, cfg.norm)
    return x + mlp(h, lp.mlp, cfg.act), cache


def decode_one(params: LM, cfg: ModelConfig, x, cache, pos: int):
    """x: (B, 1, D) current-token embedding; returns (hidden (B,1,D),
    cache), the cache updated in place."""
    if cfg.block == "rwkv":
        return _decode_rwkv(params, cfg, x, cache)
    for i, lp in enumerate(params.blocks):
        c_l = {"k": cache["k"][i], "v": cache["v"][i]}     # views: in place
        x, _ = _attn_layer_decode(x, lp, cfg, c_l, pos, cfg.window)
    return apply_norm(x, params.final_norm, cfg.norm), cache


def _decode_rwkv(params: LM, cfg: ModelConfig, x, state):
    h = apply_norm(x[:, 0, :], params.ln0, cfg.norm)
    for i, lp in enumerate(params.blocks):
        hn = apply_norm(h, lp.ln1, cfg.norm)
        y, (tmx, wkv) = rwkv6.time_mix_step(hn, lp.tm, cfg.rwkv_head_size,
                                            state["tm_x"][i], state["wkv"][i])
        h = h + y
        hn = apply_norm(h, lp.ln2, cfg.norm)
        y, cmx = rwkv6.channel_mix_step(hn, lp.cm, state["cm_x"][i])
        h = h + y
        state["tm_x"][i] = tmx
        state["wkv"][i] = wkv
        state["cm_x"][i] = cmx
    return apply_norm(h, params.final_norm, cfg.norm)[:, None, :], state
