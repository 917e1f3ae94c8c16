"""Decoder-only LM assembly (PyTorch port of ``repro.models.lm``) for every
registered family:

  * ``attn`` — GQA transformer with a dense MLP or an MoE layer, uniform
    layers (llama3.2-3b, stablelm-3b, qwen2.5-3b, qwen3-32b, the
    phi-3-vision backbone; qwen2-moe-a2.7b, kimi-k2-1t-a32b);
  * ``rwkv`` — RWKV6 time-mix/channel-mix, uniform layers (rwkv6-7b);
  * hybrid — a repeating ``pattern`` of RG-LRU (``rec``) and windowed
    attention layers plus a tail (recurrentgemma-2b).

Encoder-decoder configs (whisper-small) live in ``models/encdec.py``;
``init_params`` and ``params_from_numpy`` build either, and
``params_to_numpy`` (``param_tree``) gives either back in the reference's
pytree layout.

The parameters are one ``LM`` module whose names follow the reference
pytree (``embed``, ``unembed``, ``final_norm.scale``, ``ln0``, and per layer
``blocks.<i>.ln1``, ``.attn.wq``, ``.mlp.w_up``, ``.moe.experts.w_gate``,
``.tm.w_r``, ...; a hybrid's ``blocks.repeat.p0_rec.<i>.rec.w_in`` and
``blocks.tail.t0_rec.0.ln1.scale``).  The reference's stacked leaves with a
leading layer (or repeat) dimension become ``nn.ModuleList``s and its
``lax.scan`` over them a Python loop; inside a hybrid group the layers run
in sorted name order, as the reference's ``for name in sorted(lps)``.
``forward`` (prefill trunk) and ``decode_one`` share the parameters.

Prefill attention runs the K4 kernel on the card (windowed on the hybrid)
and RWKV's WKV scan the K5 kernel; decode, the MoE dispatch and the RG-LRU
scan are plain PyTorch, as the reference leaves them to XLA.  The decode
caches are updated in place.  ``forward`` is also the train step's trunk:
under autograd K4 and K5 run with their backward kernels, and with
``cfg.remat`` each layer (a hybrid's repeat group) is checkpointed, as the
reference's ``jax.checkpoint``.  The residual stream, embeddings and
logits are annotated with logical axes where the reference annotates them
(``distributed/sharding.py``: no-ops without a mesh); on a mesh the
vocab-sharded embedding is read by ``take_rows``.

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
from repro_torch.distributed.sharding import (annotate, annotate_grad,
                                              cache_zeros, take_rows)
from repro_torch.models import encdec, rglru, rwkv6
from repro_torch.models.attention import (Attention, attention_block,
                                          attention_decode_block)
from repro_torch.models.layers import (MLP, Norm, apply_norm, draw_, mlp,
                                       param, remat)
from repro_torch.models.moe import MoE, moe_block
from repro_torch.core.tree import Stacked, tree_map

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class AttnLayer(nn.Module):
    """Attention, then a dense ``mlp`` or, for an MoE config, ``moe``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, dtype, qkv_bias=cfg.qkv_bias,
                              qk_norm=cfg.qk_norm, bias=cfg.bias,
                              device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        if cfg.moe is not None:
            self.moe = MoE(cfg.d_model, cfg.moe, dtype, cfg.act, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype,
                           bias=cfg.bias, device=device)


class RecLayer(nn.Module):
    """An RG-LRU temporal block, then a dense MLP (no biases)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.rec = rglru.RecurrentBlock(cfg.d_model, cfg.d_rnn or cfg.d_model,
                                        dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device=device)


class RWKVLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.tm = rwkv6.TimeMix(cfg.d_model, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.cm = rwkv6.ChannelMix(cfg.d_model, cfg.d_ff, dtype, device)


def _hybrid_groups(cfg: ModelConfig):
    """The reference's hybrid layout: ``({name: kind}`` of the repeating
    groups, ``n_rep``, ``{name: kind}`` of the tail)."""
    k = len(cfg.pattern)
    n_rep, n_tail = cfg.n_layers // k, cfg.n_layers % k
    return ({f"p{i}_{kind}": kind for i, kind in enumerate(cfg.pattern)},
            n_rep, {f"t{i}_{cfg.pattern[i]}": cfg.pattern[i]
                    for i in range(n_tail)})


class LM(nn.Module):
    """The parameters of one decoder-only LM, allocated but not drawn
    (``init_params`` draws them, ``params_from_numpy`` loads them)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.enc_dec:
            raise ValueError(f"{cfg.name} is an encoder-decoder config: its "
                             "parameters are models/encdec.py's EncDec")
        dtype = getattr(torch, cfg.dtype)
        self.embed = param((cfg.vocab, cfg.d_model), dtype, device)
        self.unembed = param((cfg.d_model, cfg.vocab), dtype, device)
        self.final_norm = Norm(cfg.d_model, cfg.norm, device)
        if cfg.pattern:
            groups, n_rep, tail = _hybrid_groups(cfg)

            def stack(kind, n):
                layer = RecLayer if kind == "rec" else AttnLayer
                return nn.ModuleList(layer(cfg, dtype, device)
                                     for _ in range(n))
            self.blocks = nn.ModuleDict({"repeat": nn.ModuleDict(
                {name: stack(kind, n_rep) for name, kind in groups.items()})})
            if tail:
                self.blocks["tail"] = nn.ModuleDict(
                    {name: stack(kind, 1) for name, kind in tail.items()})
            return
        layer = RWKVLayer if cfg.block == "rwkv" else AttnLayer
        self.blocks = nn.ModuleList(layer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        if cfg.block == "rwkv":
            self.ln0 = Norm(cfg.d_model, cfg.norm, device)


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda"):
    """Random parameters as the reference's initializers draw them
    (normal 0.02 embeddings, 1/sqrt(fan_in) weights, zero norms and
    biases, RWKV's constant decays, RG-LRU's ``lambda_p`` of -1), from
    ``generator``, on ``device``: an ``LM``, or an ``encdec.EncDec`` for an
    encoder-decoder config.  The generator may live on the CPU or on the
    card (a CUDA generator draws full-width weights in place, without a
    trip through host memory).  Not the numbers of ``jax.random``: load the
    reference's with ``params_from_numpy`` to compare the two."""
    if cfg.enc_dec:
        return encdec.init_params(generator, cfg, device)
    return draw_(LM(cfg, resolve_device(device)), generator)


def _split_at(path: tuple) -> int | None:
    """Where a stacked leaf's layer index goes in its dotted name: after
    ``blocks`` (``blocks.<i>.attn.wq``, ``enc.blocks.<i>...``), or after a
    hybrid group's name (``blocks.repeat.p0_rec.<i>...``); None for a leaf
    that is not stacked."""
    if "blocks" not in path:
        return None
    i = path.index("blocks")
    return i + 3 if path[i + 1] in ("repeat", "tail") else i + 1


def _host(a):
    """A leaf of a reference tree as a tensor: numpy (bfloat16 from
    ml_dtypes through float32, exact) or a tensor as it is (the port's
    checkpoints restore bfloat16 as CPU tensors)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@torch.no_grad()
def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """The reference's ``lm.init_params`` (or ``encdec.init_params``) pytree
    with numpy leaves (``jax.tree.map(np.asarray, params)``, or a
    checkpoint's restored tree, whose bfloat16 leaves are CPU tensors) as
    the port's ``LM`` (or ``EncDec``) on ``device``: each stacked leaf is
    split along its leading layer (or repeat) dimension.  Every leaf must
    match one parameter by name, shape and dtype, and every parameter must
    get one."""
    dev = resolve_device(device)
    model = encdec.EncDec(cfg, dev) if cfg.enc_dec else LM(cfg, dev)
    state = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        a = _host(node)
        cut = _split_at(path)
        if cut is None:
            state[".".join(path)] = a
            return
        for i in range(a.shape[0]):
            state[".".join(path[:cut] + (str(i),) + path[cut:])] = a[i]

    walk(tree, ())
    params = dict(model.named_parameters())
    if set(state) != set(params):
        raise ValueError(f"parameter names differ from the reference's: "
                         f"only in the tree {sorted(set(state) - set(params))}"
                         f", only in the port {sorted(set(params) - set(state))}")
    for name, a in state.items():
        p = params[name]
        if tuple(a.shape) != tuple(p.shape) or a.dtype != p.dtype:
            raise ValueError(f"{name}: reference {tuple(a.shape)} {a.dtype}, "
                             f"port {tuple(p.shape)} {p.dtype}")
        p.copy_(a)
    return model


def param_tree(params) -> dict:
    """The reference's pytree layout of ``params`` (an ``LM`` or
    ``EncDec``, or ``{dotted name: tensor}`` such as its gradients): nested
    dicts by name, each of the reference's stacked leaves an
    ``tree.Stacked`` of the per-layer tensors in layer order.  The tensors
    are the ones given, not copies: the optimizer updates them in
    place."""
    named = (params if isinstance(params, dict)
             else dict(params.named_parameters()))
    tree, stacks = {}, {}
    for name, t in named.items():
        path = tuple(name.split("."))
        cut = _split_at(path)
        if cut is None:
            key, leaf = path, t
        else:
            key = path[:cut] + path[cut + 1:]
            stacks.setdefault(key, {})[int(path[cut])] = t
            leaf = stacks[key]
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = leaf
    for key, by_index in stacks.items():
        node = tree
        for k in key[:-1]:
            node = node[k]
        node[key[-1]] = Stacked(by_index[i] for i in range(len(by_index)))
    return tree


@torch.no_grad()
def params_to_numpy(params) -> dict:
    """The inverse of ``params_from_numpy``: the reference's pytree of an
    ``LM`` or ``EncDec``, stacked leaves stacked again, on the host: numpy
    arrays, and CPU tensors for bfloat16 leaves (numpy has no bfloat16;
    ``CheckpointManager`` writes either in the reference's format)."""
    def host(x):
        a = (torch.stack([s.detach() for s in x]) if isinstance(x, Stacked)
             else x.detach()).to("cpu", copy=True)
        return a if a.dtype == torch.bfloat16 else a.numpy()
    return tree_map(host, param_tree(params))


def _layers(params: LM, cfg: ModelConfig):
    """(group, name, index, layer) of every layer in the order they run:
    group None and name "attn"/"rwkv" for uniform stacks; a hybrid's
    repeats, each group in sorted name order, then its tail."""
    if not cfg.pattern:
        for i, lp in enumerate(params.blocks):
            yield None, cfg.block, i, lp
        return
    rep = params.blocks["repeat"]
    for r in range(len(next(iter(rep.values())))):
        for name in sorted(rep):
            yield "repeat", name, r, rep[name][r]
    if "tail" in params.blocks:
        for name in sorted(params.blocks["tail"]):
            yield "tail", name, 0, params.blocks["tail"][name][0]


# ---------------------------------------------------------------------------
# Layer applications
# ---------------------------------------------------------------------------

def _ffn(h, lp, cfg: ModelConfig):
    """The layer's dense MLP or MoE: (y, aux loss)."""
    if hasattr(lp, "moe"):
        y, losses = moe_block(h, lp.moe, cfg.moe, cfg.act)
        return y, losses["moe_aux"] + losses["moe_z"]
    return mlp(h, lp.mlp, cfg.act), 0.0


def _attn_layer_fwd(x, lp: AttnLayer, cfg: ModelConfig, q_chunk: int):
    """One transformer layer over (B, S, D); returns (x', (k, v), aux)."""
    # sequence-parallel TP: the residual stream sharded over `model` on the
    # sequence dim between blocks
    seq_ax = "seq_sp" if cfg.seq_parallel else None
    x = annotate(x, "batch", seq_ax, None)
    h = _seq_gathered(apply_norm(x, lp.ln1, cfg.norm), cfg)
    h, kv = attention_block(h, lp.attn, cfg, window=cfg.window,
                            q_chunk=q_chunk)
    x = annotate(x + _seq_gathered(h, cfg, grad=True), "batch", seq_ax, None)
    h, aux = _ffn(_seq_gathered(apply_norm(x, lp.ln2, cfg.norm), cfg), lp,
                  cfg)
    return (annotate(x + _seq_gathered(h, cfg, grad=True), "batch", seq_ax,
                     None), kv, aux)


def _seq_gathered(h, cfg: ModelConfig, grad: bool = False):
    """Sequence-parallel TP's all-gathers of the sequence, which GSPMD
    inserts by itself for the reference: ahead of a block's products, and
    (``grad``) of the gradient reaching a block's output, since DTensor
    cannot flatten (B, S) for a product, or its backward, with S
    sharded."""
    if not cfg.seq_parallel:
        return h
    if grad:
        return annotate_grad(h, "batch", None, None)
    return annotate(h, "batch", None, None)


def _rec_layer_fwd(x, lp: RecLayer, cfg: ModelConfig):
    """One recurrent layer over (B, S, D) from zero state; returns
    (x', {"h", "conv"}) with the state after the last token."""
    h, st = rglru.recurrent_block(apply_norm(x, lp.ln1, cfg.norm), lp.rec)
    x = x + h
    return annotate(x + mlp(apply_norm(x, lp.ln2, cfg.norm), lp.mlp,
                            cfg.act), "batch", None, None), st


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
    return (annotate(x + h, "batch", None, None),
            {"tm_x": tmx, "wkv": wkv, "cm_x": cmx})


def _layer_fwd(x, name: str, lp, cfg: ModelConfig, q_chunk: int):
    """Any decoder layer: (x', its decode state, aux)."""
    if name.endswith("rec"):
        return (*_rec_layer_fwd(x, lp, cfg), 0.0)
    if name == "rwkv":
        return (*_rwkv_layer_fwd(x, lp, cfg), 0.0)
    x, (k, v), aux = _attn_layer_fwd(x, lp, cfg, q_chunk)
    return x, {"k": k, "v": v}, aux


# ---------------------------------------------------------------------------
# Forward (prefill trunk)
# ---------------------------------------------------------------------------

def _run_layers(x, aux, layers, cfg: ModelConfig, q_chunk: int):
    """``layers`` ([(name, layer)]) in order over (B, S, D); aux summed."""
    for name, lp in layers:
        x, _, a = _layer_fwd(x, name, lp, cfg, q_chunk)
        aux = aux + a
    return x, aux


def _remat_units(params: LM, cfg: ModelConfig):
    """(layers, checkpointed) in the order they run: each layer of a
    uniform stack, each repeat of a hybrid's groups (in sorted name order),
    then a hybrid's tail layers unchecked, as the reference's scan bodies
    are ``jax.checkpoint``-ed and its tail is not."""
    units = []
    for group, name, r, lp in _layers(params, cfg):
        if group == "repeat" and units and units[-1][2] == r:
            units[-1][0].append((name, lp))
        else:
            units.append(([(name, lp)], group != "tail", r))
    return [(layers, ckpt) for layers, ckpt, _ in units]


def forward(params: LM, cfg: ModelConfig, x, q_chunk: int = 512):
    """x: (B, S, D) embeddings -> (hidden (B,S,D), aux_loss), the MoE
    layers' load-balance and z losses summed (0 without MoE).  Under
    autograd with ``cfg.remat``, each unit of ``_remat_units`` is
    checkpointed."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block == "rwkv":
        x = apply_norm(x, params.ln0, cfg.norm)
    for layers, ckpt in _remat_units(params, cfg):
        if ckpt:
            x, aux = remat(cfg, _run_layers, x, aux, layers, cfg, q_chunk)
        else:
            x, aux = _run_layers(x, aux, layers, cfg, q_chunk)
    return apply_norm(x, params.final_norm, cfg.norm), aux


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens):
    return annotate(take_rows(params.embed, tokens), "batch", None, None)


def logits_fn(params, cfg: ModelConfig, hidden):
    hidden = _seq_gathered(hidden, cfg)
    return annotate(hidden @ params.unembed, "batch", None, "vocab")


# ---------------------------------------------------------------------------
# Decode caches, prefill and decode
# ---------------------------------------------------------------------------

def flat_cache(tree, prefix: str = "") -> dict:
    """{dotted key: tensor} of a decode cache, whose hybrid and
    encoder-decoder forms nest dicts."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat_cache(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Decode-time state of one decoder-only model, zeros: attention caches
    ``{"k", "v"}`` of (L, B, max_len, K, hd), RWKV states
    ``{"tm_x", "wkv", "cm_x"}``, or a hybrid's ``{"repeat": {name: ...},
    "tail": {name: ...}}`` of RG-LRU states ``{"h", "conv"}`` and attention
    ring buffers of ``min(window, max_len)`` slots, stacked over repeats.
    Encoder-decoder caches are ``encdec.init_cache``'s."""
    if cfg.enc_dec:
        raise ValueError(f"{cfg.name}: encoder-decoder caches come from "
                         "encdec.init_cache")
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def attn_cache(n, length):
        shape = (n, batch, length, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    def rec_state(n):
        dr = cfg.d_rnn or cfg.d_model
        f32 = torch.float32
        return {"h": torch.zeros((n, batch, dr), dtype=f32, device=dev),
                "conv": torch.zeros((n, batch, rglru.CONV_W - 1, dr),
                                    dtype=f32, device=dev)}

    if cfg.pattern:
        groups, n_rep, tail = _hybrid_groups(cfg)
        length = min(cfg.window or max_len, max_len)

        def state(kind, n):
            return rec_state(n) if kind == "rec" else attn_cache(n, length)
        cache = {"repeat": {name: state(kind, n_rep)
                            for name, kind in groups.items()}}
        if tail:
            cache["tail"] = {name: state(kind, 1)
                             for name, kind in tail.items()}
        return cache
    if cfg.block == "rwkv":
        N, L = cfg.rwkv_head_size, cfg.n_layers
        return {
            "tm_x": torch.zeros((L, batch, cfg.d_model), dtype=dtype,
                                device=dev),
            "wkv": torch.zeros((L, batch, cfg.d_model // N, N, N),
                               dtype=torch.float32, device=dev),
            "cm_x": torch.zeros((L, batch, cfg.d_model), dtype=dtype,
                                device=dev),
        }
    return attn_cache(cfg.n_layers, max_len)


def _ring_pack(k, window: int):
    """Pack the last ``window`` entries of (B, S, K, hd) into ring-slot
    order: slot j holds the most recent position p < S with p % window ==
    j, zeros where there is none."""
    S = k.shape[1]
    j = torch.arange(window, device=k.device)
    p = S - 1 - torch.remainder(S - 1 - j, window)
    ring = k[:, torch.clamp(p, 0, S - 1)]
    return torch.where((p >= 0)[None, :, None, None], ring,
                       torch.zeros((), dtype=k.dtype, device=k.device))


def prefill(params: LM, cfg: ModelConfig, x, extra_len: int = 0,
            q_chunk: int = 512):
    """Run the trunk over a prompt and build the decode cache.

    x: (B, S, D) embeddings.  Returns (hidden (B,S,D), cache): attention
    caches of length S + extra_len (room for decode), a hybrid's windowed
    layers as ``window``-slot ring buffers, recurrent states after the
    prompt."""
    if cfg.block == "rwkv":
        x = apply_norm(x, params.ln0, cfg.norm)
    if not cfg.pattern and cfg.block == "attn":
        S = x.shape[1]
        dtype, cache = getattr(torch, cfg.dtype), None
        for _, name, i, lp in _layers(params, cfg):
            x, st, _ = _layer_fwd(x, name, lp, cfg, q_chunk)
            if cache is None:        # on a mesh placed as the layer's k, v
                cache = {n: cache_zeros(st[n], cfg.n_layers, S + extra_len,
                                        dtype) for n in ("k", "v")}
            cache["k"][i, :, :S] = st["k"]
            cache["v"][i, :, :S] = st["v"]
        return apply_norm(x, params.final_norm, cfg.norm), cache
    states = {}
    for group, name, _, lp in _layers(params, cfg):
        x, st, _ = _layer_fwd(x, name, lp, cfg, q_chunk)
        if "k" in st:
            st = {k: _ring_pack(a, cfg.window) for k, a in st.items()}
        states.setdefault((group, name), []).append(st)
    stacked = {key: {k: torch.stack([st[k] for st in sts])
                     for k in sts[0]} for key, sts in states.items()}
    if cfg.pattern:
        cache = {}
        for (group, name), st in stacked.items():
            cache.setdefault(group, {})[name] = st
    else:
        cache = stacked[(None, "rwkv")]
    return apply_norm(x, params.final_norm, cfg.norm), cache


def _attn_layer_decode(x, lp: AttnLayer, cfg, cache, pos, window):
    h = apply_norm(x, lp.ln1, cfg.norm)
    h, cache = attention_decode_block(h, lp.attn, cfg, cache, pos,
                                      window=window)
    x = x + h
    h, _ = _ffn(apply_norm(x, lp.ln2, cfg.norm), lp, cfg)
    return x + h, cache


def _rec_layer_decode(x, lp: RecLayer, cfg, state):
    """One token through a recurrent layer; ``state`` updated in place."""
    hn = apply_norm(x[:, 0, :], lp.ln1, cfg.norm)
    y, new = rglru.recurrent_block_step(hn, lp.rec, state)
    for k, a in new.items():
        state[k].copy_(a)
    x = x + y[:, None, :]
    return x + mlp(apply_norm(x, lp.ln2, cfg.norm), lp.mlp, cfg.act)


def decode_one(params: LM, cfg: ModelConfig, x, cache, pos: int):
    """x: (B, 1, D) current-token embedding; returns (hidden (B,1,D),
    cache), the cache updated in place."""
    if cfg.block == "rwkv":
        return _decode_rwkv(params, cfg, x, cache)
    for group, name, i, lp in _layers(params, cfg):
        c = cache if group is None else cache[group][name]
        c_l = {k: a[i] for k, a in c.items()}               # views: in place
        if "k" in c_l:
            c_l = {k: annotate(a, "batch", "kv_seq", None, None)
                   for k, a in c_l.items()}
        if name.endswith("rec"):
            x = _rec_layer_decode(x, lp, cfg, c_l)
        else:
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
