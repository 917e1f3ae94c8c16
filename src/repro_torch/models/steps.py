"""Step functions (PyTorch port of ``repro.models.steps``): the train
step with its loss, and the serving steps prefill and decode, for every
registered config.

Train inputs arrive pre-split into microbatches, every leaf (n_mb, mb,
...): ``"tokens"`` and ``"labels"`` (n_mb, mb, S), ``"embeds"`` for a
frontend config, ``"enc_embeds"`` (and ``"tokens"``) for an
encoder-decoder config.  The train step runs eagerly under autograd:
each microbatch's loss is differentiated (``torch.autograd.grad``; K4's
backward kernel on the card, each layer recomputed under ``cfg.remat``),
its gradients added into accumulators of ``grad_accum_dtype``, and the
optimizer updates the parameters and its state in place
(``Optimizer.update_``): at full width a functional update would hold
a second copy of the parameters and moments.  The state is ``{"params":
LM | EncDec, "opt": tree}``, the optimizer's tree in the reference's
layout (``lm.param_tree``), so the state checkpoints in the reference's
format.

The serving steps run eagerly under ``torch.no_grad`` on the device their
parameters lie on.  A prefill batch holds ``"tokens"`` (B, S) for a text
config, ``"embeds"`` (B, S, D) for a frontend config
(``frontends.embed_patches`` makes them), and ``"enc_embeds"`` (B, Te, D)
plus ``"tokens"`` for an encoder-decoder config.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import cache_zeros, take_last
from repro_torch.models import encdec, lm
from repro_torch.train.optim import global_norm

Z_LOSS = 1e-4


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def fused_xent(logits, labels):
    """Mean cross entropy and mean squared log-normaliser (the z loss) of
    (..., V) logits against integer labels, in float32.  The gold logit is
    picked by ``gather``, the reference's iota-compare-select: one entry
    either way, so the same number (on a mesh, a masked local gather summed
    over the vocab axis: ``sharding.take_last``)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = take_last(logits, labels)
    return torch.mean(lse - gold), torch.mean(torch.square(lse))


def compute_loss(params, cfg: ModelConfig, batch, q_chunk: int = 512):
    """(loss, {"nll", "z", "aux"}) of one microbatch: nll + Z_LOSS * z +
    the MoE layers' aux losses."""
    if cfg.enc_dec:
        tok = lm.embed_tokens(params, cfg, batch["tokens"])
        hidden, aux = encdec.forward(params, cfg, batch["enc_embeds"], tok)
    else:
        x = (batch["embeds"] if cfg.frontend
             else lm.embed_tokens(params, cfg, batch["tokens"]))
        hidden, aux = lm.forward(params, cfg, x, q_chunk)
    logits = lm.logits_fn(params, cfg, hidden)
    nll, z = fused_xent(logits, batch["labels"])
    loss = nll + Z_LOSS * z + aux
    return loss, {"nll": nll, "z": z, "aux": aux}


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def init_train_state(params, optimizer) -> dict:
    """``{"params": params, "opt": optimizer.init(...)}`` with the
    optimizer's state in the reference's layout."""
    return {"params": params, "opt": optimizer.init(lm.param_tree(params))}


def make_train_step(cfg: ModelConfig, optimizer, q_chunk: int = 512,
                    grad_dtype=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    state: ``{"params", "opt"}`` (``init_train_state``), updated in place
    and returned; batch leaves: (n_mb, mb, ...) tensors on the parameters'
    device.  Gradients are summed over the microbatches in ``grad_dtype``
    (default ``cfg.grad_accum_dtype``) and divided by n_mb; metrics:
    ``"loss"``, the mean microbatch loss, and ``"grad_norm"``, the norm of
    the averaged gradients before the optimizer clips them."""
    grad_dtype = grad_dtype or getattr(torch, cfg.grad_accum_dtype)

    def train_step(state, batch):
        model = state["params"].requires_grad_(True)   # built frozen
        named = dict(model.named_parameters())
        params = list(named.values())
        acc = {n: torch.zeros_like(p, dtype=grad_dtype)
               for n, p in named.items()}
        n_mb = next(iter(batch.values())).shape[0]
        loss_sum = params[0].new_zeros((), dtype=torch.float32)
        for i in range(n_mb):
            loss, _ = compute_loss(model, cfg,
                                   {k: v[i] for k, v in batch.items()},
                                   q_chunk)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            with torch.no_grad():
                for a, g in zip(acc.values(), grads):
                    if g is not None:
                        a.add_(g.to(grad_dtype))
                loss_sum += loss.detach()
            del loss, grads
        with torch.no_grad():
            for a in acc.values():
                a.div_(n_mb)
            tree = lm.param_tree(acc)
            gn = global_norm(tree)
            optimizer.update_(tree, state["opt"], lm.param_tree(model))
        return state, {"loss": loss_sum / n_mb, "grad_norm": gn}

    return train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def _prefill_encdec(params, cfg: ModelConfig, batch, extra_len: int):
    """Encode the frames, build the cross caches, run the decoder over the
    prompt and keep its self-attention keys and values, so that decode
    continues after the prompt (the reference's prefill returns the cross
    caches only)."""
    enc_out = encdec.encode(params, cfg, batch["enc_embeds"])
    ck, cv = encdec.build_cross_cache(params, cfg, enc_out)
    tok = lm.embed_tokens(params, cfg, batch["tokens"])
    hidden, kvs = encdec.decode_train(params, cfg, tok, enc_out,
                                      return_kv=True)
    S = batch["tokens"].shape[1]
    self_c = {}
    for j, name in enumerate(("k", "v")):
        a = kvs[0][j]
        self_c[name] = cache_zeros(a, cfg.n_layers, S + extra_len, a.dtype)
        self_c[name][:, :, :S] = torch.stack([kv[j] for kv in kvs])
    return hidden, {"self": self_c, "cross_k": ck, "cross_v": cv}


def make_prefill_step(cfg: ModelConfig, q_chunk: int = 512,
                      extra_len: int = 0):
    """prefill_step(params, batch) -> (logits (B, V) of the last prompt
    token, decode cache with ``extra_len`` free positions)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.enc_dec:
            hidden, cache = _prefill_encdec(params, cfg, batch, extra_len)
        else:
            x = (batch["embeds"] if cfg.frontend
                 else lm.embed_tokens(params, cfg, batch["tokens"]))
            hidden, cache = lm.prefill(params, cfg, x, extra_len, q_chunk)
        logits = lm.logits_fn(params, cfg, hidden[:, -1:, :])
        return logits[:, 0, :], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, cache, tokens (B,1), pos) -> (logits (B, V),
    cache), the cache updated in place."""

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        x = lm.embed_tokens(params, cfg, tokens)
        if cfg.enc_dec:
            hidden, cache = encdec.decode_one(params, cfg, x, cache,
                                              int(pos))
        else:
            hidden, cache = lm.decode_one(params, cfg, x, cache, int(pos))
        logits = lm.logits_fn(params, cfg, hidden)
        return logits[:, 0, :], cache

    return decode_step


# ---------------------------------------------------------------------------
# Input construction (shapes + dtypes for each (arch, shape) cell)
# ---------------------------------------------------------------------------

def input_shapes(cfg: ModelConfig, shape: ShapeSpec, n_mb: int | None = None):
    """Input signature of one cell; values are (shape, torch dtype).

    train: microbatched token/label batches (+ stub embeddings for vlm /
    audio); prefill: the prompt batch; decode: one token (the cache's
    shapes are ``eval_cache_shapes``')."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    i32 = torch.int32
    if shape.kind == "train":
        n_mb = n_mb or cfg.train_microbatches
        mb = B // n_mb
        out = {"labels": ((n_mb, mb, S), i32)}
        if cfg.enc_dec:
            out["enc_embeds"] = ((n_mb, mb, S, cfg.d_model), dt)
            out["tokens"] = ((n_mb, mb, S), i32)
        elif cfg.frontend:
            out["embeds"] = ((n_mb, mb, S, cfg.d_model), dt)
        else:
            out["tokens"] = ((n_mb, mb, S), i32)
        return out
    if shape.kind == "prefill":
        out = {}
        if cfg.enc_dec:
            out["enc_embeds"] = ((B, S, cfg.d_model), dt)
            out["tokens"] = ((B, S), i32)
        elif cfg.frontend:
            out["embeds"] = ((B, S, cfg.d_model), dt)
        else:
            out["tokens"] = ((B, S), i32)
        return out
    return {"tokens": ((B, 1), i32)}


def eval_cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """The decode cache's tree of tensors on the ``meta`` device: shapes
    and dtypes, no memory."""
    if cfg.enc_dec:
        return encdec.init_cache(cfg, batch, max_len, max_len, device="meta")
    return lm.init_cache(cfg, batch, max_len, device="meta")
