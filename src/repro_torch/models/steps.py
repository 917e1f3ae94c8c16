"""Serving step functions: prefill_step and decode_step (PyTorch port of
``repro.models.steps.make_prefill_step`` / ``make_decode_step``) for every
registered config.

Each runs eagerly under ``torch.no_grad`` on the device its parameters lie
on.  A prefill batch holds ``"tokens"`` (B, S) for a text config,
``"embeds"`` (B, S, D) for a frontend config (``frontends.embed_patches``
makes them), and ``"enc_embeds"`` (B, Te, D) plus ``"tokens"`` for an
encoder-decoder config.  The train step comes with the training slice
(ROADMAP.md), with the optimizer it needs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm


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
    B, S = batch["tokens"].shape
    self_c = {}
    for j, name in enumerate(("k", "v")):
        a = kvs[0][j]
        self_c[name] = torch.zeros((cfg.n_layers, B, S + extra_len,
                                    *a.shape[2:]), dtype=a.dtype,
                                   device=a.device)
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
