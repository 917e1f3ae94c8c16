"""Serving step functions: prefill_step and decode_step (PyTorch port of
``repro.models.steps.make_prefill_step`` / ``make_decode_step``).

Each runs eagerly under ``torch.no_grad`` on the device its parameters lie
on.  The train step comes with the training slice (ROADMAP.md), with the
optimizer it needs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def make_prefill_step(cfg: ModelConfig, q_chunk: int = 512,
                      extra_len: int = 0):
    """prefill_step(params, {"tokens": (B, S)}) -> (logits (B, V) of the
    last prompt token, decode cache with ``extra_len`` free positions)."""
    lm.check_supported(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        x = lm.embed_tokens(params, cfg, batch["tokens"])
        hidden, cache = lm.prefill(params, cfg, x, extra_len, q_chunk)
        logits = lm.logits_fn(params, cfg, hidden[:, -1:, :])
        return logits[:, 0, :], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, cache, tokens (B,1), pos) -> (logits (B, V),
    cache), the cache updated in place."""
    lm.check_supported(cfg)

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        x = lm.embed_tokens(params, cfg, tokens)
        hidden, cache = lm.decode_one(params, cfg, x, cache, int(pos))
        logits = lm.logits_fn(params, cfg, hidden)
        return logits[:, 0, :], cache

    return decode_step
