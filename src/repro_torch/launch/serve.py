"""Serving launcher: batched prefill + greedy decode for any registered LM
config at its ``.reduced()`` size (PyTorch port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --device cpu

Runs on the card by default (``--device cuda``; it raises without one).
Text configs prefill seeded random tokens; the vision config
(phi-3-vision-4.2b) prefills embeddings from the stub frontend
(``frontends.embed_patches`` of synthetic patches); whisper-small encodes
``prompt-len + tokens`` stub frames from the same frontend and prefills a
token prompt against them.  Full published widths are driven by
``chip_smoke.py`` through the same step functions.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import frontends, lm, steps


def prefill_batch(cfg: ModelConfig, batch: int, prompt_len: int,
                  enc_len: int, device, seed: int = 1) -> dict:
    """A prefill batch for ``cfg`` from ``seed``: ``{"tokens"}`` (B, P) for
    a text config, ``{"embeds"}`` (B, P, D) from the stub frontend for a
    vision config, ``{"enc_embeds"}`` (B, enc_len, D) stub frames plus
    ``{"tokens"}`` for an encoder-decoder config."""
    gen = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    out = {}
    if cfg.enc_dec or not cfg.frontend:
        out["tokens"] = torch.randint(0, cfg.vocab, (batch, prompt_len),
                                      generator=gen).to(device)
    if cfg.frontend:
        fe = frontends.init_frontend(gen, cfg.d_model, dtype, device)
        n = enc_len if cfg.enc_dec else prompt_len
        patches = frontends.synthetic_patches(gen, batch, n, dtype)
        key = "enc_embeds" if cfg.enc_dec else "embeds"
        out[key] = frontends.embed_patches(fe, patches.to(device))
    return out


def serve(cfg: ModelConfig, params, batch: dict, n_tokens: int,
          q_chunk: int = 16):
    """Prefill ``batch`` then ``n_tokens`` greedy decode steps.  Returns
    (tokens (B, 1 + n_tokens), cache, decode seconds)."""
    prefill = steps.make_prefill_step(cfg, q_chunk=q_chunk,
                                      extra_len=n_tokens)
    decode = steps.make_decode_step(cfg)
    first = next(iter(batch.values()))
    P = batch["tokens"].shape[1] if "tokens" in batch else first.shape[1]
    logits, cache = prefill(params, batch)
    tok = torch.argmax(logits, -1)[:, None]
    out = [tok]
    if first.is_cuda:
        torch.cuda.synchronize(first.device)
    t0 = time.perf_counter()
    for t in range(n_tokens):
        logits, cache = decode(params, cache, tok, P + t)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    if first.is_cuda:
        torch.cuda.synchronize(first.device)
    return torch.cat(out, dim=1), cache, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device=dev)
    B, P, N = args.batch, args.prompt_len, args.tokens
    batch = prefill_batch(cfg, B, P, P + N, dev)
    tokens, _, dt = serve(cfg, params, batch, N)
    print(f"{cfg.name}: {B * N / dt:.1f} tok/s (batch {B}, reduced, "
          f"{dev.type})")
    return tokens[:, -1:]


if __name__ == "__main__":
    main()
