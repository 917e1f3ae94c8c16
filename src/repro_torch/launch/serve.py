"""Serving launcher: batched prefill + greedy decode for an LM config at its
``.reduced()`` size (PyTorch port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --device cpu

Runs on the card by default (``--device cuda``; it raises without one).
Configs of families the port does not serve yet (hybrid, MoE, frontends,
encoder-decoder) raise ``NotImplementedError``.  Full published widths are
driven by ``chip_smoke.py`` through the same step functions.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.core.device import resolve_device
from repro_torch.models import lm, steps


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
    prompt = torch.randint(0, cfg.vocab, (B, P),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    prefill = steps.make_prefill_step(cfg, q_chunk=16, extra_len=N)
    decode = steps.make_decode_step(cfg)

    logits, cache = prefill(params, {"tokens": prompt})
    tok = torch.argmax(logits, -1)[:, None]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for t in range(N):
        logits, cache = decode(params, cache, tok, P + t)
        tok = torch.argmax(logits, -1)[:, None]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{cfg.name}: {B * N / dt:.1f} tok/s (batch {B}, reduced, "
          f"{dev.type})")
    return tok


if __name__ == "__main__":
    main()
