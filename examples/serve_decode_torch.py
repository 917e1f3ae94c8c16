"""Serve a (reduced) registered LM with batched decode requests on the
PyTorch/CUDA port: prefill, then token-by-token greedy decode through the
KV-cache / recurrent-state path, for any --arch (the port's counterpart of
``examples/serve_decode.py``).

    PYTHONPATH=src python examples/serve_decode_torch.py --arch rwkv6-7b
    PYTHONPATH=src python examples/serve_decode_torch.py \\
        --arch whisper-small --device cpu

Runs on the card by default and raises without one; ``--device cpu`` runs
the kernels' plain versions.
"""
import argparse

import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.core.device import resolve_device
from repro_torch.launch.serve import prefill_batch, serve
from repro_torch.models import lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_configs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device=dev)
    B, P, N = args.batch, args.prompt_len, args.tokens
    batch = prefill_batch(cfg, B, P, P + N, dev)
    tokens, cache, dt = serve(cfg, params, batch, N)
    print(f"arch={args.arch} family={cfg.family} device={dev.type}")
    print(f"decoded {N} tokens x batch {B} in {dt:.2f}s "
          f"({B * N / dt:.0f} tok/s, reduced config)")
    nbytes = sum(a.numel() * a.element_size()
                 for a in lm.flat_cache(cache).values())
    print(f"serving state size: {nbytes / 1e6:.2f} MB "
          f"({'O(1) in context' if cfg.subquadratic else 'KV grows with context'})")
    print("sample:", tokens[0, 1:17].tolist())
    return tokens


if __name__ == "__main__":
    main()
