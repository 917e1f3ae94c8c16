"""Helios applied to LM training on the PyTorch/CUDA port: out-of-core
token pipeline + token hotness + fault-tolerant training loop
(straggler detection, async checkpoints, restore).

The port's twin of ``train_llm_tiered.py``: a reduced config trains on
token sequences streamed from a seeded ``TokenStore`` through the async
IO stack, two microbatches a step, AdamW with warmup-cosine, on the card
unless ``--device cpu`` is given (then every kernel runs its plain
version).  Every registered config trains on the card, rwkv6-7b through
K5's forward and backward kernels.

    PYTHONPATH=src python examples/train_llm_tiered_torch.py --steps 60
    PYTHONPATH=src python examples/train_llm_tiered_torch.py --device cpu \\
        --steps 20 --arch llama3.2-3b
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.hotness import token_hotness
from repro_torch.data.tokens import OutOfCoreTokenIterator, TokenStore
from repro_torch.ft.failures import Coordinator
from repro_torch.launch.train import consumed_state, device_batch
from repro_torch.models import lm, steps
from repro_torch.train.optim import adamw, warmup_cosine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    root = tempfile.mkdtemp(prefix="helios_llm_")
    cfg = get_config(args.arch).reduced()
    store = TokenStore(f"{root}/tokens", n_sequences=256, seq_len=32,
                       vocab=cfg.vocab, n_shards=4, create=True)
    it = OutOfCoreTokenIterator(store, batch_size=16, n_microbatches=2)

    # token-frequency hotness drives the embedding-row tier placement
    sample = store.read_rows(np.arange(64))
    hot = token_hotness(sample.astype(np.int64), cfg.vocab)
    print(f"token hotness: top-1% of vocab covers "
          f"{hot[np.argsort(-hot)[:cfg.vocab // 100]].sum() / hot.sum():.0%}"
          " of accesses")

    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)
    opt = adamw(warmup_cosine(1e-3, 10, args.steps))
    state = steps.init_train_state(params, opt)
    train = steps.make_train_step(cfg, opt, q_chunk=16)

    mgr = CheckpointManager(f"{root}/ckpt", keep=2)
    coord = Coordinator(n_workers=1)
    losses, stragglers = [], 0
    for step in range(args.steps):
        t0 = time.perf_counter()
        coord.heartbeat(0)
        state, m = train(state, device_batch(next(it), cfg, dev))
        losses.append(float(m["loss"]))
        plan = coord.observe_stage(step, "train", time.perf_counter() - t0)
        if plan["action"] != "ok":
            stragglers += 1
            print(f"  step {step}: straggler detected -> {plan}")
        if step % 20 == 19:
            mgr.save(step, {"params": lm.params_to_numpy(params),
                            "opt": state["opt"]},
                     extra={"data_iter": consumed_state(it)})
            print(f"step {step:3d} loss {losses[-1]:.3f} (async checkpoint)")
    mgr.wait()
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps; "
          f"checkpoints at steps {mgr.all_steps()}")
    restored, extra = mgr.restore()
    if restored is not None:
        back = lm.params_from_numpy(restored["params"], cfg, dev)
        print(f"restore ok: step {extra['step']}, data cursor "
              f"{extra['data_iter']['cursor']}, "
              f"{sum(p.numel() for p in back.parameters())} parameters")
    return {"losses": losses, "stragglers": stragglers,
            "checkpoints": mgr.all_steps()}


if __name__ == "__main__":
    main()
