"""Training launcher: ``--arch <id>`` selects any registered config
(PyTorch port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
        --steps 3 --device cpu

Runs the ``.reduced()`` config unless ``--full-config`` is given, on the
card unless ``--device cpu`` is (it raises without a card).  Token
sequences come from a seeded ``TokenStore`` through the out-of-core
iterator, two microbatches a batch; the vision and encoder-decoder
configs get zero stub embeddings, as in the reference.  AdamW with a
warmup-cosine schedule, the train step of ``models/steps.py`` (K4 and its
backward kernel on the card), a ``Coordinator`` heartbeat and stage
timing per step, and an async checkpoint at each step with ``step % 10
== 9``, as the reference's, in the reference's format: ``{"params",
"opt"}`` in the reference's tree layout and the data iterator's state,
so ``--resume`` continues a run of either package.

Three differences from the reference launcher, all for an exact resume:
the last step of a run is checkpointed too; the schedule's length is the
last step of this invocation (``start + --steps``), so a resumed run
follows the schedule an uninterrupted one would; and the saved data
cursor is that of the batches consumed, where the reference saves the
iterator's cursor after its two prefetched batches and a resume skips
them.  On the card every config trains: rwkv6-7b's WKV through K5 and
its backward kernel (``kernels/rwkv_scan``), attention through K4's.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.tokens import OutOfCoreTokenIterator, TokenStore
from repro_torch.ft.failures import Coordinator
from repro_torch.models import lm, steps
from repro_torch.train.optim import adamw, warmup_cosine

N_MICROBATCHES = 2


def consumed_state(it: OutOfCoreTokenIterator) -> dict:
    """The iterator's state as of the batches handed out, without the
    ``it.prefetch`` batches it has already submitted: an iterator built
    from it yields the next batch this one would."""
    st = it.checkpoint_state()
    per_epoch = it.store.n_rows // it.batch
    done = st["epoch"] * per_epoch + st["cursor"] // it.batch - it.prefetch
    return {"epoch": done // per_epoch, "cursor": done % per_epoch * it.batch,
            "seed": st["seed"]}


def device_batch(raw: dict, cfg: ModelConfig, device) -> dict:
    """An iterator batch (numpy (n_mb, mb, S)) as tensors on ``device``,
    with zero stub embeddings for a frontend or encoder-decoder config."""
    b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device).long()
         for k, v in raw.items()}
    if cfg.enc_dec or cfg.frontend:
        emb = torch.zeros((*b["tokens"].shape, cfg.d_model),
                          dtype=getattr(torch, cfg.dtype), device=device)
        if cfg.enc_dec:
            b["enc_embeds"] = emb
        else:
            b = {"embeds": emb, "labels": b["labels"]}
    return b


def main(argv=None) -> list[float]:
    """Run the launcher; returns the losses of the steps it ran."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--full-config", action="store_true",
                    help="the full (published) config, not .reduced()")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} device={dev}")

    root = args.ckpt_dir or tempfile.mkdtemp(prefix=f"train_{cfg.name}_")
    store = TokenStore(f"{root}/tokens", n_sequences=max(64, args.batch * 8),
                       seq_len=args.seq, vocab=cfg.vocab, n_shards=4,
                       create=True)
    mgr = CheckpointManager(f"{root}/ckpt", keep=3)
    coord = Coordinator(n_workers=1)

    start = 0
    restored, extra = (mgr.restore(device=dev) if args.resume
                       else (None, None))
    if restored is not None:
        model = lm.params_from_numpy(restored["params"], cfg, dev)
        start = extra["step"] + 1
        it = OutOfCoreTokenIterator(
            store, args.batch, N_MICROBATCHES,
            state=OutOfCoreTokenIterator.restore_state(extra["data_iter"]))
        print(f"resumed from step {extra['step']}")
    else:
        model = lm.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, dev)
        it = OutOfCoreTokenIterator(store, args.batch, N_MICROBATCHES)
    opt = adamw(warmup_cosine(1e-3, 10, start + args.steps))
    state = steps.init_train_state(model, opt)
    if restored is not None:
        state["opt"] = restored["opt"]
    train = steps.make_train_step(cfg, opt, q_chunk=16)

    if cfg.frontend or cfg.enc_dec:
        print("note: modality frontends are stubbed; feeding synthetic embeds")
    losses = []
    last = start + args.steps - 1
    for step in range(start, start + args.steps):
        t0 = time.perf_counter()
        coord.heartbeat(0)
        state, m = train(state, device_batch(next(it), cfg, dev))
        losses.append(float(m["loss"]))
        dt = time.perf_counter() - t0
        coord.observe_stage(step, "train", dt)
        if step % 5 == 0 or step == last:
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} ({dt:.2f}s)")
        if step % 10 == 9 or step == last:
            mgr.save(step, {"params": lm.params_to_numpy(model),
                            "opt": state["opt"]},
                     extra={"data_iter": consumed_state(it)})
    mgr.wait()
    print("checkpoints:", mgr.all_steps())
    return losses


if __name__ == "__main__":
    main()
