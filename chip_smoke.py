#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card: GNN inference serving (K1-K3),
scale-out (a remote-tier cache, a dead peer, a serving fleet; K1-K3),
out-of-core GNN training (K1, K2/K3 forward and backward), LM serving of
every registered family, prefill then greedy decode (K4, K5), and the LM
train step (K4 forward and backward) at full width.

    python3 chip_smoke.py
    python3 chip_smoke.py --gnn-kernels OTHER/src   # phases 1, 3, 4 only,
                                                    # of another checkout
    python3 chip_smoke.py --lm-kernels OTHER/src    # phase 1, K4's forward
                                                    # rows and phase 9 a,
                                                    # of another checkout

Imports nothing of JAX and nothing of the reference package.  Phases; any
failure raises and the script exits non-zero:

  1. build   — compile every CUDA kernel of both paths from src/repro_torch/
               csrc with nvcc for sm_90a (one process per source, at once),
               print each kernel's registers and spills, and fail if the
               hd-256 tensor-core forward (``flash_fwd_tc_kernel<256>``)
               spills;
  2. edges   — each kernel against its plain PyTorch version on the card
               at the edge cases (K1: B in {1, 1023, 1024, 1025, 65,537,
               150,000}, mixed tiers with remote and out-of-range ids,
               all-device, all-host, all-miss and empty tiers, random ids
               and a pool of 37 repeated across every 256-position tile,
               int32 and int64 ids, bit-exact; K3: D in {1, 3, 4, 255,
               256, 1020, 1024}, f32 and bf16, int32 and int64 ids, E in
               {0, 1, 4,096, 65,537}, one id over every edge, shuffled runs
               of 10 and 25, unsorted and out-of-range ids, each call on
               the route its width calls for; K2: widths of 4, 12, 1020,
               1024 and 4112 bytes, f32 and bf16, B
               from 0 to 65,537, int32 and int64 indices, random and
               sorted with repeats, out-of-range indices, a misaligned
               view; K4, both routes at their seams, q/k/v views of one
               packed qkv: f32 at S in {1, 24, 129}, bf16 at S in {1, 24,
               129, 1000}, hd in {32, 64, 80, 128}, GQA groups {1, 3, 8},
               causal or not, causal S=100 over T=612 at q_offset 512, bf16
               S=4096 at one GQA shape; hd 96, 112 and 256 at S 1 and 129
               (GQA 10) and the q_offset case; windows of 1, 127, 128 and
               129 at hd 64, 128 and 256, causal or not, and 64 at the
               q_offset case; at hd 256 (64-key tiles on the tensor cores)
               also windows of 63, 64 and 65 and ragged T % 64 != 0 (333 x
               333 causal, 37 x 611 non-causal); whisper's non-causal 64 x
               1500, 1500 x 1500 and 37 x 611 at hd 64; recurrentgemma's S
               4096 at window
               2048 (hd 256, MQA); f32 and bf16, each call on the route
               its dtype and width call for; K5:
               N in {8, 16, 32, 64}, T in {0, 1, 5, 17, 64, 1000}, logw at
               -20, -6, -1e-4 and mixed, with and without a state, B*H of
               1 and 256);
  3. serve   — GNNInferenceServer on the IG-shaped graph (269,000
               vertices, 1024-dim f32 rows) with GraphSAGE at hidden 256,
               fanouts (10, 5), 64-seed requests, 8 per micro-batch: the
               launch counters are zeroed, the requests are submitted and
               flushed under the tracer (its serve.* spans split the wall
               time per micro-batch), and every kernel must have
               launched;
  4. kernels — K1-K3 against their plain versions on the card on the
               inputs the serving run gave them (K1, K2 bit-exact; K3
               within 1e-5 of the largest sum), timed with the L2 cache
               cold (device time from the profiler, and CUDA events) beside
               the plain version, the bound and a PyTorch library call,
               each with its device time per launch (``per_launch_ms``).
               K2 on the served expansion and on layer 2's gather, K3 on
               layer 1's and layer 2's blocks (``kernel_route`` names the
               route each took).  Then a training-shaped minibatch: 1024
               seeds from ``draw_unique``, sampled at fanouts (25, 10):
               K1 on its unique nodes against the serving cache's tiers,
               K3 on its hop-2 block (messages gathered from a seeded
               random (N_pad, 1024) f32 block, masked as the model masks
               them) and at D = 1 on the block's edge counts (the
               ``training`` and ``training_counts`` rows).  Beside each K1
               row, ``pcie_probe``: one plain UVA copy of the same
               host-tier rows (K2's kernel on the pinned tier), its time
               and the PCIe read rate it reaches against 64 GB/s;
  5. cpu     — a fresh server on the CPU (plain versions, same
               parameters) serves the same requests: same answered/shed
               split, logits within 1e-4;
  5a. scale_out — the store's rows copied in chunks into a 4-worker
               PartitionedFeatureStore (hash ownership, 4 shards each)
               under build/smoke_scale_out/, removed at the end:
               a. a cache on the card over RemoteIOEngine(me=0) at the
               server's 5%/10% tiers and phase 3's presampled hotness
               replays phase 3's micro-batch node sets, then phase 4's
               training-shaped batch, under the tracer and the profiler
               with the launch counters zeroed (wall ms per gather by the
               cache.gather.* spans, busy share): K1 must launch once per
               gather and list remote misses; every row equals a
               single-store card cache's (its replay timed beside) and
               store.read_rows; a CPU cache over the same partitioned
               store (its own engine) gives the same rows, CacheStats
               (wall time aside) and engine row counters;
               b. worker 1 killed (FailureInjector on a Coordinator) at
               the third gather of the same trace, every gather submitted
               before any completes: identical rows, rows rerouted, every
               ticket completed once (a CompletionQueue counts them);
               c. a 3-replica ServingFleet on the card over a writable
               copy of the store serves the 64 requests, owner-writes new
               values to the 1,024 rows that round read most, settles
               every replica (a second settle must refresh nothing) and
               serves them again (each round traced and profiled, K1-K3
               launched in each); every replica and the store return the
               new rows; a CPU fleet with the card's parameters over its
               own copy routes, answers and sheds alike, invalidates as
               many rows, logits within 1e-4;
               d. K1 on the remote-tier cache's first gather, bit-exact
               against its plain version, timed as in phase 4 beside its
               bound and a PCIe probe (the ``remote_tier`` row under K1);
  5b. train  — a. OutOfCoreGNNTrainer at its defaults (helios, sage,
               hidden 256, batch 1024, fanouts (25, 10), 5%/10% cache) on
               the same store, read-only: 2 warm-up batches, then 8
               counted under the tracer and the profiler with the launch
               counters zeroed: wall ms per batch, ms per operator
               (``pipe.*`` spans), the device's busy share and top
               operations, peak memory, K1's queue lag behind the step on
               the one stream (CUDA events), losses, virtual_s, cache and
               IO stats, K2/K3 launches by use.  K1 must launch once
               per batch; K2 and K3 forward and backward (their wrappers'
               ``launches_by_use``) at least once.  The 2 warm-up
               batches run on a trainer of their own with seed 1, so the
               counted ones repeat none of their seed sets;
               b. the first counted batch's loss with embedding gradients
               through the kernels and through the plain versions' own
               autograd on the same card tensors: every parameter
               gradient and dL/dfeats within 1e-4 of its largest
               magnitude; then K2 at both layers' forward gathers and as
               K3's backward, and K3 as K2's backward at both layers, on
               the tensors that pass recorded, timed as in phase 4
               (``train_*`` rows under K2 and K3, each with its launches
               per step in the counted run);
               c. a reduced trainer (TRAIN_SMALL: helios-nopipe,
               trainable embeddings with momentum and sparse Adam, 3
               batches) on the card and on the CPU over writable stores
               made alike: sampled batches, cache/IO/write-back stats
               and virtual_s identical, losses and parameters within
               1e-4 (tolerances on the stores in ``phase_train_cpu``);
               two faulted card runs (dL/dfeats in bf16; the gather's
               gradient cut) are controls the checks must reject;
  6. llm     — llama3.2-3b, rwkv6-7b, qwen2-moe-a2.7b, recurrentgemma-2b,
               phi-3-vision-4.2b, whisper-small and kimi-k2-1t-a32b at
               full published width in bf16 with random weights from a
               seeded CUDA generator (each freed before the next): batch 4,
               a 1024-token prompt (recurrentgemma 4096, twice its window;
               phi-3-vision 1024 stub-frontend embeddings; whisper 1500
               stub encoder frames and a 64-token prompt), one
               make_prefill_step then 32 make_decode_step calls with greedy
               tokens.  kimi-k2 is cut to 1 of its 61 layers (the one cut:
               the whole model cannot fit on one card).  The K4/K5
               counters are zeroed just before and read just after: K4
               must launch once per attention layer (28, 24, 8 windowed,
               32, 36 = 12 encoder + 12 self + 12 cross, 1), K5 once per
               rwkv layer (32), every bf16 K4 launch on the route its
               head width calls for (the tensor cores at 64-256, so
               recurrentgemma's 256 too), and K4's own count by use
               (causal, window, S == T) as ``k4_uses_for`` expects; phase
               7's K4 rows take their launches from it.  Prefill ms (and
               a second prefill's: the first at the full prompt also
               grows the caching allocator), decode ms per token, tok/s,
               peak memory, then one profiled prefill (its wall and
               device ms, K4's device ms) and 4 profiled decode steps
               for the device's busy share and its top operations;
  7. kernels — K4 and K5 against their plain versions on the inputs the
               llm runs gave them (K4: llama layer 0, recurrentgemma's
               first attention layer with its window and, beside it, the
               same inputs without, phi-3-vision and kimi-k2 layer 0,
               whisper's encoder layer 0 and decoder layer 0's
               cross-attention; K5: rwkv layer 0; K4 entry by entry
               within ``K4_FWD_TOL`` (scaled by each output row's mean
               magnitude), a planted fault (a key
               tile of V zeroed; with a window, the band 64 keys short)
               failing that, and the largest error within 2^-6 in bf16,
               each row with its largest and mean |output|), timed as
               in phase 4, with SDPA as K4's library yardstick (given the
               boolean mask where there is a window); the windowed K4
               must take less time than the same inputs without the
               window, and llama's and recurrentgemma's rows must run on
               the tensor cores (each entry names its route,
               ``kernel_route``);
  8. cpu     — prefill and 8 decode steps at .reduced() width on the card
               and on the CPU (plain versions), every family
               (recurrentgemma at window 8 over a 24-token prompt), float32
               (logits and caches within 1e-4) and bfloat16 (within 5e-2 of
               the largest magnitude), K4 launched once per attention in
               each prefill.  The MoE configs' bf16 card runs take the
               CPU's routing (``RoutingReplay``: a rounding difference can
               flip a top-k choice), so the bf16 path after the router is
               compared; the card's own flips are counted;
  9. lm_train — a. K4's backward (``flash_attention_bwd``) against
               autograd through its plain version on the card, bf16 and
               float32, at llama3.2-3b's training layer (q (1, 4096, 24,
               128), kv 8 heads, causal), whisper's cross-attention (64
               over 1500 frames, non-causal), recurrentgemma's window
               (hd 256, MQA, window 2048, S 4096) and a ragged hd-8
               shape: each on the route its dtype and width call for
               (``kernel_route``: bf16 at hd 64-256 on the tensor cores,
               recurrentgemma's 256 too; float32 and bf16 at hd 8 on the
               CUDA cores; each from the forward's saved log-sum-exp),
               every entry of dq,
               dk, dv within ``K4_BWD_TOL`` of its plain value
               (``k4_bwd_check``), and one key tile of dk or dv zeroed
               must fail that; timed as in phase 4 beside the plain
               version's backward and SDPA's (the library yardstick);
               b. one make_train_step (AdamW, 2 microbatches) of the
               dense, MoE, hybrid, vision and audio configs at .reduced()
               width in float32 on the card and on the CPU: loss and
               grad_norm within 1e-4, parameters after the step
               (``lm_family_steps``);
               c. llama3.2-3b at full width in bf16 (seeded weights),
               train_4k's 4096 tokens in 2 microbatches of 1 (the one
               cut: the global batch, 256 -> 2), AdamW with
               warmup_cosine through the in-place update, tokens from a
               seeded TokenStore: first a gate on the first batch's
               first microbatch, the loss, the gradient norm and the q,
               k, v projections' gradient norms with K4 and its backward
               against plain attention on the card (``LM_TRAIN_GATE``),
               the kernel side run twice (``repeat``: whether its
               readings repeat bit for bit), and with K4's backward
               planted to give zeros, which must fail it; 1 warm-up step,
               then 3 counted with the counters zeroed (K4 forward twice
               per layer and microbatch under remat, its backward once,
               every backward on the tensor cores); then the first batch
               again, profiled, whose loss must be lower than the first
               step's.  ms per step, tokens/s, model TFLOP/s, the busy
               share, peak memory, device ms by operation and K4's device
               ms per step: the forward, and the backward's delta pass,
               dK/dV and dQ kernels;
               d. recurrentgemma-2b likewise (the same tokens, cut and
               optimizer; the ``hybrid`` entry): its 8 local attention
               layers (hd 256, MQA, window 2048, half the 4096 tokens)
               run K4's hd-256 backward on the tensor cores, 8 a
               microbatch, with its dK/dV kernel's head groups and their
               ordered sum; the gate, 1 warm-up and 2 counted steps, the
               first batch again; model TFLOP/s counts the attention
               pairs inside the window only.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(K1-K5 and K4's backward at llama's and recurrentgemma's layers), one ``{"server": ...}`` line, one
``{"train": ...}`` line, one ``{"llm": ...}`` line, one ``{"scale_out":
...}`` line, one ``{"lm_train": ...}`` line, and as the last line
``{"ok": true, "device": {...}}``.  With ``--gnn-kernels DIR`` it
imports the port from DIR (another checkout's ``src``, to time
two trees' K1-K3 with one method in one call), runs phases 1, 3 and 4,
and prints the card, a ``{"gnn_kernels_of": DIR, "kernels": [...]}`` line
and the last line.  With ``--lm-kernels DIR`` likewise phase 1, K4's
forward on seeded inputs at recurrentgemma-2b's layer shape (window 2048)
and llama3.2-3b's (``LM_KERNEL_SHAPES``), and phase 9 a (K4's backward
rows), to time two trees' K4 in one call, and a
``{"lm_kernels_of": DIR, "kernels": [...]}`` line.  Without a CUDA device,
or outside a checkout of the repository, it prints no result and exits
non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
PCIE_BYTES_S = 64e9       # PCIe Gen5 x16, one direction (PCI-SIG)
BF16_OPS_S = 989e12       # H100 SXM dense bf16 tensor cores (data sheet)
F32_OPS_S = 67e12         # H100 SXM float32 outside the tensor cores
CFG = dict(model="sage", hidden=256, fanouts=(10, 5), request_batch_size=64,
           max_batch_requests=8, mode="helios", device_cache_frac=0.05,
           host_cache_frac=0.10, chaos=None, seed=0)
REQUESTS, RATE = 64, 20_000     # 64-seed requests; open-loop virtual req/s
DATA = os.path.join(ROOT, "build", "smoke_data")    # IG-shaped store
LLM_ARCHS = ("llama3.2-3b", "rwkv6-7b")
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "recurrentgemma-2b", "phi-3-vision-4.2b",
                "whisper-small", "kimi-k2-1t-a32b")
LLM_BATCH, LLM_DECODE, LLM_SEED = 4, 32, 0
# prompt tokens per config, 1024 where not named: recurrentgemma twice its
# window, so the band and the ring buffer both act; whisper's decoder
# prompt beside its 30-second input (1500 encoder frames)
LLM_PROMPT = {"recurrentgemma-2b": 4096, "whisper-small": 64}
WHISPER_FRAMES = 1500
# the one cut: kimi-k2's 61 layers (about 2 TB in bf16) cannot fit on one
# card; one layer at full width is about 19 B parameters, 39 GB
LLM_DEPTH = {"kimi-k2-1t-a32b": 1}
TRAIN_BATCH, TRAIN_FANOUTS = 1024, (25, 10)     # the trainer's defaults
TRAIN_ROW_DIM, TRAIN_HIDDEN = 1024, 256     # IG rows; the trainer's hidden
TRAIN_N_PAD = TRAIN_BATCH * (1 + 25 + 25 * 10)      # 282,624 rows per batch
TRAIN_WARM, TRAIN_COUNTED = 2, 8
SCALE_WORKERS, SCALE_SHARDS = 4, 4
SCALE_KILL = {2: 1}     # FailureInjector: at gather 2 (0-based) kill worker 1
FLEET_REPLICAS, FLEET_WRITE_ROWS = 3, 1024
SCALE_ROOT = os.path.join(ROOT, "build", "smoke_scale_out")
# phase 9 (lm_train): llama3.2-3b at train_4k's sequence length, 2
# microbatches of 1 sequence (the one cut: the global batch, 256 -> 2)
LM_TRAIN_ARCH, LM_TRAIN_SEQ, LM_TRAIN_MB, LM_TRAIN_N_MB = (
    "llama3.2-3b", 4096, 1, 2)
LM_TRAIN_COUNTED = 3
# phase 9 d: recurrentgemma-2b, the same tokens and cut; its 8 local
# attention layers (window 2048) run K4's hd-256 backward
LM_TRAIN_HYBRID, LM_TRAIN_HYBRID_COUNTED = "recurrentgemma-2b", 2
# a llama-class peak learning rate with a 100-step warm-up: at the
# launcher's 1e-3 over 10, the first AdamW steps (about +-lr on every
# entry) of the random 3.6 B model raise its loss
LM_TRAIN_LR = (3e-4, 100, 1000)
LM_TRAIN_DATA = os.path.join(ROOT, "build", "smoke_tokens")
LM_TRAIN_FAMILIES = ("llama3.2-3b", "qwen2-moe-a2.7b", "recurrentgemma-2b",
                     "phi-3-vision-4.2b", "whisper-small")
# K4's forward on seeded bf16 inputs with ``--lm-kernels`` (the same inputs
# for any tree): (label, B, S, T, H, K, hd, causal, window), the prefill
# layer shapes of recurrentgemma-2b (MQA, window 2048) and llama3.2-3b
LM_KERNEL_SHAPES = (
    ("recurrentgemma-2b layer 2, window 2048", 4, 4096, 4096, 10, 1, 256,
     True, 2048),
    ("llama3.2-3b layer 0", 4, 1024, 1024, 24, 8, 128, True, 0))
# the kernel that must build with no spill (phase 1): K4's hd-256 forward
NO_SPILL = ("flash_attention", "flash_fwd_tc_kernelILi256E")
# K4's backward at the training shapes: (label, B, S, T, H, K, hd, causal,
# window); the first is llama3.2-3b's layer at train_4k
K4_BWD_SHAPES = (
    ("llama3.2-3b layer 0, train_4k", 1, 4096, 4096, 24, 8, 128, True, 0),
    ("whisper-small cross-attention", 2, 64, 1500, 12, 12, 64, False, 0),
    ("recurrentgemma-2b window 2048", 1, 4096, 4096, 10, 1, 256, True,
     2048),
    ("ragged small, hd 8", 3, 37, 53, 6, 2, 8, True, 0))
# K4's backward against the plain version's, entry by entry
# (``k4_bwd_check``): |got - want| <= rtol |want| + atol mean|want| + FLOOR
# for each of dq, dk, dv, as (rtol, (atol of dq, dk, dv)).  bf16: rtol two
# bf16 steps at the bottom of a binade (the two sides' roundings of a
# float32 gradient are at most one step apart, and the kernel's float32
# value moves with delta: at one step the llama shape read 0.88 of the
# bound); dq and dk carry delta = rowsum(dO * O) from the forward's bf16
# O, which the plain version computes in float32 (``atol_reading`` up to
# 0.128 of the mean on an H100 at the shapes below), dv does not (1e-5).
# float32: summation order only (up to 2.2e-4).  FLOOR: where every query
# sees one key the exact dq and dk are 0 and the kernel gives rounding
# noise (a few 1e-6).
K4_BWD_TOL = {"float32": (1e-5, (1e-3, 1e-3, 1e-3)),
              "bfloat16": (2 ** -6, (2 ** -2, 2 ** -2, 2 ** -8))}
K4_BWD_FLOOR = 1e-4
# and the largest |got - want| within this share of the largest |want|
# (or of 1, where that is smaller)
K4_BWD_LARGEST = {"float32": 1e-4, "bfloat16": 2e-2}
K4_BWD_TILE = 64               # the planted fault: one key tile zeroed
# K4's forward against its plain version, entry by entry (``k4_fwd_check``):
# |got - want| <= rtol |want| + atol m + FLOOR, m the mean |want| of the
# entry's own output row (one query and head): a row is a weighted mean of
# V's rows, so its rounding noise scales with it, whether it sees 2 keys
# or 2048.  bf16: both sides round a float32 output to bf16, one step
# apart at most (2^-7 of |want|; rtol allows two), and the kernel's P,
# rounded to bf16 before P.V, moves an output by about 2^-9 / sqrt(3) of
# sqrt(sum p^2 v^2), near 1.4e-3 of m (atol 2^-5 is about twenty times
# that).  float32: summation order only.  FLOOR: a query that sees no key
# gets zeros on both sides.  The planted faults drop one tile of keys;
# LARGEST is the bound of earlier slices on the largest error alone (2^-6:
# one bf16 step of an output in [2, 4)), kept beside.
K4_FWD_TOL = {"float32": (1e-5, 1e-3), "bfloat16": (2 ** -6, 2 ** -5)}
K4_FWD_FLOOR = 1e-6
K4_FWD_LARGEST = {"float32": 1e-4, "bfloat16": 2 ** -6}
K4_FWD_TILE = 64
# phase 9 c's gate, K4 path against the plain attention, relative: the
# loss, the whole model's gradient norm, and the norm of the q, k and v
# projections' gradients (each over every layer).  Read on an H100 in two
# runs (dq's atomics add in any order): the loss 2.5e-5 in both, the
# gradient norm 1.1e-4 and 7.6e-5, the projections at most 2.2e-4 and
# 3.0e-4; with K4's backward zeroed, the same loss (a forward reading),
# 0.64 and 1.
LM_TRAIN_GATE = {"loss": 2e-4, "grad_norm": 2e-3, "attn.wq": 2e-3,
                 "attn.wk": 2e-3, "attn.wv": 2e-3}
TRAIN_SMALL = dict(vertices=20_000, row_dim=128, batches=3,
                   mode="helios-nopipe", batch_size=256, fanouts=(10, 5),
                   hidden=64, train_embeddings=True, embedding_momentum=0.9,
                   embedding_adam=0.99, chaos=None, seed=0)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_ms(prof) -> float:
    """Device milliseconds of every kernel and copy a profile recorded."""
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def device_events(prof):
    """The profile's device operations (kernels, copies, fills) in the
    order they started."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def per_launch(both, alone, reps):
    """[(name, ms per call)] of each device operation of one call, in
    launch order: the profile of ``reps`` calls each after the zeroing,
    less the operations the zeroing alone shows; None where the rest does
    not split into ``reps`` equal calls."""
    scrub = {e.name for e in device_events(alone)}
    if not scrub:
        return None
    evs = [e for e in device_events(both) if e.name not in scrub]
    k = len(evs) // reps
    if not k or k * reps != len(evs):
        return None
    return [(evs[j].name[:70], sum(evs[j + k * r].time_range.elapsed_us()
                                   for r in range(reps)) / reps / 1e3)
            for j in range(k)]


def timed(fn, reps=20, warm=3):
    """Milliseconds per call of ``fn`` with the L2 cache cold, after
    ``warm`` calls: ``(device, events)``.  Before every call a 128 MiB
    buffer is zeroed, which evicts the card's 50 MB L2, so repeated calls
    on one input cannot run from L2.  ``events`` brackets each call with
    two CUDA events (launch gaps the host leaves count); ``device`` is the
    call's kernels' and copies' own time from the profiler (CUPTI), less
    the zeroing, or None where the profiler records no device time or the
    subtraction leaves none (the zeroing's run alone varies: a call of a
    few microseconds has read below zero).
    Returns ``(device, events, per_launch)``, the last the call's device
    time per launch (``per_launch``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        scrub.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    event_ms = sum(a.elapsed_time(b) for a, b in ev) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as both:
        for _ in range(reps):
            scrub.zero_()
            fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as alone:
        for _ in range(reps):
            scrub.zero_()
        torch.cuda.synchronize()
    dev = (device_ms(both) - device_ms(alone)) / reps
    return ((dev if device_ms(alone) > 0 and dev > 0 else None), event_ms,
            per_launch(both, alone, reps))


def timing(kernel, plain, library=None) -> dict:
    """The kernel line's time fields: device time where the profiler has
    it for the kernel, its plain version and the library call alike, else
    the event time of all three (``timed_by`` says which: the profiler
    drops a call's device time now and then, and one row never mixes the
    two), the event time of the kernel beside it, and the kernel's device
    time per launch."""
    k_dev, k_ev, split = timed(kernel)
    p_dev, p_ev, _ = timed(plain, reps=5)
    l_dev, l_ev, _ = timed(library) if library is not None else (None,) * 3
    by_device = k_dev is not None and p_dev is not None and (
        library is None or l_dev is not None)
    return dict(ms=k_dev if by_device else k_ev,
                plain_ms=p_dev if by_device else p_ev,
                library_ms=(None if library is None
                            else l_dev if by_device else l_ev),
                timed_by="profiler" if by_device else "events",
                event_ms=k_ev, per_launch_ms=split)


def k3_route(s_ops, fn):
    """The route one call of ``fn`` takes through K3 (None for a K3
    without routes)."""
    counts = getattr(s_ops, "route_launches", None)
    if counts is None:
        return None
    before = dict(counts)
    fn()
    return next((r for r, n in counts.items() if n != before[r]), None)


def k2_entry(torch, g_ops, g_ref, rows, idx):
    """K2 on (rows, idx): bit-exact against its plain version, timed beside
    it, ``index_select`` and the bytes bound: the indices and the output
    once, and each distinct row the indices name once."""
    if not torch.equal(g_ops.gather_rows(rows, idx),
                       g_ref.gather_rows_ref(rows, idx)):
        raise AssertionError(f"K2 differs on {tuple(rows.shape)}")
    rb = rows.shape[1] * rows.element_size()
    n = idx.shape[0]
    # bound_ms reads each row the indices name once (the kernel loads a
    # repeated row once per pair of equal indices at best); the earlier
    # slices' figure, a row read for every index, stays beside it
    n_read = int(torch.unique(idx[(idx >= 0) & (idx < rows.shape[0])]).numel())
    return dict(**timing(lambda: g_ops.gather_rows(rows, idx),
                         lambda: g_ref.gather_rows_ref(rows, idx),
                         lambda: torch.index_select(rows, 0, idx)),
                bound_ms=(n * (idx.element_size() + rb)
                          + n_read * rb) / HBM_BYTES_S * 1e3,
                bound_every_index_ms=n * (8 + 2 * rb) / HBM_BYTES_S * 1e3,
                bound_by="bytes",
                shape=f"table={tuple(rows.shape)} {rows.dtype} idx={n} "
                      f"distinct={n_read}")


def k3_entry(torch, s_ops, msgs, dst, n_seg, label):
    """K3 on (msgs, dst, n_seg) within 1e-5 of the largest sum of its plain
    version, timed beside it, ``index_add_`` and the bytes bound; ``label``
    names the input in ``shape``."""
    from repro_torch.kernels.segment_agg import ref as s_ref
    got = s_ops.segment_sum(msgs, dst, n_seg)
    torch.cuda.synchronize()
    want = s_ref.segment_sum_ref(msgs, dst, n_seg)
    err = float((got - want).abs().max())
    if err > 1e-5 * max(float(want.abs().max()), 1.0):
        raise AssertionError(f"K3 differs by {err} on {label}")
    del got, want
    E, D = msgs.shape
    valid = (dst >= 0) & (dst < n_seg)

    def library():
        out = torch.zeros(n_seg, D, device=msgs.device)
        return out.index_add_(0, dst[valid], msgs[valid].float())
    return dict(max_abs_err=err,
                kernel_route=k3_route(
                    s_ops, lambda: s_ops.segment_sum(msgs, dst, n_seg)),
                **timing(lambda: s_ops.segment_sum(msgs, dst, n_seg),
                         lambda: s_ref.segment_sum_ref(msgs, dst, n_seg),
                         library),
                bound_ms=(E * D * msgs.element_size() + E * dst.element_size()
                          + n_seg * D * 4) / HBM_BYTES_S * 1e3,
                bound_by="bytes",
                shape=f"{label}: E={E} D={D} {msgs.dtype} "
                      f"n_segments={n_seg}")


def k1_entry(torch, g_ops, l_ops, l_ref, lk_args, dt, ht, tiers, label):
    """K1 on (ids, loc, slot) against the tiers (dt, ht), bit-exact
    against its plain version, timed beside it, with its bound (HBM bytes
    and the host-tier rows over PCIe, whichever takes longer; ``tiers``
    are the ids' tiers, host numpy) and the read rate of one plain UVA copy
    of the same host-tier rows (K2's kernel called on the pinned tier's
    device pointer, outside the port's wrappers)."""
    got = l_ops.fused_cache_lookup(*lk_args, dt, ht)
    torch.cuda.synchronize()
    want = l_ref.fused_lookup_ref(*lk_args, dt, ht)
    for k, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            raise AssertionError(f"K1 output {k} differs on {label}")
    del got, want
    B = lk_args[0].shape[0]
    rb = dt.shape[1] * dt.element_size()
    n_dev, n_host = int((tiers == 0).sum()), int((tiers == 1).sum())
    hbm = B * (lk_args[0].element_size() + 8 + rb + 5 * 4) + n_dev * rb
    pcie = n_host * rb
    entry = dict(
        **timing(lambda: l_ops.fused_cache_lookup(*lk_args, dt, ht),
                 lambda: l_ref.fused_lookup_ref(*lk_args, dt, ht)),
        bound_ms=max(hbm / HBM_BYTES_S, pcie / PCIE_BYTES_S) * 1e3,
        bound_by="bytes",
        shape=f"{label}: B={B} D={dt.shape[1]} dev_hits={n_dev} "
              f"host_hits={n_host}")
    if n_host:
        entry["pcie_probe"] = pcie_probe(torch, g_ops, l_ops, lk_args, ht,
                                         tiers == 1)
    return entry


def pcie_probe(torch, g_ops, l_ops, lk_args, ht, host_mask):
    """One plain UVA copy of the host-tier rows a lookup reads: K2's
    kernel (a warp per pair of rows, all loads before any store) called
    through its C entry point on the pinned tier's device pointer.  Its
    device time and the PCIe read rate it reaches, beside 64 GB/s."""
    import ctypes
    from repro_torch.kernels import build
    ids, _, slot = lk_args
    idx = slot[ids.long()][torch.from_numpy(host_mask).to(ids.device)].long()
    n, rb = idx.shape[0], ht.shape[1] * ht.element_size()
    out = torch.empty(n, ht.shape[1], dtype=ht.dtype, device=ids.device)
    lib, lk = g_ops._lib(), l_ops._lib()
    ptr = ctypes.c_void_p()
    build.check(lk, lk.helios_host_device_ptr(ht.data_ptr(),
                                              ctypes.byref(ptr)), "pcie")
    stream = torch.cuda.current_stream().cuda_stream

    def copy():
        build.check(lib, lib.helios_gather_rows(
            ptr.value, idx.data_ptr(), 1, out.data_ptr(), n, ht.shape[0], rb,
            stream), "pcie probe")
    copy()
    torch.cuda.synchronize()
    if not torch.equal(out.cpu(), ht[idx.cpu()]):
        raise AssertionError("the PCIe probe copied other rows")
    dev_ms, ev_ms, _ = timed(copy)
    ms = dev_ms if dev_ms is not None else ev_ms
    return dict(rows=n, bytes=n * rb, ms=ms, event_ms=ev_ms,
                gb_s=n * rb / ms / 1e6, bound_gb_s=PCIE_BYTES_S / 1e9)


def training_rows(torch, dev, g, cache, g_ops, s_ops, l_ops, l_ref):
    """K1 and K3 on a training-shaped minibatch: 1024 seeds drawn with
    ``draw_unique`` and sampled at fanouts (25, 10).  K1 on its unique
    nodes against the cache's tiers; K3 on the hop-2 block (the first
    layer applied) with messages gathered from a seeded random (N_pad,
    row_dim) f32 feature block and masked as the model masks them, and at
    D = 1 on the block's edge counts."""
    import numpy as np
    from repro_torch.core.rng import draw_unique
    from repro_torch.gnn.sampling import NeighborSampler
    seeds = draw_unique(np.random.default_rng(0), g.n_vertices, TRAIN_BATCH)
    mb = NeighborSampler(g, TRAIN_FANOUTS, seed=0).sample(seeds)
    nodes = mb.all_nodes
    with cache._table_lock:
        tiers = cache.loc[nodes]
        lk_args = (torch.from_numpy(nodes.astype("int32")).to(dev),
                   cache._loc_dev, cache._slot_dev)
        dt, ht = cache.device_tier, cache.host_tier
    k1 = k1_entry(torch, g_ops, l_ops, l_ref, lk_args, dt, ht, tiers,
                  f"training mb.all_nodes, batch {TRAIN_BATCH} fanouts "
                  f"{TRAIN_FANOUTS}")
    blk = mb.blocks[-1]
    n_pad = mb.nodes.shape[0]
    feats = torch.randn(n_pad, dt.shape[1], device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    src = torch.from_numpy(blk.src_pos).to(dev)
    dst = torch.from_numpy(blk.dst_pos).to(dev)
    w = torch.from_numpy(blk.edge_mask).to(dev).to(torch.float32)
    msgs = g_ops.gather_rows(feats, src) * w[:, None]
    del feats
    label = (f"training hop-2 block, {int(blk.edge_mask.sum())} of "
             f"{len(blk.edge_mask)} edges real")
    k3 = k3_entry(torch, s_ops, msgs, dst, n_pad, label)
    del msgs
    torch.cuda.empty_cache()
    k3c = k3_entry(torch, s_ops, w[:, None].contiguous(), dst, n_pad,
                   label + ", counts")
    return k1, k3, k3c, nodes


def phase_edges(torch, dev, ops, refs):
    """K1-K3 against their plain versions at the edge cases."""
    g_ops, s_ops, l_ops = ops
    g_ref, s_ref, l_ref = refs
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.tensor([], dtype=dtype).element_size()
        # K2 at row widths of 4, 12, 1020, 1024 and 4112 bytes, B = 0 to
        # 65,537, int32 and int64 indices, random and sorted with repeats
        # (pairs of equal indices load their row once), and indices
        # outside the table (zero rows)
        for row_bytes in (4, 12, 1020, 1024, 4112):
            n, d = 3000, row_bytes // size
            table = torch.randn(n, d, generator=gen).to(dtype).to(dev)
            for b in (0, 1, 7, 640, 3904, 65537):
                rand = torch.randint(-2, n + 2, (b,), generator=gen).to(dev)
                for idx in (rand, torch.sort(rand // 3).values):
                    ok = (idx >= 0) & (idx < n)
                    want = torch.zeros(b, d, dtype=dtype, device=dev)
                    want[ok] = table[idx[ok]]
                    for ix in (idx, idx.to(torch.int32)):
                        got = g_ops.gather_rows(table, ix)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"K2 differs at {(row_bytes, b, dtype)}")
        # a view 4 bytes off a 16-byte boundary
        table = torch.randn(3000 * 256 + 1, generator=gen).to(dev)[1:].view(
            3000, 256)
        idx = torch.randint(0, 3000, (3904,), generator=gen).to(dev)
        if not torch.equal(g_ops.gather_rows(table, idx),
                           g_ref.gather_rows_ref(table, idx)):
            raise AssertionError("K2 misreads a misaligned view")
        for e, d, s in ((37, 1, 5), (100, 33, 8), (640, 256, 16)):
            msgs = torch.randn(e, d, generator=gen).to(dtype).to(dev)
            seg = torch.randint(-2, s + 3, (e,), generator=gen).to(dev)
            got = s_ops.segment_sum(msgs, seg, s)
            torch.cuda.synchronize()
            want = s_ref.segment_sum_ref(msgs, seg, s)
            if (got - want).abs().max() > 1e-5 * max(want.abs().max(), 1.0):
                raise AssertionError(f"K3 differs at {(e, d, s, dtype)}")
    for B, n, dup, n_dev, n_host in ((1, 64, False, 10, 10),
                                     (600, 500, True, 40, 60),
                                     (300, 256, True, 0, 0),
                                     (257, 4000, False, 0, 100)):
        loc = torch.randint(0, 4, (n,), generator=gen, dtype=torch.int32)
        if not n_dev:
            loc[loc == 0] = 2
        if not n_host:
            loc[loc == 1] = 3
        slot = torch.zeros(n, dtype=torch.int32)
        for tier, cap in ((0, n_dev), (1, n_host)):
            m = loc == tier
            slot[m] = torch.randint(0, max(cap, 1), (int(m.sum()),),
                                    generator=gen, dtype=torch.int32)
        ids = torch.randint(0, 20 if dup else n, (B,), generator=gen)
        dt = torch.randn(n_dev, 36, generator=gen).to(dev)
        ht = torch.randn(n_host, 36, generator=gen).pin_memory()
        args = (ids.to(dev), loc.to(dev), slot.to(dev))
        got = l_ops.fused_cache_lookup(*args, dt, ht)
        torch.cuda.synchronize()
        want = l_ref.fused_lookup_ref(
            *args, dt if n_dev else torch.zeros(1, 36, device=dev),
            ht if n_host else torch.zeros(1, 36))
        for k, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a, b):
                raise AssertionError(f"K1 output {k} differs at B={B}")
    k3_edges(torch, dev, s_ops, s_ref)
    k1_edges(torch, dev, l_ops, l_ref)


def k3_ids(torch, gen, pattern, E, n_seg):
    """Segment ids of the forms K3 treats apart: one id over every edge
    (the sampler's padding), shuffled runs of 10 or 25 (a hop's dst_pos),
    fully unsorted with ids outside [0, n_seg) (dropped)."""
    if pattern == "one_id":
        return torch.full((E,), 3, dtype=torch.int64)
    if pattern.startswith("runs"):
        f = int(pattern[4:])
        return torch.randperm(n_seg, generator=gen)[:-(-E // f)] \
            .repeat_interleave(f)[:E]
    return torch.randint(-3, n_seg + 3, (E,), generator=gen)


def k3_edges(torch, dev, s_ops, s_ref):
    """K3 within 1e-5 of the largest sum of its plain version on every
    route: D in {1, 3, 4, 255, 256, 1020, 1024}, f32 and bf16, int32 and
    int64 ids, E in {0, 1, 4,096, 65,537} over the id forms of
    ``k3_ids``; each call must take the route its width and type call
    for."""
    gen = torch.Generator().manual_seed(2)
    mgen = torch.Generator(device=dev).manual_seed(2)
    cases = ((4096, "one_id"), (4096, "runs25"), (65537, "runs10"),
             (3000, "unsorted"), (1, "unsorted"), (0, "unsorted"))
    for dtype in (torch.float32, torch.bfloat16):
        vec = 4 if dtype == torch.float32 else 8
        for D in (1, 3, 4, 255, 256, 1020, 1024):
            route = ("edges" if D <= 4 else "vec" if D % vec == 0
                     else "scalar")
            for E, pattern in cases:
                n_seg = max(E // 5, 8)
                seg = k3_ids(torch, gen, pattern, E, n_seg).to(dev)
                msgs = torch.randn(E, D, generator=mgen, device=dev).to(dtype)
                want = s_ref.segment_sum_ref(msgs, seg, n_seg)
                for ix in (seg, seg.to(torch.int32)):
                    before = s_ops.route_launches[route]
                    got = s_ops.segment_sum(msgs, ix, n_seg)
                    torch.cuda.synchronize()
                    case = (f"E={E} {pattern} D={D} {dtype} {ix.dtype}")
                    err = float((got - want).abs().max()) if E else 0.0
                    if err > 1e-5 * max(float(want.abs().max()), 1.0):
                        raise AssertionError(f"K3 differs by {err} at {case}")
                    if E and s_ops.route_launches[route] != before + 1:
                        raise AssertionError(f"K3 did not take the {route} "
                                             f"route at {case}")


def k1_edges(torch, dev, l_ops, l_ref):
    """K1 bit-exact against its plain version at B in {1, 1023, 1024,
    1025, 65,537, 150,000} (one to hundreds of 256-position tiles), on
    mixed tiers with remote and out-of-range ids, all-device, all-host and
    all-miss tables, with random ids and with a pool of 37 ids repeated
    across every tile; int32 and int64 ids in turn.  The dedup table is
    reused from call to call, across sizes."""
    gen = torch.Generator().manual_seed(3)
    n, D, n_dev, n_host = 200_000, 64, 10_000, 20_000
    dt = torch.randn(n_dev, D, generator=gen).to(dev)
    ht = torch.randn(n_host, D, generator=gen).pin_memory()
    turn = 0
    for kind in ("mixed", "all_dev", "all_host", "all_miss"):
        if kind == "mixed":
            loc = torch.multinomial(torch.tensor([0.05, 0.1, 0.6, 0.25]), n,
                                    replacement=True, generator=gen)
        else:
            loc = torch.full((n,), ("all_dev", "all_host",
                                    "all_miss").index(kind))
        loc = loc.to(torch.int32)
        slot = torch.where(loc == 0, torch.randint(0, n_dev, (n,),
                                                   generator=gen),
                           torch.randint(0, n_host, (n,), generator=gen))
        args = (loc.to(dev), slot.to(torch.int32).to(dev))
        for B in (1, 1023, 1024, 1025, 65537, 150_000):
            for pattern in ("random", "pool"):
                ids = torch.randint(0, n, (B,), generator=gen)
                if pattern == "pool":
                    ids = ids[:37][torch.randint(0, min(B, 37), (B,),
                                                 generator=gen)]
                if kind == "mixed" and B > 5:
                    ids[::97] = -1
                    ids[5::101] = n + 3
                turn += 1
                ids = (ids if turn % 2 else ids.to(torch.int32)).to(dev)
                got = l_ops.fused_cache_lookup(ids, *args, dt, ht)
                torch.cuda.synchronize()
                want = l_ref.fused_lookup_ref(ids, *args, dt, ht)
                for k, (a, b) in enumerate(zip(got, want)):
                    if not torch.equal(a, b):
                        raise AssertionError(f"K1 output {k} differs at "
                                             f"B={B} {kind} {pattern}")


def phase_edges_llm(torch, dev, fa_ops, fa_ref, wkv_ops, wkv_ref):
    """K4 and K5 against their plain versions at the edge cases: K4 within
    2e-5 (float32) or 2e-2 (bf16, about two steps at the outputs' size);
    K5, y and final state, within 1e-4 of the largest magnitude (1 where
    that is smaller).  K4 runs
    both routes at their seams, q/k/v always views of one packed qkv
    tensor, and each call must take the route its dtype and width call
    for (bf16 at hd 64-128: tensor cores; float32, and bf16 at hd 32: CUDA
    cores)."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def k4(dtype, tol, S, T, hd, G, causal, q_offset=0, window=0, K=2):
        H = K * G
        qkv = torch.randn(2, max(S, T), H + 2 * K, hd, generator=gen,
                          device=dev).to(dtype)
        q, k, v = qkv[:, :S, :H], qkv[:, :T, H:H + K], qkv[:, :T, H + K:]
        route = ("tensor_cores" if dtype == torch.bfloat16
                 and hd in fa_ops.TENSOR_CORE_HEAD_DIMS else "cuda_cores")
        before = fa_ops.route_launches[route]
        got = fa_ops.flash_attention(q, k, v, causal, q_offset, window)
        torch.cuda.synchronize()
        err = float((got.float() - fa_ref.attention_ref(
            q, k, v, causal, q_offset, window).float()).abs().max())
        case = (f"S={S} T={T} hd={hd} G={G} K={K} causal={causal} "
                f"q_offset={q_offset} window={window} {dtype}")
        if not err <= tol:
            raise AssertionError(f"K4 differs by {err} at {case}")
        if fa_ops.route_launches[route] != before + 1:
            raise AssertionError(f"K4 did not take the {route} route at "
                                 f"{case}")

    for dtype, tol, lengths in ((torch.float32, 2e-5, (1, 24, 129)),
                                (torch.bfloat16, 2e-2, (1, 24, 129, 1000))):
        for S in lengths:
            for hd in (32, 64, 80, 128):
                for G in (1, 3, 8):
                    for causal in (True, False):
                        k4(dtype, tol, S, S, hd, G, causal)
        for hd in (64, 80, 128):
            k4(dtype, tol, 100, 612, hd, 3, True, 512)
    for causal in (True, False):
        k4(torch.bfloat16, 2e-2, 4096, 4096, 128, 8, causal)
    # the LM families' widths (phi-3-vision 96, kimi-k2 112,
    # recurrentgemma 256), local-attention windows and whisper's
    # non-causal ragged S != T
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for hd in (96, 112, 256):
            for S, G in ((1, 1), (129, 10)):
                for causal in (True, False):
                    k4(dtype, tol, S, S, hd, G, causal)
            k4(dtype, tol, 100, 612, hd, 3, True, 512)
        for hd in (64, 128, 256):
            for window in (1, 127, 128, 129):
                for causal in (True, False):
                    k4(dtype, tol, 300, 300, hd, 3, causal, 0, window)
            k4(dtype, tol, 100, 612, hd, 3, True, 512, 64)
        # hd 256's 64-key tiles: windows at a tile's seams, ragged T
        for window in (63, 64, 65):
            for causal in (True, False):
                k4(dtype, tol, 300, 300, 256, 10, causal, 0, window, K=1)
        k4(dtype, tol, 333, 333, 256, 3, True)
        k4(dtype, tol, 37, 611, 256, 1, False, K=4)
        for S, T in ((64, 1500), (1500, 1500), (37, 611)):
            k4(dtype, tol, S, T, 64, 1, False, K=12)
    # recurrentgemma's prefill shape in both dtypes: in float32 a key
    # missed or added at the band's edge (about 1/2048 of an output) shows
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        k4(dtype, tol, 4096, 4096, 256, 10, True, 0, 2048, K=1)
    for N in (8, 16, 32, 64):
        for T in (0, 1, 5, 17, 64, 1000):
            for lw in (-20.0, -6.0, -1e-4, None):     # None: mixed
                for B, H in ((1, 1), (4, 64)):
                    for with_state in (True, False):
                        r, k, v = (torch.randn(B, T, H, N, generator=gen,
                                               device=dev) for _ in range(3))
                        logw = (torch.full((B, T, H, N), lw, device=dev)
                                if lw is not None else torch.clamp(
                                    -torch.exp(2 * torch.randn(
                                        B, T, H, N, generator=gen,
                                        device=dev)), -20, -1e-4))
                        u = torch.randn(H, N, generator=gen, device=dev) * 0.3
                        s0 = (torch.randn(B, H, N, N, generator=gen,
                                          device=dev) if with_state else None)
                        got = wkv_ops.wkv(r, k, v, logw, u, s0)
                        torch.cuda.synchronize()
                        for a, b in zip(got, wkv_ref.wkv_ref(r, k, v, logw,
                                                             u, s0)):
                            if b.numel() == 0:
                                continue
                            err = float((a - b).abs().max())
                            if not err <= 1e-4 * max(float(b.abs().max()),
                                                     1.0):
                                raise AssertionError(
                                    f"K5 differs by {err} at N={N} T={T} "
                                    f"logw={lw} BH={B * H} "
                                    f"state={with_state}")


def top_ops(prof, n=6, per=1):
    """The ``n`` largest device times (ms, over ``per``) by operation
    name, cut to 60 characters; operations whose cut names agree are
    summed (a template's instances share their first 60)."""
    by = {}
    for e in prof.key_averages():
        by[e.key[:60]] = by.get(e.key[:60], 0.0) + \
            e.self_device_time_total / 1e3 / per
    return dict(sorted(by.items(), key=lambda kv: -kv[1])[:n])


def llm_plan(cfg):
    """(batch, prompt, encoder frames) of the LM phase for ``cfg``, and the
    K4 and K5 launches one prefill makes.  K4 runs every prefill attention:
    once per attention layer, three times per whisper decoder layer
    (self and cross) beside once per encoder layer."""
    P = LLM_PROMPT.get(cfg.name, 1024)
    if cfg.enc_dec:
        k4 = cfg.n_enc_layers + 2 * cfg.n_layers
    elif cfg.pattern:
        k4 = sum(1 for i in range(cfg.n_layers)
                 if cfg.pattern[i % len(cfg.pattern)] == "attn")
    else:
        k4 = cfg.n_layers if cfg.block == "attn" else 0
    return (LLM_BATCH, P, WHISPER_FRAMES if cfg.enc_dec else 0,
            {"K4": k4, "K5": cfg.n_layers if cfg.block == "rwkv" else 0})


def k4_uses_for(cfg, n):
    """K4's ``launches_by_use`` after one prefill of ``cfg`` with ``n``
    launches, keyed (causal, window, S == T): whisper's encoder
    self-attention, decoder self-attention and cross-attention apart."""
    if cfg.enc_dec:
        return {(False, 0, True): cfg.n_enc_layers,
                (True, 0, True): cfg.n_layers, (False, 0, False): cfg.n_layers}
    return {(True, cfg.window, True): n} if n else {}


def use_name(use):
    causal, window, square = use
    return (f"{'causal' if causal else 'full'}"
            f"{f' window={window}' if window else ''} "
            f"{'self' if square else 'cross'}")


def k4_routes_for(fa_ops, cfg, n):
    """The routes ``n`` bf16 K4 launches of ``cfg`` take, by head width:
    the tensor cores at ``TENSOR_CORE_HEAD_DIMS`` (64-256: every served
    config, recurrentgemma's 256 too), else the CUDA cores."""
    tc = cfg.head_dim in fa_ops.TENSOR_CORE_HEAD_DIMS
    return {"tensor_cores": n if tc else 0, "cuda_cores": 0 if tc else n}


def run_llm(torch, dev, cfg, counters, reduced=None):
    """Prefill then greedy decode of one model (section 6 of the
    docstring).  Returns (report, {use: (first K4 call's inputs, K4
    launches of that use)} with use K4's ``launches_by_use`` key (causal,
    window, S == T), and the first K5 call's inputs)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import prefill_batch
    from repro_torch.models import attention, lm, rwkv6, steps

    name = cfg.name
    B, P, Te, want = llm_plan(cfg)
    N = LLM_DECODE
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(LLM_SEED)
    params = lm.init_params(gen, cfg, device=dev)
    batch = prefill_batch(cfg, B, P, Te, dev, seed=LLM_SEED + 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    prefill = steps.make_prefill_step(cfg, extra_len=N + 4)
    decode = steps.make_decode_step(cfg)
    # warm-up outside the counted run: kernels loaded, cuBLAS handles made
    _, c = prefill(params, prefill_batch(cfg, B, 64, 64 if Te else 0, dev))
    decode(params, c, torch.zeros((B, 1), dtype=torch.long, device=dev), 64)
    del c
    torch.cuda.synchronize()

    seen = {}

    def k4_recorder(fn):
        """Keeps each use's first inputs; counts nothing (the wrapper
        counts its launches by use)."""
        def call(q, k, v, causal=True, q_offset=0, window=0):
            use = (bool(causal), int(window), q.shape[1] == k.shape[1])
            seen.setdefault(use, (q, k, v, causal, q_offset, window))
            return fn(q, k, v, causal=causal, q_offset=q_offset,
                      window=window)
        return call

    def k5_recorder(fn):
        def call(*a, **kw):
            seen.setdefault("K5", (a, kw))
            return fn(*a, **kw)
        return call
    fa, wk = attention.flash_attention, rwkv6.wkv
    attention.flash_attention = k4_recorder(fa)
    rwkv6.wkv = k5_recorder(wk)
    try:
        for m in counters.values():
            m.launches = 0
        fa_ops = counters["K4"]
        fa_ops.route_launches = dict.fromkeys(fa_ops.ROUTES, 0)
        fa_ops.launches_by_use.clear()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = torch.argmax(logits, -1)[:, None]
        out = [tok]
        for i in range(N):
            logits, cache = decode(params, cache, tok, P + i)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {k: m.launches for k, m in counters.items()}
        k4_routes = dict(fa_ops.route_launches)
        k4_uses = dict(fa_ops.launches_by_use)
    finally:
        attention.flash_attention, rwkv6.wkv = fa, wk
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    # each bf16 K4 launch takes the route its head width calls for
    want_routes = k4_routes_for(fa_ops, cfg, want["K4"])
    if want_routes["cuda_cores"]:
        log(f"[llm] {name}: K4 at head width {cfg.head_dim} runs the "
            f"CUDA-core route, as its width calls for (the tensor-core "
            f"route takes widths {fa_ops.TENSOR_CORE_HEAD_DIMS})")
    if k4_routes != want_routes:
        raise AssertionError(f"{name}: K4 routes {k4_routes}, expected "
                             f"{want_routes}")
    want_uses = k4_uses_for(cfg, want["K4"])
    if k4_uses != want_uses:
        raise AssertionError(f"{name}: K4 launches by use {k4_uses}, "
                             f"expected {want_uses}")
    seen.update({use: (seen[use], n) for use, n in k4_uses.items()})
    tokens = torch.cat(out, dim=1)
    if logits.shape != (B, cfg.vocab) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{name}: logits {tuple(logits.shape)} are "
                             "misshapen or not finite")
    if not bool(((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"{name}: greedy tokens out of range")
    for k, a in lm.flat_cache(cache).items():
        if not bool(torch.isfinite(a.float()).all()):
            raise AssertionError(f"{name}: cache {k} is not finite")

    # the same prefill again, unprofiled: the counted one above is the
    # first at the full prompt, so it also pays for the caching
    # allocator's growth to it
    t_again = time.perf_counter()
    prefill(params, batch)
    torch.cuda.synchronize()
    t_again = time.perf_counter() - t_again
    # one profiled prefill and 4 profiled decode steps: busy share, top ops
    with profile(activities=[ProfilerActivity.CUDA]) as pp:
        ta = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        tb = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as pd:
        tc = time.perf_counter()
        for i in range(4):
            logits, cache = decode(params, cache, tok, P + N + i)
        torch.cuda.synchronize()
        td = time.perf_counter()
    report = {
        "config": name, "params": n_params, "dtype": cfg.dtype,
        "batch": B, "prompt": P, "decode_tokens": N, "init_s": init_s,
        "prefill_ms": (t1 - t0) * 1e3,
        "prefill_ms_again": t_again * 1e3,
        "prefill_tok_s": B * P / (t1 - t0),
        "decode_ms_per_token": (t2 - t1) * 1e3 / N,
        "decode_tok_s": B * N / (t2 - t1),
        "launches": launches, "k4_routes": k4_routes,
        "k4_launches_by_use": {use_name(u): n for u, n in k4_uses.items()},
        "k4_expected": {"launches": want["K4"], "routes": want_routes},
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "prefill_device_busy_share": device_ms(pp) / ((tb - ta) * 1e3),
        "prefill_profiled_ms": (tb - ta) * 1e3,
        "prefill_device_ms": device_ms(pp),
        # K4's kernels (both routes) in the profiled prefill
        "prefill_k4_device_ms": sum(
            e.self_device_time_total for e in pp.key_averages()
            if "flash_fwd" in e.key) / 1e3,
        "decode_device_busy_share": device_ms(pd) / ((td - tc) * 1e3),
        "prefill_device_ms_by_op": top_ops(pp),
        "decode_device_ms_per_token_by_op": top_ops(pd, per=4),
        "sample": tokens[0, :8].tolist()}
    if Te:
        report["encoder_frames"] = Te
    if cfg.window:
        report["window"] = cfg.window
    if reduced:
        report["reduced"] = reduced
    log(f"[llm] {report}")
    del params, cache, logits, prefill, decode, batch
    torch.cuda.empty_cache()
    return report, seen


def k4_fwd_check(fa_ops, call, got, want):
    """K4's forward output ``got`` on ``call`` against the plain version's
    ``want`` (float32), entry by entry: the largest |got - want| / (rtol
    |want| + atol m + ``K4_FWD_FLOOR``), m the mean |want| of the entry's
    output row (``tol_ratio``, within 1), with (rtol, atol) from
    ``K4_FWD_TOL``; ``atol_reading``, the largest (|got - want| - rtol
    |want|) / (m + floor); and ``fault_ratio``, that ratio of the
    kernel's own output on planted faults, each of which must exceed 1:
    V's key tile from the middle key on zeroed and, with a window, the
    band's oldest ``K4_FWD_TILE`` keys dropped (the window that much
    shorter).  ``edge_key_ratio``, the band's one oldest key dropped, is
    read, not held.  The largest outputs belong to the first queries, which
    see few keys, so a bound on the largest error alone would let a lost
    tile deep in a long band pass."""
    q, k, v, causal, q_offset, window = call
    rtol, atol = K4_FWD_TOL[str(q.dtype).removeprefix("torch.")]
    row = want.abs().mean(-1, keepdim=True) + K4_FWD_FLOOR

    def ratio(a):
        return float(((a.float() - want).abs()
                      / (rtol * want.abs() + atol * row)).max())
    T, tile = k.shape[1], K4_FWD_TILE
    lo = (T // 2) // tile * tile
    v_bad = v.clone()
    v_bad[:, lo:lo + tile] = 0
    faults = {f"v keys {lo}:{lo + tile} zeroed": (q, k, v_bad, causal,
                                                  q_offset, window)}
    if window > tile:
        faults[f"window {window - tile}"] = (q, k, v, causal, q_offset,
                                             window - tile)
    out = {"tol_ratio": ratio(got),
           "tolerance": {"rtol": rtol, "atol_of_row_mean": atol,
                         "floor": K4_FWD_FLOOR},
           "atol_reading": float((((got.float() - want).abs()
                                   - rtol * want.abs()) / row).max()),
           "fault_ratio": {name: ratio(fa_ops.flash_attention(*c))
                           for name, c in faults.items()}}
    if window > 1:
        out["edge_key_ratio"] = ratio(fa_ops.flash_attention(
            q, k, v, causal, q_offset, window - 1))
    return out


def k4_entry(torch, F, fa_ops, fa_ref, call, launches, label):
    """K4 on one recorded call's inputs: against its plain version (entry
    by entry, ``k4_fwd_check``, where planted faults must fail; and the
    largest error within ``K4_FWD_LARGEST``), the plain output's largest
    and mean magnitude beside, timed beside it and SDPA (given the boolean
    mask where there is a window), with the bound: the operations on the
    visible pairs over the bf16 peak, or the bytes, whichever is
    larger."""
    q, k, v, causal, q_offset, window = call
    got = fa_ops.flash_attention(q, k, v, causal, q_offset, window)
    torch.cuda.synchronize()
    want = fa_ref.attention_ref(q, k, v, causal, q_offset, window).float()
    err = float((got.float() - want).abs().max())
    ref_max, ref_mean = float(want.abs().max()), float(want.abs().mean())
    check = k4_fwd_check(fa_ops, call, got, want)
    if not (err <= K4_FWD_LARGEST[str(q.dtype).removeprefix("torch.")]
            and check["tol_ratio"] <= 1
            and min(check["fault_ratio"].values()) > 1):
        raise AssertionError(f"K4 differs on the {label} inputs: largest "
                             f"error {err}, {check}")
    del got, want
    B, S, H, hd = q.shape
    T = k.shape[1]
    route = fa_ops.pick_route(q.dtype, hd, [(t.data_ptr(), t.shape,
                                             t.stride()) for t in (q, k, v)])
    mask = fa_ref.visible(S, T, causal, q_offset, window, q.device)
    pairs = int(mask.sum())
    byts = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    ops = 4 * B * H * hd * pairs
    t_b, t_o = byts / HBM_BYTES_S * 1e3, ops / BF16_OPS_S * 1e3
    sd_mask = (None if not window and (not causal or q_offset == 0)
               else mask)

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=sd_mask, is_causal=causal and sd_mask is None,
            enable_gqa=True)
    return dict(
        name="flash_attention", route="cuda", kernel_route=route,
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:64",
        launches=launches, max_abs_err=err, ref_abs_max=ref_max,
        ref_abs_mean=ref_mean, **check,
        **timing(lambda: fa_ops.flash_attention(q, k, v, causal, q_offset,
                                                window),
                 lambda: fa_ref.attention_ref(q, k, v, causal, q_offset,
                                              window),
                 sdpa),
        bound_ms=max(t_b, t_o), bound_by="bytes" if t_b > t_o else
        "operations", visible_pairs=pairs, input=label,
        shape=f"q={tuple(q.shape)} kv={tuple(k.shape)} {q.dtype} "
              f"causal={causal} window={window}")


def k4_fwd_rows(torch, F, fa_ops, fa_ref):
    """K4's forward at ``LM_KERNEL_SHAPES`` on seeded bf16 inputs, the
    same for any tree (``k4_entry``: against the plain version, timed
    beside it and SDPA, with the bound); no launch of a run is counted."""
    rows = []
    for label, B, S, T, H, K, hd, causal, window in LM_KERNEL_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(hd + S)
        q = torch.randn(B, S, H, hd, generator=g, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn(B, T, K, hd, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        rows.append(k4_entry(torch, F, fa_ops, fa_ref,
                             (q, k, v, causal, 0, window), 0,
                             f"{label}, seeded"))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def llm_kernels(torch, F, inputs, report, fa_ops, fa_ref, wkv_ops, wkv_ref):
    """K4 and K5 on the inputs the llm runs gave them, against their plain
    versions, timed, with their bounds: K4 on llama layer 0 (the first
    row, as in earlier slices), then recurrentgemma's first attention
    layer (windowed; beside it the same inputs causal without the window),
    phi-3-vision and kimi-k2 layer 0, whisper's encoder layer 0 and its
    decoder layer 0's cross-attention; K5 on rwkv layer 0."""
    def one(cfg_name, use, label):
        call, launches = inputs[cfg_name][use]
        return k4_entry(torch, F, fa_ops, fa_ref, call, launches,
                        f"{cfg_name} {label}")

    k4 = one("llama3.2-3b", (True, 0, True), "layer 0")
    if k4["kernel_route"] != "tensor_cores":
        raise AssertionError(f"K4 takes the {k4['kernel_route']} route on "
                             "the llama3.2-3b inputs")
    rows = [k4]
    if "recurrentgemma-2b" in inputs:
        rg = one("recurrentgemma-2b", (True, 2048, True),
                 "layer 2 (the first attention layer), window 2048")
        if rg["kernel_route"] != "tensor_cores":
            raise AssertionError(f"K4 takes the {rg['kernel_route']} route "
                                 "on the recurrentgemma-2b inputs")
        q, k, v, _, _, _ = inputs["recurrentgemma-2b"][(True, 2048, True)][0]
        plain = k4_entry(torch, F, fa_ops, fa_ref, (q, k, v, True, 0, 0), 0,
                         "recurrentgemma-2b layer 2 without the window")
        rg["no_window"] = {key: plain[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "visible_pairs", "max_abs_err", "timed_by", "event_ms")}
        # one method for both: device times if both rows have them
        key = ("ms" if rg["timed_by"] == plain["timed_by"] == "profiler"
               else "event_ms")
        if not rg[key] < plain[key]:
            raise AssertionError(
                f"K4 with window 2048 takes {rg[key]} ms, not less than "
                f"the same inputs without it ({plain[key]} ms, {key}): the "
                "tiles below the band are not skipped")
        rows.append(rg)
    for cfg_name, kind, label in (
            ("phi-3-vision-4.2b", (True, 0, True), "layer 0"),
            ("kimi-k2-1t-a32b", (True, 0, True), "layer 0"),
            ("whisper-small", (False, 0, True), "encoder layer 0"),
            ("whisper-small", (False, 0, False),
             "decoder layer 0 cross-attention")):
        if cfg_name in inputs:
            rows.append(one(cfg_name, kind, label))

    (r, kk, vv, logw, u, s0), _ = inputs["rwkv6-7b"]["K5"]
    y, s1 = wkv_ops.wkv(r, kk, vv, logw, u, s0)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip((y, s1), wkv_ref.wkv_ref(r, kk, vv, logw, u, s0)):
        e = float((a - b).abs().max())
        if not e <= 1e-4 * max(float(b.abs().max()), 1.0):
            raise AssertionError(f"K5 differs on the rwkv6-7b inputs: {e}")
        err = max(err, e)
    B, T, H, N = r.shape
    byts = 4 * (5 * r.numel() + u.numel() + 2 * s0.numel())
    ops = 4 * B * T * H * N * N
    t_b, t_o = byts / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
    k5 = dict(
        name="wkv6", route="cuda", source="src/repro_torch/csrc/rwkv_scan.cu",
        replaces="src/repro/kernels/rwkv_scan/rwkv_scan.py:50",
        launches=report["rwkv6-7b"]["launches"]["K5"], max_abs_err=err,
        **timing(lambda: wkv_ops.wkv(r, kk, vv, logw, u, s0),
                 lambda: wkv_ref.wkv_ref(r, kk, vv, logw, u, s0)),
        bound_ms=max(t_b, t_o), bound_by="bytes" if t_b > t_o else
        "operations",
        shape=f"r={tuple(r.shape)} float32 logw in "
              f"[{float(logw.min()):.3g}, {float(logw.max()):.3g}]")
    return rows + [k5]


class RoutingReplay:
    """The MoE router's choices of one run (``mode = "record"``) fed in
    call order to another (``mode = "replay"``) in place of its own, so
    that a bf16 run on the card compares with the CPU's past a top-k
    choice that rounding flips: everything after the router (dispatch,
    capacity drops, the bf16 expert products, combine) is held to the
    CPU's.  ``flips`` counts the replayed run's own choices that differed,
    of ``choices``; the router itself is compared in float32."""

    def __init__(self, moe):
        self.moe, self.own = moe, moe.router_weights
        self.log, self.mode, self.flips, self.choices = [], None, 0, 0

    def __enter__(self):
        self.moe.router_weights = self.route
        return self

    def __exit__(self, *exc):
        self.moe.router_weights = self.own

    def route(self, logits, mcfg, valid):
        topw, topi, aux, z = self.own(logits, mcfg, valid)
        if self.mode == "record":
            self.log.append((topw, topi))
        elif self.mode == "replay":
            w, i = self.log.pop(0)
            self.flips += int((topi.cpu() != i).sum())
            self.choices += i.numel()
            topw, topi = w.to(topw.device), i.to(topi.device)
        return topw, topi, aux, z


def phase_cpu_llm(torch, dev, fa_ops):
    """Prefill and 8 greedy decode steps at .reduced() width on the CPU
    and on the card from the same parameters and inputs, every registered
    family (recurrentgemma at window 8 over a 24-token prompt, so the band
    and the ring buffer act): logits and every cache leaf within 1e-4
    (float32) or 5e-2 of the largest magnitude (bf16) after each step, K4
    launched once per attention.  MoE configs in bf16 run the card on the
    CPU's routing (``RoutingReplay``; its own flips counted).  Returns the
    largest logit difference per (config, dtype), and the MoE configs'
    flips in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prefill_batch
    from repro_torch.models import lm, moe, steps
    errs, flips = {}, {}
    for name in LLM_ARCHS + FAMILY_ARCHS:
        for dtype in ("float32", "bfloat16"):
            kw = {"window": 8} if name == "recurrentgemma-2b" else {}
            cfg = dataclasses.replace(get_config(name).reduced(),
                                      dtype=dtype, **kw)
            cpu, card = (lm.init_params(torch.Generator().manual_seed(7), cfg,
                                        device=d) for d in ("cpu", dev))
            bb, ba = (prefill_batch(cfg, 4, 24, 30, d, seed=8)
                      for d in ("cpu", dev))
            pre = steps.make_prefill_step(cfg, q_chunk=16, extra_len=8)
            dec = steps.make_decode_step(cfg)
            want_k4 = llm_plan(cfg)[3]["K4"]
            replay = cfg.moe is not None and dtype == "bfloat16"
            worst = 0.0
            with RoutingReplay(moe) as routing:
                def both(step_cpu, step_card):
                    routing.mode = "record" if replay else None
                    out_cpu = step_cpu()
                    routing.mode = "replay" if replay else None
                    before = fa_ops.launches
                    out_card = step_card()
                    if routing.log:
                        raise AssertionError(f"{name} {dtype}: "
                                             f"{len(routing.log)} recorded "
                                             "routings not replayed")
                    return out_cpu, out_card, fa_ops.launches - before
                (lb, cb), (la, ca), n = both(lambda: pre(cpu, bb),
                                             lambda: pre(card, ba))
                if n != want_k4:
                    raise AssertionError(f"{name} {dtype}: K4 launched {n} "
                                         f"times in prefill, not {want_k4}")
                for i in range(9):
                    want = lm.flat_cache(cb)
                    for what, a, b in [("logits", la, lb)] + [
                            (k, a, want[k])
                            for k, a in lm.flat_cache(ca).items()]:
                        a, b = a.cpu().float(), b.float()
                        e = float((a - b).abs().max())
                        ok = (torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                              if dtype == "float32"
                              else e <= 5e-2 * float(b.abs().max()))
                        if not ok:
                            raise AssertionError(f"{name} {dtype} step {i} "
                                                 f"{what}: card vs CPU {e}")
                        if what == "logits":
                            worst = max(worst, e)
                    if i == 8:
                        break
                    nxt = torch.argmax(lb, -1)[:, None]
                    (lb, cb), (la, ca), _ = both(
                        lambda: dec(cpu, cb, nxt, 24 + i),
                        lambda: dec(card, ca, nxt.to(dev), 24 + i))
            errs[f"{name}/{dtype}"] = worst
            if replay:
                if not routing.choices:
                    raise AssertionError(f"{name} {dtype}: no routing "
                                         "replayed")
                flips[f"{name}/{dtype}"] = (
                    f"{routing.flips} of {routing.choices} top-k choices")
    log(f"[cpu] reduced LM prefill + decode, card vs CPU, max |logit err| "
        f"{errs}; the card's own MoE routing in bf16 differed from the "
        f"CPU's in {flips or 'none'}")
    return errs, flips


def backward_launches(ops) -> int:
    """The launches a K2 or K3 wrapper module counted for the other's
    backward."""
    return sum(n for use, n in ops.launches_by_use.items()
               if use[0] == "backward")


@contextlib.contextmanager
def capture(g_ops, s_ops):
    """The first inputs of each use of K2 and K3 while the block runs:
    ``_gather`` and ``_segment_sum`` (the forward and backward rules behind
    ``gather_rows`` and ``segment_sum``) are wrapped, and each use's first
    call is kept under (kernel, then the key of the wrappers' own
    ``launches_by_use``).  Counts nothing; yields the dict."""
    seen = {}
    orig = (g_ops._gather, s_ops._segment_sum)

    def wrap(name, fn):
        def call(x, *a, backward=False):
            key = (name, "backward" if backward else "forward",
                   tuple(x.shape), a[0].shape[0])
            seen.setdefault(key, (x, *a))
            return fn(x, *a, backward=backward)
        return call
    g_ops._gather, s_ops._segment_sum = wrap("K2", orig[0]), wrap("K3",
                                                                  orig[1])
    try:
        yield seen
    finally:
        g_ops._gather, s_ops._segment_sum = orig


def k1_wait(torch, run):
    """Run ``run()`` with K1's calls in the cache timed against the card:
    for each call, how far the card's queue lagged the host when K1 was
    enqueued (the time K1 waited behind earlier work on the one stream),
    from a CUDA event recorded just before the call, read against an
    event recorded on an idle card at a known host time; and the device
    time between events recorded just before and after K1's three
    launches (the step's kernels, enqueued by another thread, may fall
    between them).  The lag
    counts from the idle card's event, so it reads high by one
    synchronisation's latency (tens of microseconds)."""
    from repro_torch.core import hetero_cache
    fn, calls = hetero_cache.fused_cache_lookup, []

    def timed_call(*a, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.perf_counter()
        e0.record()
        out = fn(*a, **kw)
        e1.record()
        calls.append((t, e0, e1))
        return out
    torch.cuda.synchronize()
    ref = torch.cuda.Event(enable_timing=True)
    ref.record()
    torch.cuda.synchronize()
    t_ref = time.perf_counter()
    hetero_cache.fused_cache_lookup = timed_call
    try:
        result = run()
    finally:
        hetero_cache.fused_cache_lookup = fn
    torch.cuda.synchronize()
    lag = [ref.elapsed_time(e0) - (t - t_ref) * 1e3 for t, e0, _ in calls]
    dev = [e0.elapsed_time(e1) for _, e0, e1 in calls]
    return result, {"calls": len(calls),
                    "queue_lag_ms": lag, "k1_span_ms": dev,
                    "queue_lag_ms_mean": sum(lag) / max(len(lag), 1),
                    "queue_lag_ms_max": max(lag, default=None)}


def phase_train(torch, dev, g, store, counters):
    """Section 5b of the docstring, part a: OutOfCoreGNNTrainer at its
    defaults on the IG-shaped store (read-only).  A warm-up trainer with
    seed 1 takes TRAIN_WARM batches, so the counted trainer (seed 0) draws
    none of the warm-up's seed sets; the counted one then takes
    TRAIN_COUNTED under the tracer and the profiler.  Returns (report, the
    first counted step's inputs and parameters, the K2/K3 launches by use
    as the wrappers counted them)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.gnn.train import OutOfCoreGNNTrainer, TrainerConfig
    from repro_torch.obs import trace
    g_ops, s_ops, l_ops = counters
    t0 = time.perf_counter()
    with OutOfCoreGNNTrainer(g, store, TrainerConfig(
            mode="helios", chaos=None, seed=1)) as warm:
        warm.train(TRAIN_WARM)
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = OutOfCoreGNNTrainer(g, store, TrainerConfig(mode="helios",
                                                     chaos=None, seed=0))
    build_s = time.perf_counter() - t0
    try:
        step_fn, step_in = tr.step_fn, []

        def step_rec(state, *a):
            if not step_in:
                step_in.append((state["params"], a))
            return step_fn(state, *a)
        tr.step_fn = step_rec
        for m in counters:
            m.launches = 0
        for m in (g_ops, s_ops):
            m.launches_by_use.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        n = TRAIN_COUNTED
        tracer = trace.install()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out, wait = k1_wait(torch, lambda: tr.train(n))
                wall = time.perf_counter() - t0
        finally:
            trace.uninstall()
        counts = {(k,) + use: c for k, m in (("K2", g_ops), ("K3", s_ops))
                  for use, c in m.launches_by_use.items()}
        launches = {"K1": l_ops.launches, "K2": g_ops.launches,
                    "K2_backward": backward_launches(g_ops),
                    "K3": s_ops.launches,
                    "K3_backward": backward_launches(s_ops)}
        tr.step_fn = step_fn
        log_ = tr.metrics_log[-n:]
        report = {
            "config": dataclasses.asdict(tr.cfg),
            "vertices": g.n_vertices, "row_dim": store.row_dim,
            "n_pad": int(tr.sampler._node_pad(tr.cfg.batch_size)),
            "build_s": build_s, "warmup_batches": TRAIN_WARM,
            "warmup_seed": 1, "warmup_s": warm_s, "batches": n,
            "wall_ms_per_batch": wall * 1e3 / n,
            "pipe_wall_ms_per_batch": {
                op: sum(sp.wall_s for sp in tracer.spans
                        if sp.name == f"pipe.{op}") * 1e3 / n
                for op in out["stages"]},
            "device_busy_share": device_ms(prof) / (wall * 1e3),
            "device_ms_per_batch": device_ms(prof) / n,
            "device_ms_per_batch_by_op": top_ops(prof, n=8, per=n),
            "k1_wait": {k: v for k, v in wait.items()
                        if not isinstance(v, list)}
            | {"queue_lag_ms": [round(x, 3) for x in wait["queue_lag_ms"]],
               "k1_span_ms": [round(x, 4) for x in wait["k1_span_ms"]]},
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "loss_first": log_[0]["loss"], "loss_last": log_[-1]["loss"],
            "losses": [m["loss"] for m in log_],
            "virtual_s": out["virtual_s"],
            "virtual_per_batch_s": out["virtual_per_batch_s"],
            # the cache's and engines' counts run from the trainer's start
            "stats_batches": n,
            "cache": out["cache"],
            "io": {k: v for k, v in out["io"].items() if k != "by_class"},
            "launches": launches,
            "launches_by_use": {
                f"{k}/{d}/{'x'.join(map(str, sh))}/idx={i}": c
                for (k, d, sh, i), c in sorted(counts.items())}}
    finally:
        tr.close()
    if launches["K1"] != n:
        raise AssertionError(f"K1 launched {launches['K1']} times in {n} "
                             "training batches, not once per batch")
    if min(launches.values()) < 1 or launches["K2"] <= launches[
            "K2_backward"] or launches["K3"] <= launches["K3_backward"]:
        raise AssertionError(f"a kernel of the training path, forward or "
                             f"backward, never ran: {launches}")
    losses = report["losses"]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    log(f"[train] {report}")
    return report, step_in[0], counts


def phase_train_backward(torch, dev, step, ops, refs):
    """Part b: one step's loss on the first counted minibatch, with
    embedding gradients, once through the kernels (K2/K3 forward and their
    backward rules) and once through the plain versions' own autograd on
    the same card tensors.  Every parameter gradient and dL/dfeats must
    agree within 1e-4 of the largest magnitude of each (K3 sums with
    atomics in another order; the GEMMs then carry that).  Returns the
    largest errors and the kernels' training-shape inputs, recorded in
    the kernel pass."""
    from repro_torch.gnn import models as gm
    from repro_torch.core.tree import tree_leaves, tree_map
    g_ops, s_ops = ops
    g_ref, s_ref = refs
    params, (feats, src, dst, em, labels) = step
    blocks = list(zip(src, dst, em))

    def grads(gather, ssum):
        gm.gather_rows, gm.segment_sum = gather, ssum
        try:
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            f = feats.detach().requires_grad_(True)
            loss, _ = gm.gnn_loss(p, f, blocks, labels, TRAIN_BATCH, "sage")
            out = torch.autograd.grad(loss, tree_leaves(p) + [f])
            torch.cuda.synchronize()
            return float(loss.detach()), out
        finally:
            gm.gather_rows, gm.segment_sum = g_ops.gather_rows, \
                s_ops.segment_sum
    before = (backward_launches(g_ops), backward_launches(s_ops))
    with capture(g_ops, s_ops) as seen:
        loss_k, got = grads(g_ops.gather_rows, s_ops.segment_sum)
    bwd = (backward_launches(g_ops) - before[0],
           backward_launches(s_ops) - before[1])
    if bwd != (2, 2):
        raise AssertionError(f"the kernels' backward launched K2, K3 "
                             f"{bwd} times, not (2, 2)")
    loss_p, want = grads(g_ref.gather_rows_ref, s_ref.segment_sum_ref)
    names = [f"layers/{i}/{k}" for i, lp in enumerate(params["layers"])
             for k in lp] + [f"head/{k}" for k in params["head"]] + [
                 "dL/dfeats"]
    errs = {}
    for name, a, b in zip(names, got, want):
        e = float((a - b).abs().max())
        scale = float(b.abs().max())
        errs[name] = {"max_abs_err": e, "max_abs": scale}
        if not e <= 1e-4 * scale:
            raise AssertionError(f"training backward: {name} differs by {e} "
                                 f"(largest {scale})")
    del got, want
    torch.cuda.empty_cache()
    report = {"loss_kernels": loss_k, "loss_plain": loss_p,
              "tolerance": "1e-4 x largest |grad| of each tensor",
              "grads": errs}
    log(f"[train-backward] {report}")
    return report, seen


def train_kernel_rows(torch, seen, counts, n_batches, g_ops, g_ref, s_ops):
    """Parts b's timings: K2 and K3 at the training shapes, forward and
    as each other's backward, each with its launches per step in the
    counted run (phase a's ``launches_by_use``)."""
    N, D, H = TRAIN_N_PAD, TRAIN_ROW_DIM, TRAIN_HIDDEN
    E1 = TRAIN_BATCH * TRAIN_FANOUTS[0] * TRAIN_FANOUTS[1]   # layer 1
    E2 = TRAIN_BATCH * TRAIN_FANOUTS[0]                      # layer 2
    k2, k3 = {}, {}
    for kernel, rows, label, key in (
            ("K2", k2, "train_forward_layer1", ("forward", (N, D), E1)),
            ("K2", k2, "train_forward_layer2", ("forward", (N, H), E2)),
            ("K2", k2, "train_backward_layer1", ("backward", (N, D), E1)),
            ("K2", k2, "train_backward_layer2", ("backward", (N, H), E2)),
            ("K3", k3, "train_backward_layer1", ("backward", (E1, D), E1)),
            ("K3", k3, "train_backward_layer2", ("backward", (E2, H), E2))):
        key = (kernel,) + key
        if key not in seen:
            raise AssertionError(f"no {key} call was recorded: "
                                 f"{sorted(seen)}")
        entry = (k2_entry(torch, g_ops, g_ref, *seen[key]) if kernel == "K2"
                 else k3_entry(torch, s_ops, *seen[key],
                               f"training {label}: gather backward"))
        # the counted run (phase a) computes no dL/dfeats: its layer-1
        # backward rows launch only under train_embeddings
        rows[label] = dict(launches_per_step=counts.get(key, 0) / n_batches,
                           **entry)
        log(f"[train-kernels] {kernel} {label}: {rows[label]}")
    return k2, k3


def train_small(torch, g, root, where, fault=None):
    """One TRAIN_SMALL run on ``where`` over a fresh writable store under
    ``root``: the sampled node sets, the report, the losses, the final
    parameters (host) and, after the epoch flush, the embedding, momentum
    and Adam stores' rows (host numpy) and the global Adam step.
    ``fault`` names a deliberate error for a control run: "bf16_grads"
    rounds dL/dfeats to bfloat16 before it leaves the step; "no_message_
    grads" detaches the gather's table, which is what the card did before
    K2 and K3 carried a gradient (layer 1's message part of dL/dfeats and
    layer 2's path back to layer 1 are lost)."""
    import numpy as np
    from repro_torch.core.iostack import FeatureStore
    from repro_torch.gnn import models as gm
    from repro_torch.gnn.train import OutOfCoreGNNTrainer, TrainerConfig
    from repro_torch.core.tree import tree_leaves
    cfg = dict(TRAIN_SMALL)
    n_v, row_dim, n_batches = (cfg.pop("vertices"), cfg.pop("row_dim"),
                               cfg.pop("batches"))
    store = FeatureStore(os.path.join(root, f"f_{where}_{fault}"), n_v,
                         row_dim, n_shards=12, create=True, rng_seed=1,
                         writable=True)
    gather = gm.gather_rows
    if fault == "no_message_grads":
        gm.gather_rows = lambda t, i: gather(t.detach(), i)
    try:
        with OutOfCoreGNNTrainer(g, store, TrainerConfig(
                device=str(where), **cfg)) as tr:
            nodes, sample, step = [], tr.sampler.sample, tr.step_fn

            def sample_rec(seeds):
                mb = sample(seeds)
                nodes.append(mb.nodes)
                return mb

            def step_bf16(*a):
                state, m, fgrad = step(*a)
                return state, m, fgrad.to(torch.bfloat16).float()
            tr.sampler.sample = sample_rec
            if fault == "bf16_grads":
                tr.step_fn = step_bf16
            out = tr.train(n_batches)
            return dict(
                out=out, nodes=nodes,
                losses=[m["loss"] for m in tr.metrics_log],
                params=[t.cpu() for t in tree_leaves(tr.state["params"])],
                adam_t=tr.embeddings._t,
                rows=[FeatureStore(store.path + sfx, n_v, row_dim,
                                   n_shards=12).read_rows(np.arange(n_v))
                      for sfx in ("", "_momentum", "_adam")])
    finally:
        gm.gather_rows = gather


def train_small_errors(a, b) -> dict:
    """Run ``a`` against run ``b`` by every value check of part c: the
    largest relative loss error, the largest absolute parameter error, the
    stores' largest absolute errors beside their largest magnitudes, and
    ``rejected_by``: the checks the pair fails (none for a good pair)."""
    import numpy as np
    names = ("embedding", "momentum", "adam")
    r = {"loss_rel_err": max(abs(x - y) / max(abs(y), 1e-12)
                             for x, y in zip(a["losses"], b["losses"])),
         "param_max_abs_err": max(float((x - y).abs().max())
                                  for x, y in zip(a["params"], b["params"])),
         "store_rows_max_abs_err": {n: float(np.abs(x - y).max()) for n, x, y
                                    in zip(names, a["rows"], b["rows"])},
         "store_rows_max_abs": {n: float(np.abs(y).max())
                                for n, y in zip(names, b["rows"])}}
    err, top = r["store_rows_max_abs_err"], r["store_rows_max_abs"]
    r["rejected_by"] = [name for name, ok in (
        ("loss", r["loss_rel_err"] <= 1e-4),
        ("params", r["param_max_abs_err"] <= 1e-4),
        ("embedding", err["embedding"] <= 1e-3),
        ("momentum", err["momentum"] <= 1e-4 * top["momentum"]),
        ("adam", err["adam"] <= 1e-4 * top["adam"])) if not ok]
    return r


def near_eps(a, b) -> dict:
    """Where the card's and the CPU's embedding rows differ by more than
    1e-5: how many elements, and for them the Adam denominator's root
    (sqrt(m2 / (1 - b2^t)), the scale of the element's gradient) and the
    momentum on both devices, beside the same over every element the
    training touched.  The sparse Adam step is lr * m / (that root + eps):
    where the root is near eps (1e-8) or below, a gradient's absolute
    error is multiplied by about lr / eps = 5e6 in the update."""
    import numpy as np
    b2 = TRAIN_SMALL["embedding_adam"]
    diff = np.abs(a["rows"][0] - b["rows"][0])
    over = diff > 1e-5

    def root(run):
        return np.sqrt(run["rows"][2] / (1.0 - b2 ** run["adam_t"]))

    def stats(x):
        return ({"min": float(x.min()), "median": float(np.median(x)),
                 "max": float(x.max())} if x.size else None)
    touched = b["rows"][2] > 0
    return {"elements_over_1e-5": int(over.sum()),
            "largest_err": float(diff.max()),
            "adam_root_card": stats(root(a)[over]),
            "adam_root_cpu": stats(root(b)[over]),
            "abs_momentum_card": stats(np.abs(a["rows"][1][over])),
            "abs_momentum_cpu": stats(np.abs(b["rows"][1][over])),
            "adam_root_cpu_touched": stats(root(b)[touched]),
            "eps": 1e-8}


def phase_train_cpu(torch, dev):
    """Part c: the trainer on the card against itself on the CPU at a
    reduced size (TRAIN_SMALL) in helios-nopipe with trainable embeddings
    (momentum 0.9, sparse Adam 0.99) over writable stores made alike:
    sampled batches, cache/IO/write-back stats and virtual_s identical;
    losses within 1e-4 relative and the final parameters within 1e-4
    absolute (K3's atomics and cuBLAS sum in other orders than the CPU).
    After the epoch flush the momentum and Adam stores agree within 1e-4
    of their largest magnitude, and the embedding rows within 1e-3
    absolute (2% of one step's embedding_lr, 0.05): the sparse Adam step
    multiplies a gradient element's absolute error by up to lr / eps where
    its root second moment is near eps, which ``near_eps`` shows for the
    elements that differ.  Two faulted card runs are controls, each of
    which the checks must reject: dL/dfeats rounded to bf16, and the
    gather's gradient cut as it was before the repair."""
    import tempfile
    import numpy as np
    from repro_torch.gnn.graph import synth_graph
    g = synth_graph(TRAIN_SMALL["vertices"], 10, skew=1.2, seed=0)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        a, b = (train_small(torch, g, d, w) for w in (dev, "cpu"))
        controls = {f: train_small(torch, g, d, dev, f)
                    for f in ("bf16_grads", "no_message_grads")}
    for x, y in zip(a["nodes"], b["nodes"]):
        if not np.array_equal(x, y):
            raise AssertionError("the card sampled other batches than the "
                                 "CPU")
    for k in ("cache", "io", "writeback", "virtual_s"):
        if a["out"][k] != b["out"][k]:
            raise AssertionError(f"train {k} differs between card and CPU: "
                                 f"{a['out'][k]} vs {b['out'][k]}")
    errs = train_small_errors(a, b)
    report = {"config": TRAIN_SMALL, "batches": len(a["nodes"]), **errs,
              "near_eps": near_eps(a, b),
              "controls": {f: train_small_errors(c, b)
                           for f, c in controls.items()},
              "losses_card": a["losses"], "losses_cpu": b["losses"],
              "virtual_s": a["out"]["virtual_s"],
              "identical": ["sampled nodes", "cache", "io", "writeback",
                            "virtual_s"]}
    log(f"[train-cpu] {report}")
    if errs["rejected_by"]:
        raise AssertionError(f"training card vs CPU fails the "
                             f"{errs['rejected_by']} checks: {errs}")
    for f, c in report["controls"].items():
        if not c["rejected_by"]:
            raise AssertionError(f"the card vs CPU checks pass the faulted "
                                 f"control {f}: {c}")
    return report


def sync(dev):
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize()


def busy(dev, fn):
    """``fn()`` under the profiler: its result, wall seconds (to a
    synchronise) and the device milliseconds the profiler recorded."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        wall = time.perf_counter() - t0
    return out, wall, device_ms(prof)


def span_ms(tr, prefix: str, n: int) -> dict:
    """Wall ms per unit (``n`` units) of each traced span under
    ``prefix``."""
    out = {}
    for sp in tr.spans:
        if sp.name.startswith(prefix):
            key = sp.name[len(prefix):]
            out[key] = out.get(key, 0.0) + sp.wall_s * 1e3 / n
    return out


def partitioned_copy(store, root):
    """The store's own rows, copied in chunks into a PartitionedFeatureStore
    of SCALE_WORKERS hash-owned workers (SCALE_SHARDS shards each), then
    reopened read-only: content bit-identical to the single store."""
    import numpy as np
    from repro_torch.distributed.partition import (PartitionedFeatureStore,
                                                   make_partition)
    part = make_partition("hash", store.n_rows, SCALE_WORKERS)
    kw = dict(dtype=store.dtype, n_shards=SCALE_SHARDS)
    ps = PartitionedFeatureStore(root, store.n_rows, store.row_dim, part,
                                 create=True, writable=True, **kw)
    for w, rows in enumerate(ps.worker_rows):
        for i in range(0, len(rows), 1 << 15):
            j = min(len(rows), i + (1 << 15))
            ps.stores[w].write_rows(np.arange(i, j),
                                    store.read_rows(rows[i:j]), dedupe=False)
    ps.flush()
    return PartitionedFeatureStore(root, store.n_rows, store.row_dim, part,
                                   **kw)


def remote_tier(torch, dev, store, pstore, scores, trace_ids, ops, refs):
    """Part a (and d): a cache on the card over RemoteIOEngine(me=0) replays
    the trace under the tracer and the profiler; a single-store card cache
    and a CPU cache over the same partitioned store (its own engine) replay
    it too.  Then K1 timed on the first gather's ids against this cache's
    tables."""
    from repro_torch.core.hetero_cache import HeteroCache, tier_rows
    from repro_torch.core.iostack import make_engine
    from repro_torch.distributed.remote_engine import RemoteIOEngine
    from repro_torch.obs import trace
    g_ops, s_ops, l_ops = ops
    g_ref, _, l_ref = refs
    dev_rows, host_rows = tier_rows("helios", store.n_rows,
                                    CFG["device_cache_frac"],
                                    CFG["host_cache_frac"])
    engines = [RemoteIOEngine(pstore, me=0, chaos=None) for _ in range(2)]
    engines.append(make_engine("helios", store, chaos=None))
    caches = [HeteroCache(pstore, scores, dev_rows, host_rows, engines[0],
                          device=dev),
              HeteroCache(pstore, scores, dev_rows, host_rows, engines[1],
                          device="cpu"),
              HeteroCache(store, scores, dev_rows, host_rows, engines[2],
                          device=dev)]
    card, cpu, single = caches
    try:
        if (card._base_loc == 3).sum() == 0:
            raise AssertionError("no row sits at base tier 3")
        listed = []

        def replay():
            out = []
            for ids in trace_ids:
                pg = card.submit_planned(ids)
                listed.append(len(pg.plan[3][0]))  # K1's counts[1]
                out.append(card.complete_planned(pg))
            return out
        for m in ops:
            m.launches = 0
        tr = trace.install()
        rows, wall, dev_ms = busy(dev, replay)
        trace.uninstall()
        # K2 runs here only where a gather holds repeated missed ids, K3
        # not at all: the fleet (part c) runs the model
        launches = {"K1": l_ops.launches, "K2": g_ops.launches,
                    "K3": s_ops.launches}
        if launches["K1"] != len(trace_ids) or not sum(listed):
            raise AssertionError(f"K1 launched {launches['K1']} times for "
                                 f"{len(trace_ids)} gathers, remote lists "
                                 f"{listed}")
        # the same trace through the single store's striped engine, timed
        # alike (no profiler) to set the remote engine's time beside it
        t0 = time.perf_counter()
        single_rows = [single.gather(ids) for ids in trace_ids]
        sync(dev)
        single_wall = time.perf_counter() - t0
        for ids, got, one in zip(trace_ids, rows, single_rows):
            want = torch.from_numpy(store.read_rows(ids))
            if not (torch.equal(got.cpu(), want) and torch.equal(got, one)
                    and torch.equal(cpu.gather(ids), want)):
                raise AssertionError("a remote-tier gather differs from the "
                                     "single store or the CPU")
        st, st_cpu = card.stats()._values(), cpu.stats()._values()
        st.pop("wall_s"), st_cpu.pop("wall_s")
        if st != st_cpu:
            raise AssertionError(f"remote-tier CacheStats differ from the "
                                 f"CPU's: {st} / {st_cpu}")
        counters = [(e.local_rows, e.remote_rows, e.rerouted_rows)
                    for e in engines[:2]]
        if counters[0] != counters[1] or counters[0][2]:
            raise AssertionError(f"engine counters differ: {counters}")
        if not st["remote_hits"] or not st["virtual_remote_s"]:
            raise AssertionError("the remote tier served no row")
        out = {"gathers": len(trace_ids),
               "ids_per_gather": [len(i) for i in trace_ids],
               "wall_ms_per_gather": wall * 1e3 / len(trace_ids),
               "traced_ms_per_gather": span_ms(tr, "cache.gather.",
                                               len(trace_ids)),
               "device_busy_share": dev_ms / (wall * 1e3) if dev_ms
               else None,
               "single_store_wall_ms_per_gather":
                   single_wall * 1e3 / len(trace_ids),
               "k1_remote_listed": listed,
               "launches": launches,
               "local_rows": counters[0][0], "remote_rows": counters[0][1],
               **{k: st[k] for k in ("device_hits", "host_hits",
                                     "storage_misses", "remote_hits",
                                     "virtual_storage_s",
                                     "virtual_remote_s")}}
        # part d: K1 on the first gather's ids against this cache's tables
        with card._table_lock:
            ids = trace_ids[0]
            tiers = card.loc[ids]
            lk_args = (torch.from_numpy(ids.astype("int32")).to(dev),
                       card._loc_dev, card._slot_dev)
            dt, ht = card.device_tier, card.host_tier
        k1 = k1_entry(torch, g_ops, l_ops, l_ref, lk_args, dt, ht, tiers,
                      f"remote tier (me=0 of {SCALE_WORKERS}), first "
                      f"micro-batch's ids")
        k1.update(launches=launches["K1"], max_abs_err=0.0,
                  remote_misses=listed[0],
                  remote_rows=int((tiers == 3).sum()))
        return out, k1
    finally:
        for c in caches:
            c.close()
        for e in engines:
            e.close()


def dead_peer(torch, dev, store, pstore, scores, trace_ids):
    """Part b: worker 1 dies at the third gather (a FailureInjector on a
    Coordinator) while the earlier gathers' tickets are in flight: every
    gather is submitted before any completes; each ticket is counted
    through a CompletionQueue."""
    from repro_torch.core.hetero_cache import HeteroCache, tier_rows
    from repro_torch.core.iostack import CompletionQueue
    from repro_torch.distributed.remote_engine import RemoteIOEngine
    from repro_torch.ft.failures import Coordinator, FailureInjector
    dev_rows, host_rows = tier_rows("helios", store.n_rows,
                                    CFG["device_cache_frac"],
                                    CFG["host_cache_frac"])
    coord = Coordinator(n_workers=SCALE_WORKERS)
    inj = FailureInjector(kill_at=SCALE_KILL)
    eng = RemoteIOEngine(pstore, me=0, coordinator=coord, chaos=None)
    cache = HeteroCache(pstore, scores, dev_rows, host_rows, eng,
                        device=dev)
    cq, tickets, submit = CompletionQueue(), [], eng.submit

    def submit_cq(*a, **kw):
        tickets.append(submit(*a, cq=cq, **kw))
        return tickets[-1]
    eng.submit = submit_cq
    try:
        pending = []
        for step, ids in enumerate(trace_ids):
            inj.apply(step, coord.workers)
            pending.append(cache.submit_planned(ids))
        rows = [cache.complete_planned(pg) for pg in pending]
        done = cq.drain()
        if len(done) != len(tickets) or \
                {id(t) for t in done} != {id(t) for t in tickets}:
            raise AssertionError(f"{len(done)} completions for "
                                 f"{len(tickets)} tickets")
        for ids, got in zip(trace_ids, rows):
            if not torch.equal(got.cpu(),
                               torch.from_numpy(store.read_rows(ids))):
                raise AssertionError("a gather differs after the peer died")
        if eng.peer_alive(1) or not eng.rerouted_rows:
            raise AssertionError("no row was rerouted around the dead peer")
        return {"killed": {str(k): v for k, v in SCALE_KILL.items()},
                "tickets": len(tickets), "completions": len(done),
                "rerouted_rows": eng.rerouted_rows,
                "rerouted_batches": eng.rerouted_batches,
                "remote_rows": eng.remote_rows, "local_rows": eng.local_rows}
    finally:
        cache.close()
        eng.close()


def fleet_run(torch, dev, g, store, wl, params, hot=None, new=None):
    """Part c on one device: a ServingFleet of FLEET_REPLICAS over a
    writable store serves ``wl``, takes owner-writes of ``new`` at ``hot``
    (the FLEET_WRITE_ROWS rows the first round read most, when ``hot`` is
    None), settles every replica and serves ``wl`` again.  Each round runs
    under the tracer and the profiler with the launch counters zeroed."""
    import numpy as np
    from repro_torch.distributed.fleet import ServingFleet
    from repro_torch.kernels.cache_lookup import ops as l_ops
    from repro_torch.kernels.gather import ops as g_ops
    from repro_torch.kernels.segment_agg import ops as s_ops
    from repro_torch.obs import trace
    from repro_torch.serving import ServerConfig
    cfg = ServerConfig(device=str(dev), **CFG)
    read = []
    with ServingFleet(g, store, n_replicas=FLEET_REPLICAS, cfg=cfg,
                      params=params) as fleet:
        for rep in fleet.replicas:
            if rep.params is not fleet.params or \
                    rep.cache.device_tier.device != dev:
                raise AssertionError("a replica holds other tensors")
            submit = rep.cache.submit_planned

            def rec(ids, n_rows=None, submit=submit):
                read.append(ids)
                return submit(ids, n_rows)
            rep.cache.submit_planned = rec
        rounds = []
        for rnd in range(2):
            for m in (g_ops, s_ops, l_ops):
                m.launches = 0
            b0 = sum(r.stats.batches for r in fleet.replicas)
            tr = trace.install()

            def serve_round():
                futs = [fleet.submit(s, k) for s, _, k in wl]
                fleet.flush()
                return [(i, f.result()) for f, i in futs]
            res, wall, dev_ms = busy(dev, serve_round)
            trace.uninstall()
            batches = sum(r.stats.batches for r in fleet.replicas) - b0
            rounds.append({
                "results": res, "batches": batches,
                "served": sum(r is not None for _, r in res),
                "shed": sum(r is None for _, r in res),
                "wall_ms_per_batch": wall * 1e3 / batches,
                "traced_ms_per_batch": span_ms(tr, "serve.", batches),
                "device_busy_share": (dev_ms / (wall * 1e3)
                                      if dev_ms else None),
                "launches": {"K1": l_ops.launches, "K2": g_ops.launches,
                             "K3": s_ops.launches}})
            if rnd:
                break
            if hot is None:
                count = np.bincount(np.concatenate(read),
                                    minlength=store.n_rows)
                hot = np.argsort(-count, kind="stable")[:FLEET_WRITE_ROWS]
                new = np.random.default_rng(7).standard_normal(
                    (len(hot), store.row_dim)).astype(store.dtype)
            fleet.write_embeddings(hot, new)
            settled = [fleet._settle_invalidations(i)
                       for i in range(FLEET_REPLICAS)]
            again = [fleet._settle_invalidations(i)
                     for i in range(FLEET_REPLICAS)]
            if sum(again):
                raise AssertionError(f"a second settle refreshed {again}")
        for rep in fleet.replicas:
            if not torch.equal(rep.cache.gather(hot).cpu(),
                               torch.from_numpy(new)):
                raise AssertionError("a replica serves a stale written row")
        if not np.array_equal(store.read_rows(hot), new):
            raise AssertionError("the written rows did not reach the store")
        return {"rounds": rounds, "route_counts":
                fleet.router.route_counts.tolist(),
                "invalidated_rows": fleet.invalidated_rows,
                "settled_per_replica": settled, "hot": hot, "new": new,
                "params": fleet.params}


def fleet_phase(torch, dev, g, store, wl, root):
    """Part c: the fleet on the card, then on the CPU with the card's
    parameters, each over its own writable copy of the store."""
    from repro_torch.core.iostack import FeatureStore
    runs = []
    for where in (dev, torch.device("cpu")):
        path = os.path.join(root, f"fleet_{where.type}")
        shutil.copytree(store.path, path)
        wstore = FeatureStore(path, store.n_rows, store.row_dim,
                              dtype=store.dtype, n_shards=store.n_shards,
                              writable=True)
        params = None
        if runs:
            params = {"layers": [{k: v.cpu() for k, v in lp.items()}
                                 for lp in runs[0]["params"]["layers"]],
                      "head": {k: v.cpu() for k, v in
                               runs[0]["params"]["head"].items()}}
        runs.append(fleet_run(torch, where, g, wstore, wl, params,
                              *((runs[0]["hot"], runs[0]["new"]) if runs
                                else ())))
        del wstore
        shutil.rmtree(path)
    card, cpu = runs
    for r in card["rounds"]:
        if min(r["launches"].values()) < 1:
            raise AssertionError(f"a kernel of the path never ran in a "
                                 f"fleet round: {r['launches']}")
    if card["route_counts"] != cpu["route_counts"] or \
            card["invalidated_rows"] != cpu["invalidated_rows"] or \
            not card["invalidated_rows"]:
        raise AssertionError(
            f"fleets differ: routes {card['route_counts']} / "
            f"{cpu['route_counts']}, invalidated "
            f"{card['invalidated_rows']} / {cpu['invalidated_rows']}")
    err = 0.0
    for ra, rb in zip(card["rounds"], cpu["rounds"]):
        for (i, a), (j, b) in zip(ra["results"], rb["results"]):
            if i != j or (a is None) != (b is None):
                raise AssertionError("the CPU fleet routed, answered or "
                                     "shed another request")
            if a is None:
                continue
            if a["latency_v"] != b["latency_v"]:
                raise AssertionError("virtual latency differs from the CPU")
            d = abs(a["logits"] - b["logits"])
            err = max(err, float(d.max()))
            if not (d <= 1e-4 + 1e-4 * abs(b["logits"])).all():
                raise AssertionError(f"fleet logits differ from the CPU "
                                     f"by {err}")
    for r in card["rounds"]:
        del r["results"]
    return {"replicas": FLEET_REPLICAS, "rounds": card["rounds"],
            "route_counts": card["route_counts"],
            "invalidated_rows": card["invalidated_rows"],
            "settled_per_replica": card["settled_per_replica"],
            "written_rows": len(card["hot"]),
            "cpu_max_abs_logit_err": err}


def phase_scale_out(torch, dev, g, store, scores, trace_ids, wl, ops,
                    refs):
    """The scale-out phase (parts a-d; see the module docstring).  Returns
    the ``scale_out`` line's object and K1's ``remote_tier`` entry."""
    t0 = time.perf_counter()
    shutil.rmtree(SCALE_ROOT, ignore_errors=True)
    try:
        pstore = partitioned_copy(store, os.path.join(SCALE_ROOT, "part"))
        copy_s = time.perf_counter() - t0
        log(f"[scale_out] {SCALE_WORKERS}-worker partitioned copy in "
            f"{copy_s:.1f} s")
        remote, k1 = remote_tier(torch, dev, store, pstore, scores,
                                 trace_ids, ops, refs)
        log(f"[scale_out] remote tier: {remote}")
        peer = dead_peer(torch, dev, store, pstore, scores, trace_ids)
        log(f"[scale_out] dead peer: {peer}")
        del pstore
        fleet = fleet_phase(torch, dev, g, store, wl, SCALE_ROOT)
        log(f"[scale_out] fleet: {fleet}")
    finally:
        shutil.rmtree(SCALE_ROOT, ignore_errors=True)
    return ({"workers": SCALE_WORKERS, "me": 0, "partition": "hash",
             "copy_s": copy_s, "remote_tier": remote, "dead_peer": peer,
             "fleet": fleet, "phase_s": time.perf_counter() - t0}, k1)


def k4_bwd_check(torch, got, want, dtype):
    """K4's backward ``got`` (dq, dk, dv) against the plain version's
    ``want``, entry by entry: the largest |got - want| / (rtol |want| +
    atol mean|want| + ``K4_BWD_FLOOR``) of each (``tol_ratio``, within 1),
    with (rtol, atol) from ``K4_BWD_TOL``; the largest |got - want| over
    the largest |want| (``largest_entry_err``, within ``K4_BWD_LARGEST``);
    ``atol_reading``, each one's largest (|got - want| - rtol |want|) /
    mean|want|; and ``fault_ratio``, the per-entry ratio with one key tile
    of dk or of dv zeroed (from the middle key on), which must exceed 1.
    The largest entries sit at the first keys under a causal mask (every
    query sees them), so the bound on the largest entry alone would let a
    later tile go wrong."""
    rtol, atols = K4_BWD_TOL[dtype]
    names = ("dq", "dk", "dv")
    means = [float(b.float().abs().mean()) for b in want]

    def excess(a, b):
        return ((a.float() - b.float()).abs() - rtol * b.float().abs())

    def ratio(i, a):
        b = want[i].float()
        return float(((a.float() - b).abs()
                      / (rtol * b.abs() + atols[i] * means[i]
                         + K4_BWD_FLOOR)).max())
    out = {"max_abs_err": max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, want)),
           "largest_entry_err": max(
               float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1.0)
               for a, b in zip(got, want)),
           "tol_ratio": {n: ratio(i, a)
                         for i, (n, a) in enumerate(zip(names, got))},
           "tolerance": {"rtol": rtol, "atol_of_mean": dict(zip(names,
                                                                atols)),
                         "floor": K4_BWD_FLOOR},
           "atol_reading": {n: float(excess(a, b).max()) / max(m, 1e-30)
                            for n, a, b, m in zip(names, got, want, means)},
           "ref_abs_mean": dict(zip(names, means)),
           "ref_abs_max": {n: float(b.float().abs().max())
                           for n, b in zip(names, want)},
           "fault_ratio": {}}
    T = want[1].shape[1]
    lo = (T // 2) // K4_BWD_TILE * K4_BWD_TILE
    for i in (1, 2):
        bad = got[i].clone()
        bad[:, lo:lo + K4_BWD_TILE] = 0
        out["fault_ratio"][f"{names[i]} keys {lo}:{lo + K4_BWD_TILE} "
                           "zeroed"] = ratio(i, bad)
    return out


def k4_bwd_call(torch, fa_ops, q, k, v, do, causal, window):
    """K4's backward on (q, k, v, do) as a call with no arguments, after
    one forward: with the forward's saved log-sum-exp where the package
    has ``flash_attention_fwd`` (this tree), else as a tree before it took
    one (``--lm-kernels`` of an older checkout)."""
    with torch.no_grad():
        if hasattr(fa_ops, "flash_attention_fwd"):
            o, lse = fa_ops.flash_attention_fwd(q, k, v, causal, 0, window)
            return lambda: fa_ops.flash_attention_bwd(
                q, k, v, o, do, causal, 0, window, lse=lse)
        o = fa_ops.flash_attention(q, k, v, causal, 0, window)
        return lambda: fa_ops.flash_attention_bwd(q, k, v, o, do, causal, 0,
                                                  window)


def k4_bwd_row(torch, F, fa_ops, fa_ref, shape, dtype):
    """K4's backward at one shape (``K4_BWD_SHAPES``) and dtype, on seeded
    inputs: dq, dk, dv against autograd through the plain version on the
    card (``k4_bwd_check``; a planted fault must fail it), on the route
    its dtype and width call for (``kernel_route``; bf16 at the tree's
    ``TENSOR_CORE_BWD_HEAD_DIMS``, 64-256 here, recurrentgemma's 256 too:
    the tensor cores; float32 and bf16 at hd 8: the CUDA cores; a parent
    tree's own widths for ``--lm-kernels``), timed as in
    phase 4 beside the plain version's backward and SDPA's (autograd
    through ``scaled_dot_product_attention`` on the same inputs; the
    boolean mask where there is a window), each a
    backward alone (its forward graph built once).  Bound: 10 hd FLOPs per
    visible (query, key) pair and head (S, dP, dV, dK, dQ) over the
    dtype's peak, or the bytes of q, k, v, o, dO read and dq, dk, dv
    written; ``design_hd_per_pair``: what the route's kernels do (the
    tensor cores' split design 16 hd: S and dP twice, P's bf16 low half
    into dV)."""
    label, B, S, T, H, K, hd, causal, window = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(hd + S + len(dtype))
    q = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(B, T, K, hd, generator=g, device="cuda").to(dt)
            for _ in range(2))
    do = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt)
    bwd = k4_bwd_call(torch, fa_ops, q, k, v, do, causal, window)
    routes = getattr(fa_ops, "bwd_route_launches", None)
    before = dict(routes or {})
    got = bwd()
    torch.cuda.synchronize()
    route = ("cuda_cores" if routes is None else
             next(r for r, n in routes.items() if n != before[r]))
    # the backward's own widths (a tree before they split from the
    # forward's has none)
    widths = getattr(fa_ops, "TENSOR_CORE_BWD_HEAD_DIMS",
                     fa_ops.TENSOR_CORE_HEAD_DIMS)
    want_route = ("tensor_cores" if routes is not None and dtype ==
                  "bfloat16" and hd in widths else "cuda_cores")
    if route != want_route:
        raise AssertionError(f"K4 backward at {label} {dtype} took {route}")

    def graph(fn):
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        return fn(*qkv), qkv

    out_p, qkv_p = graph(lambda a, b, c: fa_ref.attention_ref(
        a, b, c, causal, 0, window))
    want = torch.autograd.grad(out_p, qkv_p, do, retain_graph=True)
    check = k4_bwd_check(torch, got, want, dtype)
    if not (max(check["tol_ratio"].values()) <= 1
            and check["largest_entry_err"] <= K4_BWD_LARGEST[dtype]
            and min(check["fault_ratio"].values()) > 1):
        raise AssertionError(f"K4 backward at {label} {dtype}: {check}")
    del got, want
    mask = fa_ref.visible(S, T, causal, 0, window, q.device)
    pairs = int(mask.sum())
    sd_mask = mask if window else None
    out_l, qkv_l = graph(lambda a, b, c: F.scaled_dot_product_attention(
        a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
        attn_mask=sd_mask, is_causal=causal and sd_mask is None,
        enable_gqa=True))
    do_l = do.transpose(1, 2)
    byts = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    ops = 10 * B * H * hd * pairs
    peak = BF16_OPS_S if dtype == "bfloat16" else F32_OPS_S
    t_b, t_o = byts / HBM_BYTES_S * 1e3, ops / peak * 1e3
    row = dict(
        input=label, dtype=dtype, kernel_route=route, **check,
        **timing(bwd,
                 lambda: torch.autograd.grad(out_p, qkv_p, do,
                                             retain_graph=True),
                 lambda: torch.autograd.grad(out_l, qkv_l, do_l,
                                             retain_graph=True)),
        bound_ms=max(t_b, t_o),
        bound_by="bytes" if t_b > t_o else "operations",
        design_hd_per_pair=16 if route == "tensor_cores" else 10,
        visible_pairs=pairs,
        shape=f"q={tuple(q.shape)} kv={tuple(k.shape)} causal={causal} "
              f"window={window}")
    del out_p, qkv_p, out_l, qkv_l
    torch.cuda.empty_cache()
    return row


def lm_family_steps(torch, dev, fa_ops):
    """Phase 9 b: one make_train_step (AdamW, 2 microbatches of 2 x 16
    tokens) of every attention family at .reduced() width in float32, on
    the card and on the CPU from the same parameters and batch: loss and
    grad_norm within 1e-4 relative; new parameters within 1e-5 + 1e-4 of
    each entry's magnitude but at most 0.1% of entries (AdamW's first step
    is about +-lr per entry, and where a gradient is within rounding of
    zero its sign decides; every such entry still within 2 lr + 1e-6); K4
    forward and backward launched on the card."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import lm, steps
    from repro_torch.train import optim
    lr, out = 1e-3, {}
    for name in LM_TRAIN_FAMILIES:
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  dtype="float32")
        rng = np.random.default_rng(3)
        b = {"labels": rng.integers(0, cfg.vocab, (2, 2, 16))}
        if cfg.enc_dec or not cfg.frontend:
            b["tokens"] = rng.integers(0, cfg.vocab, (2, 2, 16))
        if cfg.frontend:
            b["enc_embeds" if cfg.enc_dec else "embeds"] = \
                rng.normal(size=(2, 2, 16, cfg.d_model)).astype(np.float32)
        res = {}
        for d in ("cpu", dev):
            model = lm.init_params(torch.Generator().manual_seed(7), cfg,
                                   device=d)
            opt = optim.adamw(lr)
            state = steps.init_train_state(model, opt)
            batch = {k: torch.from_numpy(v).to(d) for k, v in b.items()}
            f0, b0 = fa_ops.launches, fa_ops.bwd_launches
            _, m = steps.make_train_step(cfg, opt, q_chunk=8)(state, batch)
            res[str(d)] = (float(m["loss"]), float(m["grad_norm"]),
                           lm.params_to_numpy(model),
                           (fa_ops.launches - f0, fa_ops.bwd_launches - b0))
        (lc, gc, pc, _), (la, ga, pa, k4) = res["cpu"], res[str(dev)]
        if min(k4) < 1:
            raise AssertionError(f"{name}: K4 launches on the card {k4}")
        for what, a, c in (("loss", la, lc), ("grad_norm", ga, gc)):
            if not abs(a - c) <= 1e-4 * abs(c):
                raise AssertionError(f"{name} train step {what}: card {a}, "
                                     f"CPU {c}")
        worst, off, total = 0.0, 0, 0
        for key, c in lm.flat_cache(pc).items():
            a = lm.flat_cache(pa)[key]
            e = np.abs(a - c)
            worst = max(worst, float(e.max()))
            off += int((e > 1e-5 + 1e-4 * np.abs(c)).sum())
            total += e.size
        if off > 1e-3 * total or worst > 2 * lr + 1e-6:
            raise AssertionError(f"{name} train step parameters: {off} of "
                                 f"{total} entries off, worst {worst}")
        out[name] = {"loss_card": la, "loss_cpu": lc, "grad_norm_card": ga,
                     "grad_norm_cpu": gc, "max_param_diff": worst,
                     "params_off": f"{off} of {total}",
                     "k4_launches_fwd_bwd": k4}
    log(f"[lm_train] reduced families, card vs CPU: {out}")
    return out


def lm_train_gate(torch, cfg, model, batch, fa_ops):
    """Phase 9 c's gate: one microbatch's loss and gradients (no
    optimizer) with K4 and its backward, then with autograd through the
    plain attention (``_attend_plain``) on the card, then with K4 and its
    backward again (``repeat``), then once more with K4's backward planted
    to give zeros (the fault this slice repairs: attention's dq, dk, dv
    lost); each side's gradients freed before the next runs.  Each side
    reads the loss, the whole model's gradient norm and the norm of each
    q, k and v projection's gradients over every layer; the kernels'
    readings must agree with the plain ones within ``LM_TRAIN_GATE``, and
    the fault's gradient readings must not (the fault leaves the loss, a
    forward reading, as it is).  ``repeat`` reports whether the kernel
    side's readings repeat bit for bit (K4's backward adds nothing by
    atomics on the tensor cores; the rest of the step may)."""
    from repro_torch.models import attention, steps
    out = {}
    attend, bwd = attention.attend, fa_ops.flash_attention_bwd

    def plain(q, k, v, *, causal=True, window=0, q_chunk=512, q_offset=0,
              probs_dtype=torch.float32):
        return attention._attend_plain(q, k, v, causal, window, q_chunk,
                                       q_offset, probs_dtype)

    def zeros(q, k, v, *args, **kwargs):
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def norm(gs):
        return float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                    for g in gs)))
    names = [n for n, _ in model.named_parameters()]
    for side in ("kernels", "plain", "repeat", "fault"):
        if side == "plain":
            attention.attend = plain
        if side == "fault":
            fa_ops.flash_attention_bwd = zeros
        try:
            f0, b0 = fa_ops.launches, fa_ops.bwd_launches
            loss, _ = steps.compute_loss(model, cfg, batch)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            read = {"loss": float(loss.detach()), "grad_norm": norm(grads)}
            for proj in ("attn.wq", "attn.wk", "attn.wv"):
                read[proj] = norm(g for n, g in zip(names, grads)
                                  if n.endswith(proj))
            out[side] = (read, fa_ops.launches - f0, fa_ops.bwd_launches - b0)
            del loss, grads
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        finally:
            attention.attend, fa_ops.flash_attention_bwd = attend, bwd
    launches = {side: out[side][1:] for side in out}
    if min(launches["kernels"] + launches["repeat"]) < 1 or \
            max(launches["plain"]) or launches["fault"][0] < 1:
        raise AssertionError(f"gate: K4 launches (fwd, bwd) by side "
                             f"{launches}")
    want = out["plain"][0]

    def rel(side):
        return {k: abs(v - want[k]) / abs(want[k])
                for k, v in out[side][0].items()}
    gate = {"readings": {side: out[side][0] for side in out},
            "rel_diff": rel("kernels"), "fault_rel_diff": rel("fault"),
            "tolerance": LM_TRAIN_GATE,
            "repeat": {"identical": out["repeat"][0] == out["kernels"][0],
                       "rel_diff": {k: abs(v - out["kernels"][0][k])
                                    / abs(out["kernels"][0][k])
                                    for k, v in out["repeat"][0].items()}}}
    if not (all(rel(side)[k] <= lim for side in ("kernels", "repeat")
                for k, lim in LM_TRAIN_GATE.items())
            and all(gate["fault_rel_diff"][k] > LM_TRAIN_GATE[k]
                    for k in ("grad_norm", "attn.wq", "attn.wk",
                              "attn.wv"))):
        raise AssertionError(f"gate: K4 and its backward against the plain "
                             f"attention: {gate}")
    return gate


def visible_pairs(S, window):
    """Causal (query, key) pairs of S tokens under ``window`` (0: none)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def full_width_step(torch, dev, fa_ops, arch, counted):
    """Phase 9 c (llama3.2-3b) or d (recurrentgemma-2b): ``arch`` at full
    width in bf16 (seeded weights), train_4k's 4096 tokens in 2
    microbatches of 1 from a seeded TokenStore, AdamW with warmup_cosine
    through the in-place update, remat: the gate (``lm_train_gate``), 1
    warm-up step, ``counted`` steps with the counters zeroed, then the
    first batch again, profiled.  Returns its report."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import OutOfCoreTokenIterator, TokenStore
    from repro_torch.launch.train import device_batch
    from repro_torch.models import lm, steps
    from repro_torch.train.optim import adamw, warmup_cosine

    cfg = get_config(arch)
    shutil.rmtree(LM_TRAIN_DATA, ignore_errors=True)
    store = TokenStore(LM_TRAIN_DATA, n_sequences=64, seq_len=LM_TRAIN_SEQ,
                       vocab=cfg.vocab, n_shards=4, create=True,
                       seed=LLM_SEED)
    it = OutOfCoreTokenIterator(store, LM_TRAIN_MB * LM_TRAIN_N_MB,
                                LM_TRAIN_N_MB)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = lm.init_params(torch.Generator(device=dev).manual_seed(LLM_SEED),
                           cfg, device=dev).requires_grad_(True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    first = device_batch(next(it), cfg, dev)
    gate = lm_train_gate(torch, cfg, model, {k: v[0] for k, v in
                                             first.items()}, fa_ops)
    log(f"[lm_train] {arch} gate {gate}")
    opt = adamw(warmup_cosine(*LM_TRAIN_LR))
    state = steps.init_train_state(model, opt)
    train = steps.make_train_step(cfg, opt)
    state, m0 = train(state, first)              # the warm-up step
    losses = [float(m0["loss"])]
    batches = [device_batch(next(it), cfg, dev) for _ in range(counted)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa_ops.launches = fa_ops.bwd_launches = 0
    fa_ops.bwd_route_launches = dict.fromkeys(fa_ops.ROUTES, 0)
    t0 = time.perf_counter()
    norms = []
    for b in batches:
        state, m = train(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / counted
    launches = {"K4_forward": fa_ops.launches,
                "K4_backward": fa_ops.bwd_launches,
                "K4_backward_by_route": dict(fa_ops.bwd_route_launches)}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    # K4 forward twice per attention layer and microbatch (the remat
    # forward recomputes it), backward once, on the tensor cores (bf16 at
    # hd 128 and 256)
    pattern = cfg.pattern or ("attn",)
    n_attn = sum(pattern[i % len(pattern)] == "attn"
                 for i in range(cfg.n_layers))
    n_bwd = n_attn * LM_TRAIN_N_MB * counted
    want = {"K4_forward": 2 * n_bwd, "K4_backward": n_bwd,
            "K4_backward_by_route": {"tensor_cores": n_bwd,
                                     "cuda_cores": 0}}
    if launches != want:
        raise AssertionError(f"lm_train {arch}: K4 launches {launches}, "
                             f"expected {want}")
    # the first step's batch again, profiled: its loss must be lower
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, m = train(state, first)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t1
    again = float(m["loss"])
    if not (np.isfinite(losses + norms + [again]).all()
            and again < losses[0]):
        raise AssertionError(f"lm_train {arch}: losses {losses}, the first "
                             f"batch again {again}")
    dev_ms = device_ms(prof)
    # K4's device ms in the profiled step by kernel: the forward, and the
    # backward's delta pass, dK/dV kernels (hd 64-128; hd 256 and its
    # head groups' ordered sum) and dQ kernel (the CUDA-core backward
    # kernel, which the bf16 step must not run, beside them)
    k4_ms = {kind: sum(e.self_device_time_total for e in prof.key_averages()
                       if name in e.key) / 1e3
             for kind, name in (
                 ("forward", "::tc::flash_fwd_tc_kernel"),
                 ("backward_delta", "::pre::flash_bwd_delta_kernel"),
                 ("backward_dkdv", "::tcb::flash_bwd_dkdv_kernel"),
                 ("backward_dkdv256", "::tcb::flash_bwd_dkdv256_kernel"),
                 ("backward_group_sum", "::tcb::flash_bwd_sum_kernel"),
                 ("backward_dq", "::tcb::flash_bwd_dq_kernel"),
                 ("backward_cuda_cores", "::bwd::flash_bwd_kernel"))}
    k4_ms["backward"] = sum(v for kind, v in k4_ms.items()
                            if kind.startswith("backward_"))
    # the step's device time by kind: K4, the cuBLAS GEMMs, the rest
    # (elementwise, reductions, copies, fills)
    gemm = sum(e.self_device_time_total for e in prof.key_averages()
               if e.key.startswith(("nvjet", "sm90_xmma", "cutlass"))
               or "gemm" in e.key.lower()) / 1e3
    k4_total = k4_ms["forward"] + k4_ms["backward"]
    by_kind = {"K4": k4_total, "gemm": gemm,
               "other": dev_ms - k4_total - gemm}
    tokens = LM_TRAIN_SEQ * LM_TRAIN_MB * LM_TRAIN_N_MB
    n_mat = n_params - cfg.vocab * cfg.d_model       # the embedding lookup
    # attention pairs over the window only (recurrentgemma's 2048)
    attn = n_attn * cfg.n_heads * cfg.head_dim * \
        visible_pairs(LM_TRAIN_SEQ, cfg.window if cfg.pattern else 0) * \
        LM_TRAIN_MB * LM_TRAIN_N_MB
    model_flops = 6 * n_mat * tokens + 12 * attn       # fwd 4, bwd 8 / pair
    remat_flops = 2 * n_mat * tokens + 4 * attn
    report = {
        "config": arch, "params": n_params, "dtype": cfg.dtype,
        "seq_len": LM_TRAIN_SEQ, "microbatches": LM_TRAIN_N_MB,
        "microbatch": LM_TRAIN_MB, "attention_layers": n_attn,
        "window": cfg.window if cfg.pattern else 0,
        "reduced": "global batch 256 -> 2 (train_4k: 256 x 4096 tokens)",
        "optimizer": f"adamw, warmup_cosine{LM_TRAIN_LR}, in place",
        "init_s": init_s, "gate": gate,
        "ms_per_step": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "model_tflop_s": model_flops / step_s / 1e12,
        "hardware_tflop_s": (model_flops + remat_flops) / step_s / 1e12,
        "model_flop_per_step": model_flops,
        "remat_flop_per_step": remat_flops,
        "peak_mem_gb": peak, "losses": losses, "grad_norms": norms,
        "first_batch_loss_again": again,
        "counted_steps": counted, "launches": launches,
        "profiled_step_ms": prof_s * 1e3,
        "device_ms_profiled_step": dev_ms,
        "device_busy_share": dev_ms / (step_s * 1e3),
        "device_busy_share_profiled_step": dev_ms / (prof_s * 1e3),
        "k4_device_ms_per_step": k4_ms,
        "device_ms_by_kind": by_kind,
        "device_ms_by_op": top_ops(prof, n=12)}
    log(f"[lm_train] {arch}: {report}")
    it.io.close()
    del model, state, train, opt, first, batches, m, m0, it, prof
    shutil.rmtree(LM_TRAIN_DATA, ignore_errors=True)
    torch.cuda.empty_cache()
    return report


def phase_lm_train(torch, dev, F, fa_ops, fa_ref):
    """Phase 9 (see the module docstring).  Returns (the ``lm_train``
    report, K4's backward entries for the kernel line: llama3.2-3b's
    layer, then recurrentgemma-2b's)."""
    t_phase = time.perf_counter()
    # a. K4's backward against its plain version, timed
    rows = [k4_bwd_row(torch, F, fa_ops, fa_ref, shape, dtype)
            for shape in K4_BWD_SHAPES for dtype in ("bfloat16", "float32")]
    log(f"[lm_train] a. K4 backward rows: {rows}")
    # b. reduced families, card against CPU
    families = lm_family_steps(torch, dev, fa_ops)
    # c. full-width llama3.2-3b; d. full-width recurrentgemma-2b
    report = full_width_step(torch, dev, fa_ops, LM_TRAIN_ARCH,
                             LM_TRAIN_COUNTED)
    report["families"] = families
    hybrid = full_width_step(torch, dev, fa_ops, LM_TRAIN_HYBRID,
                             LM_TRAIN_HYBRID_COUNTED)
    report["hybrid"] = hybrid

    def entry(row, run):
        return dict(
            name="flash_attention_bwd", route="cuda",
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces="src/repro/kernels/flash_attention/flash_attention.py:"
                     "64 (the backward of K4; the Pallas kernel has none)",
            launches=run["launches"]["K4_backward"],
            launches_per_step=(run["launches"]["K4_backward"]
                               // run["counted_steps"]),
            launches_on=run["config"],
            **{key: row[key] for key in (
                "kernel_route", "design_hd_per_pair",
                "max_abs_err", "largest_entry_err", "tol_ratio", "tolerance",
                "atol_reading",
                "ref_abs_mean", "ref_abs_max", "fault_ratio",
                "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "timed_by", "event_ms", "per_launch_ms",
                "visible_pairs", "input", "dtype", "shape")})
    # rows: (llama, whisper, recurrentgemma, ragged) x (bf16, float32)
    llama, rg = rows[0], rows[4]
    k4_bwd = [dict(entry(llama, report),
                   rows=[r for r in rows[1:] if r is not rg]),
              entry(rg, hybrid)]
    report["phase_s"] = time.perf_counter() - t_phase
    return report, k4_bwd


def serve(srv, workload):
    futs = [srv.submit(s, k, t) for s, t, k in workload]
    stats = srv.flush()
    return stats, [f.result() for f in futs]


def main(argv):
    import torch
    mode = argv[0] if argv[:1] in (["--gnn-kernels"], ["--lm-kernels"]) \
        else None
    gnn_only, lm_only = mode == "--gnn-kernels", mode == "--lm-kernels"
    pkg = os.path.abspath(argv[1]) if mode and len(argv) > 1 else SRC
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available; nothing was run")
        return 2
    if not os.path.isdir(os.path.join(pkg, "repro_torch")):
        log(f"chip_smoke: {pkg}/repro_torch not found; run from a checkout")
        return 3
    sys.path.insert(0, pkg)
    from repro_torch.gnn.graph import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.cache_lookup import ops as l_ops
    from repro_torch.kernels.cache_lookup import ref as l_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.gather import ops as g_ops
    from repro_torch.kernels.gather import ref as g_ref
    from repro_torch.kernels.segment_agg import ops as s_ops
    from repro_torch.kernels.rwkv_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv_scan import ref as wkv_ref
    from repro_torch.kernels.segment_agg import ref as s_ref
    from repro_torch.obs import trace
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import (GNNInferenceServer, ServerConfig,
                                     zipf_workload)

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} on {kind}")

    # --- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all(("flash_attention", "flash_attention_bwd")
                           if lm_only else build.KERNELS)
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        if hasattr(build, "ptxas_report"):
            lines = [f"{n}: {r['registers']} registers, spills "
                     f"{r['spill_stores']}/{r['spill_loads']} B"
                     + "".join(f"; {x}" for x in r["notes"])
                     for n, r in build.ptxas_report(name).items()]
        else:   # a tree that predates the parser (``--lm-kernels``)
            lines = [ln.strip() for ln in
                     path.with_suffix(".log").read_text().splitlines()
                     if "registers" in ln or "arning" in ln
                     or "Performance Loss" in ln or (
                         "spill" in ln and ", 0 bytes spill stores, 0 "
                         "bytes spill loads" not in ln)]
        log(f"[build] {name}: " + " | ".join(lines))
    # such a tree has no hd-256 tensor-core kernel to check either
    if hasattr(build, "ptxas_report"):
        lib, kernel = NO_SPILL
        found = {n: r for n, r in build.ptxas_report(lib).items()
                 if kernel in n}
        if not found or any(r["spill_stores"] or r["spill_loads"]
                            for r in found.values()):
            raise AssertionError(f"{kernel} spills or is missing from the "
                                 f"{lib} build log: {found}")
        log(f"[build] {kernel}: {list(found.values())}")

    if lm_only:     # K4's forward rows and phase 9 a, with this package's K4
        import torch.nn.functional as F
        rows = k4_fwd_rows(torch, F, fa_ops, fa_ref)
        rows += [dict(name="flash_attention_bwd",
                      **k4_bwd_row(torch, F, fa_ops, fa_ref, shape, dtype))
                 for shape in K4_BWD_SHAPES
                 for dtype in ("bfloat16", "float32")]
        log(f"[lm_kernels] K4 backward rows of {pkg}: {rows}")
        print(smi)
        print(json.dumps({"lm_kernels_of": pkg, "kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # --- 2. edge cases -------------------------------------------------------
    if not gnn_only:
        t0 = time.perf_counter()
        ops, refs = (g_ops, s_ops, l_ops), (g_ref, s_ref, l_ref)
        phase_edges(torch, dev, ops, refs)
        log(f"[edges] K1, K2, K3 agree with their plain versions "
            f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        phase_edges_llm(torch, dev, fa_ops, fa_ref, wkv_ops, wkv_ref)
        log(f"[edges] K4, K5 agree with their plain versions "
            f"({time.perf_counter() - t0:.1f} s)")

    # --- 3. the server end to end -------------------------------------------
    t0 = time.perf_counter()
    shutil.rmtree(DATA, ignore_errors=True)
    g, store, spec = make_dataset("IG", DATA, scale=1e-3)
    wl = zipf_workload(g.n_vertices, REQUESTS, 64, rate_rps=RATE,
                       degrees=g.degrees(), seed=1)
    log(f"[serve] IG-shaped data: {g.n_vertices} vertices, {g.n_edges} "
        f"edges, {store.row_dim}-dim rows "
        f"({store.n_rows * store.row_bytes / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    seen_ids, seen_micro = [], []
    # the GNN model's first K2 and K3 call at each width (layer 2: hidden)
    from repro_torch.gnn import models as gnn_models
    seen_layer = {}

    def first_by_width(key, fn):
        def call(x, *a):
            seen_layer.setdefault((key, x.shape[1]), (x, *a))
            return fn(x, *a)
        return call
    model_k2, model_k3 = gnn_models.gather_rows, gnn_models.segment_sum
    with GNNInferenceServer(g, store, ServerConfig(device="cuda", **CFG)) \
            as srv:
        cache, batcher = srv.cache, srv.batcher
        submit, build_mb = cache.submit_planned, batcher.build
        scores = cache.policy.initial_scores()     # the presampled hotness

        def submit_rec(ids, n_rows=None):
            seen_ids.append(ids)
            return submit(ids, n_rows)

        def build_rec(reqs):
            seen_micro.append(build_mb(reqs))
            return seen_micro[-1]

        cache.submit_planned, batcher.build = submit_rec, build_rec
        if not (cache.device_tier.is_cuda and cache.host_tier.is_pinned()):
            raise AssertionError("tiers are not on the card / pinned")
        # warm-up outside the counted run: CUDA context, cuBLAS handles
        srv.infer_step(srv.params, torch.zeros(4, store.row_dim, device=dev),
                       *[(torch.zeros(1, dtype=torch.int32, device=dev),)]
                       * 2, (torch.zeros(1, dtype=torch.bool, device=dev),))
        torch.cuda.synchronize()
        for m in (g_ops, s_ops, l_ops):
            m.launches = 0
        gnn_models.gather_rows = first_by_width("K2", model_k2)
        gnn_models.segment_sum = first_by_width("K3", model_k3)
        # the server's own spans split each micro-batch's wall time into
        # batch build (sampling), gather (cache + IO) and forward; the
        # profiler's device time gives the card's busy share
        tr = trace.install()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st, res = serve(srv, wl)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        trace.uninstall()
        busy_ms = device_ms(prof)
        top = sorted(prof.key_averages(),
                     key=lambda e: -e.self_device_time_total)[:6]
        phase_ms = {name: sum(sp.wall_s for sp in tr.spans
                              if sp.name == f"serve.{name}") * 1e3
                    / st.batches for name in ("batch", "gather", "forward")}
        launches = {"K1": l_ops.launches, "K2": g_ops.launches,
                    "K3": s_ops.launches}
        cache.submit_planned, batcher.build = submit, build_mb
        gnn_models.gather_rows, gnn_models.segment_sum = model_k2, model_k3
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the path never ran: "
                                 f"{launches}")
        shed = sum(r is None for r in res)
        if st.served + st.rejected_total != len(wl) or \
                shed != st.rejected_total or st.served == 0:
            raise AssertionError(f"served {st.served} + shed "
                                 f"{st.rejected_total} != {len(wl)} "
                                 f"(futures shed: {shed})")
        for r in res:
            if r is not None and (r["logits"].shape[1] != g.n_classes
                                  or not bool(torch.isfinite(torch.from_numpy(
                                      r["logits"])).all())):
                raise AssertionError("non-finite or misshapen logits")
        server = {"requests": len(wl), "served": st.served,
                  "shed": st.rejected_total, "batches": st.batches,
                  "wall_ms_per_batch": wall * 1e3 / st.batches,
                  "traced_ms_per_batch": phase_ms,
                  "device_busy_share": (busy_ms / (wall * 1e3)
                                        if busy_ms else None),
                  "device_ms_per_batch_by_op": {
                      e.key[:60]: e.self_device_time_total / 1e3
                      / st.batches for e in top},
                  "rows_fetched": st.rows_fetched,
                  "storage_rows_issued": st.storage_rows_issued,
                  "virtual_p50_s": st.percentile(50),
                  "virtual_p99_s": st.percentile(99),
                  "launches": launches}
        log(f"[serve] {server}")

        # --- 4. kernels on the serving run's own inputs -------------------
        kernels = []
        with cache._table_lock:
            tiers = cache.loc[seen_ids[0]]
            lk_args = (torch.from_numpy(seen_ids[0].astype("int32")).to(dev),
                       cache._loc_dev, cache._slot_dev)
            dt, ht = cache.device_tier, cache.host_tier
        k1_train, k3_train, k3_counts, train_nodes = training_rows(
            torch, dev, g, cache, g_ops, s_ops, l_ops, l_ref)
        kernels.append(dict(
            name="fused_cache_lookup", route="cuda",
            source="src/repro_torch/csrc/cache_lookup.cu",
            replaces="src/repro/kernels/cache_lookup/cache_lookup.py:106",
            launches=launches["K1"], max_abs_err=0.0,
            **k1_entry(torch, g_ops, l_ops, l_ref, lk_args, dt, ht, tiers,
                       "serving, first micro-batch's ids"),
            training=k1_train))

        micro = seen_micro[0]
        rows = cache.gather(micro.unique_ids)
        idx = torch.from_numpy(micro.scatter[0]).to(dev)
        got = g_ops.gather_rows(rows, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, g_ref.gather_rows_ref(rows, idx)):
            raise AssertionError("K2 differs on the served expansion")
        k2_l2 = k2_entry(torch, g_ops, g_ref,
                         *seen_layer[("K2", CFG["hidden"])])
        kernels.append(dict(
            name="gather_rows", route="cuda",
            source="src/repro_torch/csrc/gather.cu",
            replaces="src/repro/kernels/gather/gather.py:59",
            launches=launches["K2"], max_abs_err=0.0,
            **k2_entry(torch, g_ops, g_ref, rows, idx),
            layer2=k2_l2))

        blk = micro.minibatches[0].blocks[-1]      # the first layer applied
        feats = got
        src = torch.from_numpy(blk.src_pos).to(dev)
        dst = torch.from_numpy(blk.dst_pos).to(dev)
        w = torch.from_numpy(blk.edge_mask).to(dev).to(torch.float32)
        msgs = g_ops.gather_rows(feats, src) * w[:, None]
        kernels.append(dict(
            name="segment_sum", route="cuda",
            source="src/repro_torch/csrc/segment_agg.cu",
            replaces="src/repro/kernels/segment_agg/segment_agg.py:32",
            launches=launches["K3"],
            **k3_entry(torch, s_ops, msgs, dst, feats.shape[0],
                       "serving layer 1"),
            layer2=k3_entry(torch, s_ops,
                            *seen_layer[("K3", CFG["hidden"])],
                            "serving layer 2"),
            training=k3_train, training_counts=k3_counts))
        params = {"layers": [{k: v.cpu() for k, v in lp.items()}
                             for lp in srv.params["layers"]],
                  "head": {k: v.cpu() for k, v in srv.params["head"].items()}}

    if gnn_only:
        shutil.rmtree(DATA, ignore_errors=True)
        print(smi)
        print(json.dumps({"gnn_kernels_of": pkg, "kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # --- 5. the same requests on the CPU, plain versions --------------------
    t0 = time.perf_counter()
    with GNNInferenceServer(g, store, ServerConfig(device="cpu", **CFG),
                            params=params) as cpu_srv:
        st_cpu, res_cpu = serve(cpu_srv, wl)
    if (st_cpu.served, st_cpu.rejected_total) != (st.served,
                                                  st.rejected_total):
        raise AssertionError("the CPU run answered or shed other requests")
    cpu_err = 0.0
    for a, b in zip(res, res_cpu):
        if (a is None) != (b is None):
            raise AssertionError("a request was shed on one device only")
        if a is not None:
            if a["latency_v"] != b["latency_v"]:
                raise AssertionError("virtual latency differs from the CPU")
            cpu_err = max(cpu_err, float(abs(a["logits"]
                                             - b["logits"]).max()))
            if not (abs(a["logits"] - b["logits"])
                    <= 1e-4 + 1e-4 * abs(b["logits"])).all():
                raise AssertionError(f"logits differ from the CPU run: "
                                     f"{cpu_err}")
    server["cpu_max_abs_logit_err"] = cpu_err
    log(f"[cpu] same {st_cpu.served} requests on the CPU in "
        f"{time.perf_counter() - t0:.1f} s; max |logit err| {cpu_err:.3g}")

    # --- 5a. scale-out: remote tier, dead peer, fleet ---------------------
    scale_out, kernels[0]["remote_tier"] = phase_scale_out(
        torch, dev, g, store, scores, seen_ids + [train_nodes], wl,
        (g_ops, s_ops, l_ops), (g_ref, s_ref, l_ref))
    log(f"[scale_out] phase in {scale_out['phase_s']:.1f} s")

    # --- 5b. out-of-core training on the card ---------------------------
    t0 = time.perf_counter()
    train, step, counts = phase_train(torch, dev, g, store,
                                      (g_ops, s_ops, l_ops))
    shutil.rmtree(DATA, ignore_errors=True)
    train["backward"], seen = phase_train_backward(
        torch, dev, step, (g_ops, s_ops), (g_ref, s_ref))
    del step
    k2_rows, k3_rows = train_kernel_rows(torch, seen, counts,
                                         TRAIN_COUNTED, g_ops, g_ref, s_ops)
    by_name = {k["name"]: k for k in kernels}
    by_name["gather_rows"].update(k2_rows)
    by_name["segment_sum"].update(k3_rows)
    del seen
    torch.cuda.empty_cache()
    train["cpu"] = phase_train_cpu(torch, dev)
    log(f"[train] phases a-c in {time.perf_counter() - t0:.1f} s")

    # --- 6. LM serving at full width, one model after the other -------------
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    counters = {"K4": fa_ops, "K5": wkv_ops}
    llm, inputs = {}, {}
    for name in LLM_ARCHS + FAMILY_ARCHS:
        t0 = time.perf_counter()
        cfg, cut = get_config(name), None
        if name in LLM_DEPTH:
            cut = f"n_layers {cfg.n_layers} -> {LLM_DEPTH[name]}"
            cfg = dataclasses.replace(cfg, n_layers=LLM_DEPTH[name])
        llm[name], inputs[name] = run_llm(torch, dev, cfg, counters, cut)
        log(f"[llm] {name} done in {time.perf_counter() - t0:.1f} s")

    # --- 7. K4, K5 on the llm run's own inputs -----------------------------
    kernels += llm_kernels(torch, F, inputs, llm, fa_ops, fa_ref, wkv_ops,
                           wkv_ref)
    del inputs
    torch.cuda.empty_cache()

    # --- 8. reduced LMs on the card against the CPU ------------------------
    llm["cpu_max_abs_logit_err"], llm["cpu_bf16_moe_route_flips"] = \
        phase_cpu_llm(torch, dev, fa_ops)

    # --- 9. the LM train step: K4's backward, families, full width --------
    lm_train, k4_bwd = phase_lm_train(torch, dev, F, fa_ops, fa_ref)
    kernels += k4_bwd
    log(f"[lm_train] phase in {lm_train['phase_s']:.1f} s")

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"server": server, "card": smi}))
    print(json.dumps({"train": train, "card": smi}))
    print(json.dumps({"llm": llm, "card": smi}))
    print(json.dumps({"scale_out": scale_out, "card": smi}))
    print(json.dumps({"lm_train": lm_train, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
