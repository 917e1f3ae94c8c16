#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card: GNN inference serving (K1-K3)
and LM serving, prefill then greedy decode (K4, K5).

    python3 chip_smoke.py

Imports nothing of JAX and nothing of the reference package.  Phases; any
failure raises and the script exits non-zero:

  1. build   — compile every CUDA kernel of both paths from src/repro_torch/
               csrc with nvcc for sm_90a (one process per source, at once);
  2. edges   — each kernel against its plain PyTorch version on the card
               at the edge cases (K1, K3: B=1, empty tiers, duplicate-heavy
               batches, odd widths, bf16, out-of-range segment ids; K2:
               widths of 4, 12, 1020, 1024 and 4112 bytes, f32 and bf16, B
               from 0 to 65,537, int32 and int64 indices, random and
               sorted with repeats, out-of-range indices, a misaligned
               view; K4, both routes at their seams, q/k/v views of one
               packed qkv: f32 at S in {1, 24, 129}, bf16 at S in {1, 24,
               129, 1000}, hd in {32, 64, 80, 128}, GQA groups {1, 3, 8},
               causal or not, causal S=100 over T=612 at q_offset 512, bf16
               S=4096 at one GQA shape, each call on the route its dtype
               and width call for; K5:
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
               the plain version, the bound and a PyTorch library call.
               K2 on the served expansion and on layer 2's gather, K3 on
               layer 1's and layer 2's blocks;
  5. cpu     — a fresh server on the CPU (plain versions, same
               parameters) serves the same requests: same answered/shed
               split, logits within 1e-4;
  6. llm     — llama3.2-3b, then rwkv6-7b, at full published width in
               bf16 with random weights from a seeded CUDA generator (each
               freed before the next): batch 4, a 1024-token prompt, one
               make_prefill_step then 32 make_decode_step calls with greedy
               tokens.  The K4/K5 counters are zeroed just before and read
               just after: K4 must launch once per llama layer (28), all
               on the tensor-core route, K5 once per rwkv layer (32).
               Prefill ms, decode ms per token, tok/s, then one profiled
               prefill and 4 profiled decode steps for the device's busy
               share and its top operations;
  7. kernels — K4 and K5 against their plain versions on the inputs the
               llm run gave them (layer 0's q/k/v; layer 0's r/k/v/logw),
               timed as in phase 4, with SDPA as K4's library yardstick
               (K4's entry names its route, ``kernel_route``);
  8. cpu     — prefill and 8 decode steps at .reduced() width on the card
               and on the CPU (plain versions), both families, float32
               (logits and caches within 1e-4) and bfloat16 (within 5e-2 of
               the largest magnitude).

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(K1-K5), one ``{"server": ...}`` line, one ``{"llm": ...}`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, it prints no result and exits
non-zero.
"""
from __future__ import annotations

import dataclasses
import json
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
LLM_BATCH, LLM_PROMPT, LLM_DECODE, LLM_SEED = 4, 1024, 32, 0


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_ms(prof) -> float:
    """Device milliseconds of every kernel and copy a profile recorded."""
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def timed(fn, reps=20, warm=3):
    """Milliseconds per call of ``fn`` with the L2 cache cold, after
    ``warm`` calls: ``(device, events)``.  Before every call a 128 MiB
    buffer is zeroed, which evicts the card's 50 MB L2, so repeated calls
    on one input cannot run from L2.  ``events`` brackets each call with
    two CUDA events (launch gaps the host leaves count); ``device`` is the
    call's kernels' and copies' own time from the profiler (CUPTI), less
    the zeroing, or None where the profiler records no device time."""
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
    return (dev if device_ms(alone) > 0 else None), event_ms


def timing(kernel, plain, library=None) -> dict:
    """The kernel line's time fields: device time where the profiler has
    it, else the event time (``timed_by`` says which), and the event time
    of the kernel beside it."""
    k_dev, k_ev = timed(kernel)
    p_dev, p_ev = timed(plain, reps=5)
    l_dev, l_ev = timed(library) if library is not None else (None, None)
    by_device = k_dev is not None
    return dict(ms=k_dev if by_device else k_ev,
                plain_ms=p_dev if by_device else p_ev,
                library_ms=(None if library is None
                            else l_dev if by_device else l_ev),
                timed_by="profiler" if by_device else "events",
                event_ms=k_ev)


def k2_entry(torch, g_ops, g_ref, rows, idx):
    """K2 on (rows, idx): bit-exact against its plain version, timed beside
    it, ``index_select`` and the bytes bound."""
    if not torch.equal(g_ops.gather_rows(rows, idx),
                       g_ref.gather_rows_ref(rows, idx)):
        raise AssertionError(f"K2 differs on {tuple(rows.shape)}")
    rb = rows.shape[1] * rows.element_size()
    n = idx.shape[0]
    # bound_ms counts a row read for every index, as the earlier slices
    # did; bound_distinct_ms reads each row the indices name once
    n_read = int(torch.unique(idx[(idx >= 0) & (idx < rows.shape[0])]).numel())
    return dict(**timing(lambda: g_ops.gather_rows(rows, idx),
                         lambda: g_ref.gather_rows_ref(rows, idx),
                         lambda: torch.index_select(rows, 0, idx)),
                bound_ms=n * (8 + 2 * rb) / HBM_BYTES_S * 1e3,
                bound_distinct_ms=(n * (idx.element_size() + rb)
                                   + n_read * rb) / HBM_BYTES_S * 1e3,
                bound_by="bytes",
                shape=f"table={tuple(rows.shape)} {rows.dtype} idx={n} "
                      f"distinct={n_read}")


def k3_entry(torch, s_ops, msgs, dst, n_seg):
    """K3 on (msgs, dst, n_seg) within 1e-5 of the largest sum of its plain
    version, timed beside it, ``index_add_`` and the bytes bound."""
    from repro_torch.kernels.segment_agg import ref as s_ref
    got = s_ops.segment_sum(msgs, dst, n_seg)
    torch.cuda.synchronize()
    want = s_ref.segment_sum_ref(msgs, dst, n_seg)
    err = float((got - want).abs().max())
    if err > 1e-5 * max(float(want.abs().max()), 1.0):
        raise AssertionError(f"K3 differs by {err} on {tuple(msgs.shape)}")
    E, D = msgs.shape
    valid = (dst >= 0) & (dst < n_seg)

    def library():
        out = torch.zeros(n_seg, D, device=msgs.device)
        return out.index_add_(0, dst[valid], msgs[valid].float())
    return dict(max_abs_err=err,
                **timing(lambda: s_ops.segment_sum(msgs, dst, n_seg),
                         lambda: s_ref.segment_sum_ref(msgs, dst, n_seg),
                         library),
                bound_ms=(E * D * msgs.element_size() + E * dst.element_size()
                          + n_seg * D * 4) / HBM_BYTES_S * 1e3,
                bound_by="bytes",
                shape=f"E={E} D={D} n_segments={n_seg}")


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

    def k4(dtype, tol, S, T, hd, G, causal, q_offset=0):
        K = 2
        H = K * G
        qkv = torch.randn(2, max(S, T), H + 2 * K, hd, generator=gen,
                          device=dev).to(dtype)
        q, k, v = qkv[:, :S, :H], qkv[:, :T, H:H + K], qkv[:, :T, H + K:]
        route = ("tensor_cores" if dtype == torch.bfloat16 and hd >= 64
                 else "cuda_cores")
        before = fa_ops.route_launches[route]
        got = fa_ops.flash_attention(q, k, v, causal, q_offset)
        torch.cuda.synchronize()
        err = float((got.float() - fa_ref.attention_ref(
            q, k, v, causal, q_offset).float()).abs().max())
        case = (f"S={S} T={T} hd={hd} G={G} causal={causal} "
                f"q_offset={q_offset} {dtype}")
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
    return {e.key[:60]: e.self_device_time_total / 1e3 / per
            for e in sorted(prof.key_averages(),
                            key=lambda e: -e.self_device_time_total)[:n]}


def run_llm(torch, dev, cfg, counters):
    """Prefill then greedy decode of one model (section 6 of the
    docstring).  Returns (report, first K4/K5 call's inputs)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import attention, lm, rwkv6, steps

    name = cfg.name
    B, P, N = LLM_BATCH, LLM_PROMPT, LLM_DECODE
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(LLM_SEED)
    params = lm.init_params(gen, cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    prefill = steps.make_prefill_step(cfg, extra_len=N + 4)
    decode = steps.make_decode_step(cfg)
    # warm-up outside the counted run: kernels loaded, cuBLAS handles made
    _, c = prefill(params, {"tokens": prompt[:, :64]})
    decode(params, c, prompt[:, :1], 64)
    del c
    torch.cuda.synchronize()

    seen = {}

    def recorder(key, fn):
        def call(*a, **kw):
            seen.setdefault(key, (a, kw))
            return fn(*a, **kw)
        return call
    fa, wk = attention.flash_attention, rwkv6.wkv
    attention.flash_attention = recorder("K4", fa)
    rwkv6.wkv = recorder("K5", wk)
    try:
        for m in counters.values():
            m.launches = 0
        fa_ops = counters["K4"]
        fa_ops.route_launches = dict.fromkeys(fa_ops.ROUTES, 0)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompt})
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
    finally:
        attention.flash_attention, rwkv6.wkv = fa, wk
    want = {"K4": cfg.n_layers if cfg.block == "attn" else 0,
            "K5": cfg.n_layers if cfg.block == "rwkv" else 0}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    # a bf16 model's K4 launches all take the tensor-core route
    want_routes = {"tensor_cores": want["K4"], "cuda_cores": 0}
    if k4_routes != want_routes:
        raise AssertionError(f"{name}: K4 routes {k4_routes}, expected "
                             f"{want_routes}")
    tokens = torch.cat(out, dim=1)
    if logits.shape != (B, cfg.vocab) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{name}: logits {tuple(logits.shape)} are "
                             "misshapen or not finite")
    if not bool(((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"{name}: greedy tokens out of range")
    for k, a in cache.items():
        if not bool(torch.isfinite(a.float()).all()):
            raise AssertionError(f"{name}: cache {k} is not finite")

    # one profiled prefill and 4 profiled decode steps: busy share, top ops
    with profile(activities=[ProfilerActivity.CUDA]) as pp:
        ta = time.perf_counter()
        prefill(params, {"tokens": prompt})
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
        "prefill_tok_s": B * P / (t1 - t0),
        "decode_ms_per_token": (t2 - t1) * 1e3 / N,
        "decode_tok_s": B * N / (t2 - t1),
        "launches": launches, "k4_routes": k4_routes,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "prefill_device_busy_share": device_ms(pp) / ((tb - ta) * 1e3),
        "decode_device_busy_share": device_ms(pd) / ((td - tc) * 1e3),
        "prefill_device_ms_by_op": top_ops(pp),
        "decode_device_ms_per_token_by_op": top_ops(pd, per=4),
        "sample": tokens[0, :8].tolist()}
    log(f"[llm] {report}")
    del params, cache, logits, prefill, decode
    torch.cuda.empty_cache()
    return report, seen


def llm_kernels(torch, F, inputs, report, fa_ops, fa_ref, wkv_ops, wkv_ref):
    """K4 and K5 on the inputs the llm run gave them (layer 0), against
    their plain versions, timed, with their bounds."""
    (q, k, v), kw = inputs["K4"]
    causal, q_offset = kw.get("causal", True), kw.get("q_offset", 0)
    got = fa_ops.flash_attention(q, k, v, causal, q_offset)
    torch.cuda.synchronize()
    err = float((got.float() - fa_ref.attention_ref(
        q, k, v, causal, q_offset).float()).abs().max())
    if not err <= 2e-2:
        raise AssertionError(f"K4 differs on the llama3.2-3b inputs: {err}")
    B, S, H, hd = q.shape
    k4_route = fa_ops.pick_route(q.dtype, hd, [(t.data_ptr(), t.shape,
                                                t.stride()) for t in (q, k, v)])
    if k4_route != "tensor_cores":
        raise AssertionError(f"K4 takes the {k4_route} route on the "
                             "llama3.2-3b inputs")
    T, K = k.shape[1], k.shape[2]
    pairs = (sum(min(T, q_offset + i + 1) for i in range(S)) if causal
             else S * T)
    byts = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    ops = 4 * B * H * hd * pairs
    t_b, t_o = byts / HBM_BYTES_S * 1e3, ops / BF16_OPS_S * 1e3

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)
    k4 = dict(
        name="flash_attention", route="cuda", kernel_route=k4_route,
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:64",
        launches=report["llama3.2-3b"]["launches"]["K4"], max_abs_err=err,
        **timing(lambda: fa_ops.flash_attention(q, k, v, causal, q_offset),
                 lambda: fa_ref.attention_ref(q, k, v, causal, q_offset),
                 sdpa),
        bound_ms=max(t_b, t_o), bound_by="bytes" if t_b > t_o else
        "operations",
        shape=f"q={tuple(q.shape)} kv={tuple(k.shape)} {q.dtype} "
              f"causal={causal}")

    (r, kk, vv, logw, u, s0), _ = inputs["K5"]
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
    return [k4, k5]


def phase_cpu_llm(torch, dev):
    """Prefill and 8 greedy decode steps at .reduced() width on the card
    and on the CPU from the same parameters and tokens.  Returns the largest
    logit difference per (config, dtype)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm, steps
    errs = {}
    for name in LLM_ARCHS:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
            card, cpu = (lm.init_params(torch.Generator().manual_seed(7), cfg,
                                        device=d) for d in (dev, "cpu"))
            tok = torch.randint(0, cfg.vocab, (4, 24),
                                generator=torch.Generator().manual_seed(8))
            pre = steps.make_prefill_step(cfg, q_chunk=16, extra_len=8)
            dec = steps.make_decode_step(cfg)
            (la, ca), (lb, cb) = (pre(card, {"tokens": tok.to(dev)}),
                                  pre(cpu, {"tokens": tok}))
            worst = 0.0
            for i in range(9):
                for what, a, b in [("logits", la, lb)] + [
                        (k, ca[k], cb[k]) for k in sorted(cb)]:
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
                (la, ca), (lb, cb) = (dec(card, ca, nxt.to(dev), 24 + i),
                                      dec(cpu, cb, nxt, 24 + i))
            errs[f"{name}/{dtype}"] = worst
    log(f"[cpu] reduced LM prefill + decode, card vs CPU, max |logit err| "
        f"{errs}")
    return errs


def serve(srv, workload):
    futs = [srv.submit(s, k, t) for s, t, k in workload]
    stats = srv.flush()
    return stats, [f.result() for f in futs]


def main():
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available; nothing was run")
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        log(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout")
        return 3
    sys.path.insert(0, SRC)
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
    libs = build.build_all()
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        regs = [ln.strip() for ln in
                path.with_suffix(".log").read_text().splitlines()
                if "registers" in ln or "arning" in ln
                or "Performance Loss" in ln or (
                    "spill" in ln and ", 0 bytes spill stores, 0 bytes "
                    "spill loads" not in ln)]
        log(f"[build] {name}: " + (" | ".join(regs) or "(cached)"))

    # --- 2. edge cases -------------------------------------------------------
    ops, refs = (g_ops, s_ops, l_ops), (g_ref, s_ref, l_ref)
    phase_edges(torch, dev, ops, refs)
    log("[edges] K1, K2, K3 agree with their plain versions")
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
        B = len(seen_ids[0])
        with cache._table_lock:
            loc_np = cache.loc
            lk_args = (torch.from_numpy(seen_ids[0].astype("int32")).to(dev),
                       cache._loc_dev, cache._slot_dev)
            dt, ht = cache.device_tier, cache.host_tier
        got = l_ops.fused_cache_lookup(*lk_args, dt, ht)
        torch.cuda.synchronize()
        want = l_ref.fused_lookup_ref(*lk_args, dt, ht)
        for k, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a, b):
                raise AssertionError(f"K1 output {k} differs on served ids")
        tiers = loc_np[seen_ids[0]]
        rb = store.row_bytes
        hbm = B * (4 + 8 + rb + 5 * 4) + int((tiers == 0).sum()) * rb
        pcie = int((tiers == 1).sum()) * rb
        b1 = max(hbm / HBM_BYTES_S, pcie / PCIE_BYTES_S) * 1e3
        kernels.append(dict(
            name="fused_cache_lookup", route="cuda",
            source="src/repro_torch/csrc/cache_lookup.cu",
            replaces="src/repro/kernels/cache_lookup/cache_lookup.py:106",
            launches=launches["K1"], max_abs_err=0.0,
            **timing(lambda: l_ops.fused_cache_lookup(*lk_args, dt, ht),
                     lambda: l_ref.fused_lookup_ref(*lk_args, dt, ht)),
            bound_ms=b1, bound_by="bytes",
            shape=f"B={B} D={store.row_dim} dev_hits="
                  f"{int((tiers == 0).sum())} host_hits="
                  f"{int((tiers == 1).sum())}"))

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
            **k3_entry(torch, s_ops, msgs, dst, feats.shape[0]),
            layer2=k3_entry(torch, s_ops,
                            *seen_layer[("K3", CFG["hidden"])])))
        params = {"layers": [{k: v.cpu() for k, v in lp.items()}
                             for lp in srv.params["layers"]],
                  "head": {k: v.cpu() for k, v in srv.params["head"].items()}}

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
    shutil.rmtree(DATA, ignore_errors=True)

    # --- 6. LM serving at full width, one model after the other -------------
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    counters = {"K4": fa_ops, "K5": wkv_ops}
    llm, inputs = {}, {}
    for name in LLM_ARCHS:
        t0 = time.perf_counter()
        llm[name], seen = run_llm(torch, dev, get_config(name), counters)
        inputs.update(seen)
        log(f"[llm] {name} done in {time.perf_counter() - t0:.1f} s")

    # --- 7. K4, K5 on the llm run's own inputs -----------------------------
    kernels += llm_kernels(torch, F, inputs, llm, fa_ops, fa_ref, wkv_ops,
                           wkv_ref)
    del inputs
    torch.cuda.empty_cache()

    # --- 8. reduced LMs on the card against the CPU ------------------------
    llm["cpu_max_abs_logit_err"] = phase_cpu_llm(torch, dev)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"server": server, "card": smi}))
    print(json.dumps({"llm": llm, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
