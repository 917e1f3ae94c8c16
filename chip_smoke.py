#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GNN inference-serving path on one card.

    python3 chip_smoke.py

Imports nothing of JAX and nothing of the reference package.  Phases; any
failure raises and the script exits non-zero:

  1. build   — compile every CUDA kernel of the path from src/repro_torch/
               csrc with nvcc for sm_90a (one process per source, at once);
  2. edges   — each kernel against its plain PyTorch version on the card
               at the edge cases (B=1, empty tiers, duplicate-heavy
               batches, odd widths, bf16, out-of-range segment ids);
  3. serve   — GNNInferenceServer on the IG-shaped graph (269,000
               vertices, 1024-dim f32 rows) with GraphSAGE at hidden 256,
               fanouts (10, 5), 64-seed requests, 8 per micro-batch: the
               launch counters are zeroed, the requests are submitted and
               flushed under the tracer (its serve.* spans split the wall
               time per micro-batch), and every kernel must have
               launched;
  4. kernels — each kernel against its plain version on the card on the
               inputs the serving run gave it (K1, K2 bit-exact; K3 within
               1e-5 of the largest sum), timed with the L2 cache cold
               (device time from the profiler, and CUDA events) beside its
               plain version, its bound and a PyTorch library call;
  5. cpu     — a fresh server on the CPU (plain versions, same
               parameters) serves the same requests: same answered/shed
               split, logits within 1e-4.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
one ``{"server": ...}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it prints no result and exits non-zero.
"""
from __future__ import annotations

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
CFG = dict(model="sage", hidden=256, fanouts=(10, 5), request_batch_size=64,
           max_batch_requests=8, mode="helios", device_cache_frac=0.05,
           host_cache_frac=0.10, chaos=None, seed=0)
REQUESTS, RATE = 64, 20_000     # 64-seed requests; open-loop virtual req/s
DATA = os.path.join(ROOT, "build", "smoke_data")    # IG-shaped store


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


def phase_edges(torch, dev, ops, refs):
    """Each kernel against its plain version at the edge cases."""
    g_ops, s_ops, l_ops = ops
    g_ref, s_ref, l_ref = refs
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for n, d, b in ((100, 7, 13), (64, 3, 1), (5, 3, 0), (300, 24, 33)):
            table = torch.randn(n, d, generator=gen).to(dtype).to(dev)
            idx = torch.randint(0, n, (b,), generator=gen).to(dev)
            for ix in (idx, idx.to(torch.int32)):
                got = g_ops.gather_rows(table, ix)
                torch.cuda.synchronize()
                if not torch.equal(got, g_ref.gather_rows_ref(table, ix)):
                    raise AssertionError(f"K2 differs at {(n, d, b, dtype)}")
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
    from repro_torch.kernels.gather import ops as g_ops
    from repro_torch.kernels.gather import ref as g_ref
    from repro_torch.kernels.segment_agg import ops as s_ops
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
                if "registers" in ln]
        log(f"[build] {name}: " + (" | ".join(regs) or "(cached)"))

    # --- 2. edge cases -------------------------------------------------------
    ops, refs = (g_ops, s_ops, l_ops), (g_ref, s_ref, l_ref)
    phase_edges(torch, dev, ops, refs)
    log("[edges] K1, K2, K3 agree with their plain versions")

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
        n_idx = idx.shape[0]
        kernels.append(dict(
            name="gather_rows", route="cuda",
            source="src/repro_torch/csrc/gather.cu",
            replaces="src/repro/kernels/gather/gather.py:59",
            launches=launches["K2"], max_abs_err=0.0,
            **timing(lambda: g_ops.gather_rows(rows, idx),
                     lambda: g_ref.gather_rows_ref(rows, idx),
                     lambda: torch.index_select(rows, 0, idx)),
            bound_ms=(n_idx * (8 + 2 * rb)) / HBM_BYTES_S * 1e3,
            bound_by="bytes",
            shape=f"table={tuple(rows.shape)} idx={n_idx}"))

        blk = micro.minibatches[0].blocks[-1]      # the first layer applied
        feats = got
        src = torch.from_numpy(blk.src_pos).to(dev)
        dst = torch.from_numpy(blk.dst_pos).to(dev)
        w = torch.from_numpy(blk.edge_mask).to(dev).to(torch.float32)
        msgs = g_ops.gather_rows(feats, src) * w[:, None]
        n_seg = feats.shape[0]
        got = s_ops.segment_sum(msgs, dst, n_seg)
        torch.cuda.synchronize()
        want = s_ref.segment_sum_ref(msgs, dst, n_seg)
        err = float((got - want).abs().max())
        if err > 1e-5 * max(float(want.abs().max()), 1.0):
            raise AssertionError(f"K3 differs on the served block: {err}")
        E, D = msgs.shape
        valid = (dst >= 0) & (dst < n_seg)

        def library():
            out = torch.zeros(n_seg, D, device=dev)
            return out.index_add_(0, dst[valid], msgs[valid])
        kernels.append(dict(
            name="segment_sum", route="cuda",
            source="src/repro_torch/csrc/segment_agg.cu",
            replaces="src/repro/kernels/segment_agg/segment_agg.py:32",
            launches=launches["K3"], max_abs_err=err,
            **timing(lambda: s_ops.segment_sum(msgs, dst, n_seg),
                     lambda: s_ref.segment_sum_ref(msgs, dst, n_seg),
                     library),
            bound_ms=(E * D * 4 + E * 4 + n_seg * D * 4) / HBM_BYTES_S * 1e3,
            bound_by="bytes",
            shape=f"E={E} D={D} n_segments={n_seg}"))
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

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"server": server, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
