"""Deep GNN-aware pipeline (paper §3.3, TPU-adapted).

The training procedure is decomposed into GPU-initiated operators —
``sample`` -> ``io_submit`` -> {``cache_lookup``, ``io_complete``} ->
``batch_build`` -> ``train``, plus ``cache_refresh`` riding the io
resource (the authoritative plan is ``gnn.train._operators``) — scheduled
on a two-level pipeline:

  * intra-mini-batch: operators of one mini-batch with no mutual dependency
    run concurrently (hop h+1 sampling overlaps hop h's storage IO);
  * inter-mini-batch: ``prefetch_depth`` mini-batches are in flight, so IO
    and host work for batch i+1 hide under device compute for batch i.

Resource budgets replace CUDA-MPS SM partitioning: each resource class
("io", "host", "device") has a bounded executor; the IO stack's worker
budget is the paper's "~30% of cores".  A virtual clock scheduler mirrors
the wall-clock execution so benchmark ratios follow the paper's hardware
envelope rather than container CPU noise.

Modes (for the paper's ablations):
  deep     — full two-level pipeline (Helios)
  nopipe   — all operators serial (Helios-NoPipe, Fig. 11)
  cpu      — CPU-managed staging, serial host prep then device train
             (Ginex/MariusGNN-style, Fig. 5/1(a))
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.core.simulator import VirtualClock
from repro_torch.obs import analyze as _analyze
from repro_torch.obs import trace as _trace


@dataclass
class Operator:
    """One GPU-initiated operator in the execution plan."""
    name: str
    fn: Callable[..., Any]
    resource: str                      # "io" | "host" | "device"
    deps: tuple = ()                   # names of ops in the same batch
    virtual_cost: Callable[..., float] | None = None  # returns seconds


@dataclass
class StageTiming:
    wall_s: float = 0.0
    virtual_s: float = 0.0
    calls: int = 0


class PipelineExecutor:
    """Two-level operator pipeline with bounded per-resource executors."""

    def __init__(self, plan: list[Operator], mode: str = "deep",
                 prefetch_depth: int = 2, io_workers: int = 2,
                 host_workers: int = 2):
        assert mode in ("deep", "nopipe", "cpu")
        self.plan = plan
        self.mode = mode
        self.prefetch_depth = prefetch_depth if mode == "deep" else 1
        self.pools = {
            "io": ThreadPoolExecutor(io_workers, "pipe-io"),
            "host": ThreadPoolExecutor(host_workers, "pipe-host"),
            "device": ThreadPoolExecutor(1, "pipe-dev"),   # one device stream
        }
        self.timings: dict[str, StageTiming] = {op.name: StageTiming()
                                                for op in plan}
        self.clock = VirtualClock()
        self.virtual_end = 0.0
        # always-on virtual busy time per LOGICAL resource (op.resource even
        # in serial modes) — feeds overlap efficiency / bubble attribution
        self.resource_busy: dict[str, float] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _run_op(self, op: Operator, ctx: dict, batch_idx: int, ready_at: float):
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            return self._run_op_traced(tr, op, ctx, batch_idx, ready_at)
        t0 = time.perf_counter()
        out = op.fn(ctx)
        self._account(op, ctx, time.perf_counter() - t0, ready_at)
        return out

    def _run_op_traced(self, tr, op: Operator, ctx: dict, batch_idx: int,
                       ready_at: float):
        """``_run_op`` inside an open ``pipe.<op>`` span, so every span the
        operator opens on this thread names it as parent.  The span gets
        the operator's wall and virtual interval when it returns; one that
        raises leaves no span."""
        cm = tr.span(f"pipe.{op.name}", track=op.resource, cat="pipe",
                     args={"batch": batch_idx, "resource": op.resource,
                           "deps": list(op.deps)})
        sp = cm.__enter__()
        t0 = time.perf_counter()
        try:
            out = op.fn(ctx)
        except BaseException:
            tr.drop(sp)
            raise
        t1 = time.perf_counter()
        end, virt = self._account(op, ctx, t1 - t0, ready_at)
        cm.__exit__(None, None, None)
        sp.t0, sp.t1 = t0 - tr.epoch, t1 - tr.epoch
        sp.set_virtual(end - virt, end)
        return out

    def _account(self, op: Operator, ctx: dict, wall: float,
                 ready_at: float) -> tuple:
        """Book one operator call: its stage timing and its slot on the
        virtual clock.  Returns ``(virtual end, virtual seconds)``."""
        virt = op.virtual_cost(ctx) if op.virtual_cost else wall
        with self._lock:
            st = self.timings[op.name]
            st.wall_s += wall
            st.calls += 1
            st.virtual_s += virt
            resource = op.resource if self.mode != "nopipe" else "serial"
            end = self.clock.schedule(resource, ready_at, virt)
            self.virtual_end = max(self.virtual_end, end)
            self.resource_busy[op.resource] = (
                self.resource_busy.get(op.resource, 0.0) + virt)
        ctx[f"__end_{op.name}"] = end
        return end, virt

    def _run_batch(self, batch_idx: int, ctx: dict, start_at: float) -> float:
        """Execute one mini-batch's operator DAG; returns virtual end time."""
        ends: dict[str, float] = {}
        if self.mode in ("nopipe", "cpu"):
            # strictly serial execution on one stream (the ablation baselines)
            t = start_at
            for op in self.plan:
                self._run_op(op, ctx, batch_idx, t)
                t = ctx[f"__end_{op.name}"]
                ends[op.name] = t
            return t

        done: dict[str, Future] = {}

        def runner(op: Operator):
            for d in op.deps:
                done[d].result()
            ready = max([start_at] + [ends[d] for d in op.deps])
            out = self._run_op(op, ctx, batch_idx, ready)
            ends[op.name] = ctx[f"__end_{op.name}"]
            return out

        for op in self.plan:
            done[op.name] = self.pools[op.resource].submit(runner, op)
        for f in done.values():
            f.result()
        return max(ends.values()) if ends else start_at

    # ------------------------------------------------------------------
    def run(self, make_ctx: Callable[[int], dict], n_batches: int) -> dict:
        """Drive ``n_batches`` through the pipeline; returns metrics."""
        t0 = time.perf_counter()
        inflight: list[Future] = []
        starts: dict[int, float] = {}
        results = []

        def launch(i):
            ctx = make_ctx(i)
            # inter-batch: batch i may start once batch i-prefetch_depth done
            start_at = starts.get(i - self.prefetch_depth, 0.0)
            end = self._run_batch(i, ctx, start_at)
            starts[i] = end
            return end

        if self.mode == "deep":
            pool = ThreadPoolExecutor(self.prefetch_depth, "pipe-batch")
            for i in range(n_batches):
                inflight.append(pool.submit(launch, i))
                while len(inflight) >= self.prefetch_depth:
                    results.append(inflight.pop(0).result())
            results += [f.result() for f in inflight]
            pool.shutdown()
        else:
            for i in range(n_batches):
                results.append(launch(i))

        wall = time.perf_counter() - t0
        return {
            "mode": self.mode,
            "n_batches": n_batches,
            "wall_s": wall,
            "virtual_s": self.virtual_end,
            "virtual_per_batch_s": self.virtual_end / max(n_batches, 1),
            "stages": {k: {"wall_s": v.wall_s, "virtual_s": v.virtual_s,
                           "calls": v.calls}
                       for k, v in self.timings.items()},
            "overlap": self.overlap_report(),
        }

    def overlap_report(self) -> dict:
        """Overlap efficiency / compute-bubble fraction from the always-on
        per-resource busy accounting (no tracer required)."""
        with self._lock:
            busy = dict(self.resource_busy)
            makespan = self.virtual_end
        return _analyze.overlap_report(busy, makespan)

    def close(self):
        for p in self.pools.values():
            p.shutdown(wait=False)
