"""Out-of-core GNN trainer — the paper's end-to-end system (§3, Fig. 3/4).

Wires together every Helios component:
  topology  -> host tier (CSRGraph)
  features  -> 3-tier HeteroCache over the FeatureStore ("SSDs")
  IO        -> AsyncIOEngine (or Sync/CPU-managed baselines)
  schedule  -> PipelineExecutor with the deep GNN-aware operator plan
  compute   -> GraphSAGE/GCN step (eager autograd, K2/K3 both ways)

``mode`` selects the system under test for the paper's ablations:
  helios        deep pipeline + async IO + hetero cache
  helios-nopipe serial operators (Fig. 11)
  helios-nocache no device/host feature cache (Figs. 8/9)
  gids          sync coupled IO, device-only cache (Fig. 5)
  cpu           CPU-managed staging (Ginex/MariusGNN-like, Fig. 5)

PyTorch port of ``repro.gnn.train``.  ``TrainerConfig.device`` (default
``"cuda"``) places every cache's device tier, the parameters, the
optimizer state and the step; ``device="cpu"`` runs all of it on the CPU
with the kernels' plain versions.  The operator plan, the virtual costs
and the report keys are the reference's.  On the card the fused lookup
(K1) lands the gathered rows on the device, so batch build copies only
the index tensors and labels, through pinned memory, in one transfer.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import hotness as hotness_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.hetero_cache import HeteroCache, tier_rows
from repro_torch.core.iostack import FeatureStore, make_engine
from repro_torch.core.pipeline import Operator, PipelineExecutor
from repro_torch.core.policy import make_policy
from repro_torch.core.simulator import (DEFAULT_ENVELOPE, HOST_STAGE_BW,
                                  MATMUL_RATE, SAMPLE_RATE_CPU,
                                  SAMPLE_RATE_DEVICE, pcie_time)
from repro_torch.gnn.graph import CSRGraph
from repro_torch.gnn.models import init_gnn_params, make_gnn_train_step
from repro_torch.gnn.sampling import NeighborSampler, draw_unique
from repro_torch.obs import analyze as _analyze
from repro_torch.obs import trace as _trace
from repro_torch.train.optim import adamw


def _host(rows) -> np.ndarray:
    """A cache's gathered rows (a tensor on its device) as host numpy."""
    return rows.cpu().numpy()


@dataclass
class TrainerConfig:
    model: str = "sage"            # sage | gcn
    hidden: int = 256
    batch_size: int = 1024
    fanouts: tuple = (25, 10)
    mode: str = "helios"
    device_cache_frac: float = 0.05
    host_cache_frac: float = 0.10
    prefetch_depth: int = 2
    io_worker_budget: float = 0.3
    presample_batches: int = 8
    cache_policy: str = "static"   # static | online (core.policy)
    fused_lookup: bool = True      # fused plan+dedup+tier-split cache lookup
                                   # with deduplicated miss lists (PR 7);
                                   # False = PR-3 host plan() ablation
    refresh_every: int = 8         # batches between refresh checks (online)
    prefetch_rows: int = 0         # predicted-hot rows pulled per batch by
                                   # the prefetch operator (0 = disabled)
    policy_half_life: float = 16.0
    policy_hysteresis: float = 0.1
    lr: float = 1e-3
    # trainable embeddings (the write-path workload): gradient-updated
    # feature rows ride the cache's write-back tiers; requires a store
    # opened with writable=True
    train_embeddings: bool = False
    embedding_lr: float = 0.05
    embedding_momentum: float = 0.0  # SGD momentum over the embedding rows;
                                   # >0 keeps per-row velocity in a SECOND
                                   # mutable table (its own store + cache)
                                   # riding the same write-back/flush path
    embedding_adam: float = 0.0    # Adam beta2: >0 keeps the per-row second
                                   # moment in a THIRD mutable table on the
                                   # same write-back/flush path; combines
                                   # with embedding_momentum as beta1-style
                                   # velocity (lazy sparse Adam)
    embedding_adam_eps: float = 1e-8
    embedding_flush_every: int = 0  # batches between flush barriers
                                   # (0 = flush only at epoch end / demote)
    write_policy: str = "writeback"  # writeback | writethrough (ablation)
    write_combine_rows: int = 0    # coalesce flush-on-demote batches smaller
                                   # than this into one combined ticket
                                   # (0 = one ticket per demotion batch)
    # fault injection + recovery (ft.chaos): "env" reads HELIOS_CHAOS,
    # None disables, or pass a ChaosSchedule; the retry knobs build one
    # RetryPolicy shared by the feature/optimizer-table engines
    chaos: object | None = "env"
    io_deadline_s: float | None = None  # per-attempt virtual deadline
    io_max_retries: int = 4
    io_backoff_s: float = 1e-3     # exponential backoff base (virtual s)
    # per-stream-class shard scheduling + back-pressure (docs/streams.md):
    # "wfq" = strict demand priority over a weighted-fair bulk tail,
    # "fifo" = the pre-congestion-control arrival order (ablation);
    # io_qwait_high_s engages prefetch/checkpoint throttling when demand
    # p99 queue delay (virtual s) crosses it, io_qwait_low_s releases
    # (None = high/2; both None = back-pressure off)
    io_sched: str = "wfq"
    io_class_weights: dict | None = None
    io_qwait_high_s: float | None = None
    io_qwait_low_s: float | None = None
    seed: int = 0
    device: str = "cuda"           # where the caches' device tiers, the
                                   # parameters and the step live

    def retry_policy(self):
        from repro_torch.ft.chaos import DEFAULT_RETRY, RetryPolicy
        if (self.io_deadline_s is None and self.io_max_retries == 4
                and self.io_backoff_s == 1e-3):
            return DEFAULT_RETRY
        return RetryPolicy(max_retries=self.io_max_retries,
                           backoff_base_s=self.io_backoff_s,
                           deadline_s=self.io_deadline_s)


class TrainableEmbeddingTable:
    """Trainable node embeddings living in the FeatureStore.

    The feature rows ARE the learnable parameters (MariusGNN-style
    out-of-core embedding training): each step applies the SGD delta
    ``-lr * dL/dfeats`` through ``HeteroCache.apply_delta`` — a
    read-modify-write against the LIVE row value, so concurrent pipeline
    batches that touch the same hot rows compose their updates instead of
    overwriting each other with stale absolute values.  Hot rows mutate in
    their cache tier and ride flush-on-demote; cold rows write through.
    The epoch-boundary ``flush()`` barrier makes storage authoritative for
    checkpointing."""

    def __init__(self, cache: HeteroCache, lr: float,
                 momentum_cache: HeteroCache | None = None,
                 momentum: float = 0.0,
                 adam_cache: HeteroCache | None = None,
                 adam_beta2: float = 0.0, adam_eps: float = 1e-8):
        self.cache = cache
        self.lr = lr
        # optimizer state as SIBLING mutable tables: per-row velocity (and,
        # for Adam, the per-row second moment) lives in its own store
        # behind its own write-back cache, so optimizer rows ride
        # flush-on-demote / epoch barriers exactly like the embedding rows
        # they accelerate
        self.mom = momentum_cache
        self.mu = momentum
        self.v2 = adam_cache
        self.b2 = adam_beta2
        self.eps = adam_eps
        self._t = 0                     # global step for bias correction
        self._mu_lock = threading.Lock()

    def apply_grads(self, ids: np.ndarray, grads: np.ndarray,
                    wait: bool = True):
        """``wait=False`` leaves the storage write-through ticket in
        flight (split-phase) — the caller completes it a batch later via
        ``cache.complete_write``, hiding the write under device compute."""
        grads = np.asarray(grads)
        if self.mom is None and self.v2 is None:
            return self.cache.apply_delta(ids, -self.lr * grads, wait=wait)
        # optimizer-state RMW (duplicate ids contribute their summed
        # gradient, matching apply_delta's own dup rule).  The lock makes
        # the read-update-write atomic against concurrent pipeline batches
        # sharing hot rows.
        ids = np.asarray(ids)
        uniq, inv = np.unique(ids, return_inverse=True)
        summed = np.zeros((len(uniq), grads.shape[1]), grads.dtype)
        np.add.at(summed, inv, grads)
        with self._mu_lock:
            if self.mom is not None:
                # velocity: v <- mu*v + g
                v = self.mu * _host(self.mom.gather(uniq)) + summed
                self.mom.write_planned(uniq, v)
            else:
                v = summed
            if self.v2 is None:
                delta = -self.lr * v
            else:
                # lazy sparse Adam: the second moment updates only for rows
                # present in the batch, and bias correction uses the GLOBAL
                # step (per-row step counts are not tracked — the standard
                # out-of-core embedding compromise)
                self._t += 1
                m2 = (self.b2 * _host(self.v2.gather(uniq))
                      + (1.0 - self.b2) * summed ** 2)
                self.v2.write_planned(uniq, m2)
                denom = np.sqrt(m2 / (1.0 - self.b2 ** self._t)) + self.eps
                delta = -self.lr * v / denom
        return self.cache.apply_delta(uniq, delta, wait=wait)


class OutOfCoreGNNTrainer:
    def __init__(self, graph: CSRGraph, store: FeatureStore,
                 cfg: TrainerConfig | None = None):
        cfg = cfg if cfg is not None else TrainerConfig()
        # resolved first: no card for device="cuda" raises before any
        # engine thread starts
        self.device = resolve_device(cfg.device)
        self.g, self.store, self.cfg = graph, store, cfg
        if cfg.train_embeddings and not store.writable:
            raise ValueError("train_embeddings needs a FeatureStore opened "
                             "with writable=True (the embedding rows are "
                             "the parameters)")
        self.sampler = NeighborSampler(graph, cfg.fanouts, cfg.seed)

        # --- IO engine per mode ------------------------------------------
        self.io = make_engine(cfg.mode, store, cfg.io_worker_budget,
                              chaos=cfg.chaos, retry=cfg.retry_policy(),
                              sched=cfg.io_sched,
                              class_weights=cfg.io_class_weights,
                              qwait_high_s=cfg.io_qwait_high_s,
                              qwait_low_s=cfg.io_qwait_low_s)

        # --- hotness pre-sampling + cache placement (paper §3.2.2) -------
        # presample on a SEPARATE sampler so the training sampler's rng
        # stream doesn't depend on the presample configuration
        hot = hotness_mod.presample_gnn(
            NeighborSampler(graph, cfg.fanouts, cfg.seed + 1),
            cfg.batch_size, cfg.presample_batches,
            graph.n_vertices, cfg.seed)
        dev_rows, host_rows = tier_rows(cfg.mode, graph.n_vertices,
                                        cfg.device_cache_frac,
                                        cfg.host_cache_frac)
        policy = make_policy(cfg.cache_policy, graph.n_vertices,
                             presample=hot, refresh_every=cfg.refresh_every,
                             half_life=cfg.policy_half_life,
                             hysteresis=cfg.policy_hysteresis)
        self.cache = HeteroCache(store, None, dev_rows, host_rows, self.io,
                                 policy=policy,
                                 write_policy=cfg.write_policy,
                                 write_combine_rows=cfg.write_combine_rows,
                                 fused=cfg.fused_lookup,
                                 device=self.device)

        # --- model + optimizer -------------------------------------------
        self.params = init_gnn_params(
            torch.Generator().manual_seed(cfg.seed), cfg.model,
            store.row_dim, cfg.hidden, graph.n_classes, device=self.device)
        self.opt = adamw(cfg.lr)
        self.state = {"params": self.params, "opt": self.opt.init(self.params)}
        self.step_fn = make_gnn_train_step(
            cfg.model, self.opt, cfg.batch_size,
            embedding_grads=cfg.train_embeddings)
        # optimizer-state tables: per-row velocity (momentum) and second
        # moment (Adam) in their own writable stores (zero-initialised
        # memmaps) behind host-tier write-back caches — the same
        # mutable-tier machinery, sibling instances
        def _opt_table(suffix):
            st = FeatureStore(store.path + suffix, store.n_rows,
                              store.row_dim, dtype=store.dtype,
                              n_shards=store.n_shards,
                              create=True, writable=True)
            c = HeteroCache(
                st, None, 0, host_rows,
                make_engine(cfg.mode, st, cfg.io_worker_budget,
                            chaos=cfg.chaos, retry=cfg.retry_policy(),
                            sched=cfg.io_sched,
                            class_weights=cfg.io_class_weights,
                            qwait_high_s=cfg.io_qwait_high_s,
                            qwait_low_s=cfg.io_qwait_low_s),
                write_policy=cfg.write_policy,
                write_combine_rows=cfg.write_combine_rows,
                fused=cfg.fused_lookup,
                device=self.device)
            c._owns_engine = True
            return st, c

        self.mom_store = self.mom_cache = None
        self.adam_store = self.adam_cache = None
        if cfg.train_embeddings and cfg.embedding_momentum > 0.0:
            self.mom_store, self.mom_cache = _opt_table("_momentum")
        if cfg.train_embeddings and cfg.embedding_adam > 0.0:
            self.adam_store, self.adam_cache = _opt_table("_adam")
        self.embeddings = (TrainableEmbeddingTable(self.cache,
                                                   cfg.embedding_lr,
                                                   self.mom_cache,
                                                   cfg.embedding_momentum,
                                                   self.adam_cache,
                                                   cfg.embedding_adam,
                                                   cfg.embedding_adam_eps)
                           if cfg.train_embeddings else None)
        self.metrics_log = []
        # double-buffered prefetch: the ticket issued for batch i stays in
        # flight until batch i+1's operator completes it
        self._pf_pending = None
        self._pf_lock = threading.Lock()
        self._wb_batches = 0
        # split-phase embedding write-back: batch i's storage ticket stays
        # in flight until batch i+1's operator completes it
        self._wb_pending = None

    # -----------------------------------------------------------------
    def _operators(self):
        cfg = self.cfg
        env = DEFAULT_ENVELOPE

        def op_sample(ctx):
            ctx["mb"] = self.sampler.sample(ctx["seeds"])

        # the tier plan, the gathers, and the stats accounting all live in
        # HeteroCache's split-phase API — the operators only phase it
        def op_io_submit(ctx):
            mb = ctx["mb"]
            ctx["pending"] = self.cache.submit_planned(mb.all_nodes,
                                                       n_rows=len(mb.nodes))

        def op_cache_lookup(ctx):
            self.cache.lookup_planned(ctx["pending"])

        def op_io_complete(ctx):
            # the wait for the batch's reads, apart from landing them (the
            # tickets are futures: complete_planned's own wait then returns
            # at once)
            pg = ctx["pending"]
            with _trace.phase("pipe.io_complete.wait", batch=ctx["batch"],
                              storage_rows=pg.n_storage,
                              remote_rows=pg.n_remote):
                for ticket in (pg.rticket, pg.ticket):
                    if ticket is not None:
                        ticket.wait()
            with _trace.phase("pipe.io_complete.land", batch=ctx["batch"],
                              rows=pg.n_storage + pg.n_remote):
                ctx["out"] = self.cache.complete_planned(pg)

        def op_cache_refresh(ctx):
            # asynchronous tier migration on the io resource: placement
            # updates hide under the device's batch_build/train work
            ctx["refresh"] = self.cache.maybe_refresh()

        def op_prefetch(ctx):
            # policy-driven prefetch on the io resource, double-buffered:
            # this batch ISSUES its admission ticket without waiting and
            # COMPLETES the ticket the previous batch left in flight, so
            # the admission read hides under a whole batch of other work
            # instead of blocking inside the operator
            with self._pf_lock:
                prev, self._pf_pending = (
                    self._pf_pending,
                    self.cache.maybe_prefetch(cfg.prefetch_rows, wait=False))
            if prev is not None:
                ctx["prefetch"] = self.cache.complete_prefetch(prev)

        def op_batch_build(ctx):
            # the gathered rows are already on the device; the index
            # tensors and labels cross in ONE copy from pinned memory
            mb = ctx["mb"]
            ctx["feats"] = ctx["out"]
            parts = ([b.src_pos for b in mb.blocks]
                     + [b.dst_pos for b in mb.blocks]
                     + [b.edge_mask for b in mb.blocks] + [mb.labels])
            flat = torch.from_numpy(np.concatenate(
                [np.asarray(a, np.int32) for a in parts]))
            if self.device.type == "cuda":
                flat = flat.pin_memory().to(self.device, non_blocking=True)
            t = list(torch.split(flat, [len(a) for a in parts]))
            nb = len(mb.blocks)
            ctx["tensors"] = (
                tuple(t[:nb]), tuple(t[nb:2 * nb]),
                tuple(m.bool() for m in t[2 * nb:3 * nb]), t[3 * nb],
            )

        def op_train(ctx):
            src, dst, em, labels = ctx["tensors"]
            # the host's dispatch of the step, then its wait for the
            # device: the metrics (and the feature gradient) to the host
            with _trace.phase("pipe.train.dispatch", batch=ctx["batch"],
                              seeds=len(ctx["mb"].seeds)):
                res = self.step_fn(self.state, ctx["feats"], src, dst, em,
                                   labels)
            self.state, m = res[0], res[1]
            with _trace.phase("pipe.train.sync", batch=ctx["batch"],
                              values=len(m)):
                if cfg.train_embeddings:
                    # node_mask is a prefix (the sampler puts every real
                    # node first): only those rows cross to the host
                    n_real = int(ctx["mb"].node_mask.sum())
                    ctx["feat_grad"] = _host(res[2][:n_real])
                ctx["metrics"] = {k: float(v) for k, v in m.items()}
            self.metrics_log.append(ctx["metrics"])

        def op_embedding_writeback(ctx):
            # gradient-updated embedding rows ride the cache write path on
            # the io resource, SPLIT-PHASE: resident rows mutate in their
            # tier at submit (dirty; flush-on-demote / epoch flush covers
            # storage), cold rows' write-through ticket stays IN FLIGHT
            # across pipeline batches — this batch submits its own ticket
            # and completes the one the previous batch left pending, so
            # the storage write hides under a whole batch of other work
            mb = ctx["mb"]
            mask = mb.node_mask
            # the RMW read inside apply_grads blocks on a storage ticket —
            # keep it OUTSIDE _pf_lock so the prefetch operator (which
            # contends on the same lock for its double-buffer swap) never
            # serializes behind it
            pw = self.embeddings.apply_grads(mb.nodes[mask],
                                             ctx["feat_grad"],
                                             wait=False)
            with self._pf_lock:
                prev, self._wb_pending = self._wb_pending, pw
                ctx["writeback"] = pw.result
                # snapshot NOW: the next batch may complete this ticket
                # (mutating result.virtual_s) once the swap is visible
                ctx["wb_submit_virt"] = pw.result.virtual_s
            if prev is not None:
                # incremental virt only: the submit-side charge (the RMW
                # read) was billed to the batch that issued it
                before = prev.result.virtual_s
                ctx["wb_prev_virt"] = (self.cache.complete_write(prev)
                                       .virtual_s - before)
            if cfg.embedding_flush_every > 0:
                with self._pf_lock:
                    self._wb_batches += 1
                    due = self._wb_batches % cfg.embedding_flush_every == 0
                if due:
                    # harvest the just-submitted ticket HERE so its virt is
                    # charged to this operator — the barrier would complete
                    # it anyway, but then its storage seconds would vanish
                    # from the pipeline cost model (FlushResult only carries
                    # the barrier ticket)
                    with self._pf_lock:
                        cur, self._wb_pending = self._wb_pending, None
                    if cur is not None:
                        before = cur.result.virtual_s
                        ctx["wb_prev_virt"] = (
                            ctx.get("wb_prev_virt", 0.0)
                            + self.cache.complete_write(cur).virtual_s
                            - before)
                    ctx["wb_flush"] = self.cache.flush()
                    if self.mom_cache is not None:
                        # the optimizer-state tables honor the same
                        # barrier: velocity rows are restart state too
                        ctx["wb_mom_flush"] = self.mom_cache.flush()
                    if self.adam_cache is not None:
                        ctx["wb_adam_flush"] = self.adam_cache.flush()

        # virtual costs under the paper envelope
        rb = self.store.row_bytes

        cpu_managed = cfg.mode == "cpu"

        def vc_sample(ctx):
            edges = sum(len(b.src_pos) for b in ctx["mb"].blocks)
            # CPU-managed systems sample AND build the feature mini-batch on
            # the CPU (paper I1: 70-98% of epoch time); device-managed
            # sampling is ~50x faster (massively parallel)
            rate = SAMPLE_RATE_CPU if cpu_managed else SAMPLE_RATE_DEVICE
            return edges * 16 / rate

        def vc_submit(ctx):
            # decoupled submission only BUILDS per-shard SQE batches — the
            # storage service time is charged where the ticket resolves
            # (vc_complete), with the virtual seconds the engine actually
            # accounted for the striped/coalesced read
            tk = ctx["pending"].ticket
            return 2e-6 * (tk.shards if tk is not None else 0)

        def vc_complete(ctx):
            # storage and remote legs resolve on parallel engine queues —
            # the operator costs the slower of the two (io_virt), which
            # collapses to storage_virt in single-node mode
            return ctx["pending"].io_virt

        def vc_lookup(ctx):
            pg = ctx["pending"]
            t_host = pg.n_host * rb / env.dram_bw + pcie_time(pg.n_host * rb)
            t_dev = pg.n_device * rb / env.hbm_bw
            return t_host + t_dev

        def vc_refresh(ctx):
            r = ctx.get("refresh")
            return r.virtual_s if r is not None else 0.0

        def vc_prefetch(ctx):
            r = ctx.get("prefetch")
            return r.virtual_s if r is not None else 0.0

        def vc_writeback(ctx):
            r = ctx.get("writeback")
            if r is None:
                return 0.0
            # tier writes move bytes over HBM/DRAM; this batch's RMW read
            # rides r.virtual_s at submit time, while the storage WRITE
            # ticket is charged one batch later, when the operator that
            # completes it harvests the virtual seconds it resolved with
            # (wb_prev_virt) — the split-phase cadence in the cost model
            virt = (r.device_rows * rb / env.hbm_bw
                    + r.host_rows * rb / env.dram_bw
                    + ctx.get("wb_submit_virt", 0.0)
                    + ctx.get("wb_prev_virt", 0.0))
            fl = ctx.get("wb_flush")
            mfl = ctx.get("wb_mom_flush")
            afl = ctx.get("wb_adam_flush")
            return (virt + (fl.virtual_s if fl is not None else 0.0)
                    + (mfl.virtual_s if mfl is not None else 0.0)
                    + (afl.virtual_s if afl is not None else 0.0))

        def vc_h2d(ctx):
            # device-managed paths (Helios/GIDS) land storage + host rows in
            # device memory directly (GPU-initiated DMA / UVA), so batch
            # assembly moves only index tensors; CPU-managed systems gather
            # the whole mini-batch into a staging buffer on the CPU and DMA
            # it across PCIe once more (paper I2, Fig. 1(b))
            n_real = int(ctx["mb"].node_mask.sum())
            if cpu_managed:
                nbytes = n_real * rb
                return nbytes / HOST_STAGE_BW + pcie_time(nbytes)
            edges = sum(len(b.src_pos) for b in ctx["mb"].blocks)
            return pcie_time(edges * 8 + n_real * 8)

        def vc_train(ctx):
            edges = sum(int(m.sum()) for m in ctx["tensors"][2])
            flops = 4 * edges * self.store.row_dim * self.cfg.hidden
            return flops / MATMUL_RATE

        plan = [
            Operator("sample", op_sample, "host", (), vc_sample),
            Operator("io_submit", op_io_submit, "io", ("sample",), vc_submit),
            Operator("cache_lookup", op_cache_lookup, "host", ("io_submit",),
                     vc_lookup),
            Operator("io_complete", op_io_complete, "io", ("io_submit",),
                     vc_complete),
            Operator("cache_refresh", op_cache_refresh, "io",
                     ("io_complete",), vc_refresh),
            Operator("batch_build", op_batch_build, "device",
                     ("cache_lookup", "io_complete"), vc_h2d),
            Operator("train", op_train, "device", ("batch_build",), vc_train),
        ]
        if cfg.prefetch_rows > 0:
            plan.insert(5, Operator("prefetch", op_prefetch, "io",
                                    ("io_complete",), vc_prefetch))
        if cfg.train_embeddings:
            plan.append(Operator("embedding_writeback",
                                 op_embedding_writeback, "io", ("train",),
                                 vc_writeback))
        return plan

    # -----------------------------------------------------------------
    def train(self, n_batches: int) -> dict:
        cfg = self.cfg
        mode = {"helios": "deep", "helios-nopipe": "nopipe",
                "helios-nocache": "deep", "gids": "nopipe",
                "cpu": "cpu"}[cfg.mode]
        pipe = PipelineExecutor(self._operators(), mode=mode,
                                prefetch_depth=cfg.prefetch_depth)

        def make_ctx(i):
            # bounded-cost unique draw: O(batch) expected, not O(n_vertices).
            # The rng is derived from the BATCH INDEX, not a shared stream:
            # deep-pipeline mode calls make_ctx from concurrent pipe-batch
            # threads, and a shared Generator is neither thread-safe nor
            # deterministic under interleaving — per-index derivation makes
            # the seed stream reproducible in every pipeline mode
            rng = np.random.default_rng([cfg.seed, 0x5EED, i])
            seeds = draw_unique(rng, self.g.n_vertices, cfg.batch_size)
            return {"seeds": seeds, "batch": i}

        try:
            out = pipe.run(make_ctx, n_batches)
        except BaseException:
            # a batch failed (an IO fault): the other batch in flight may
            # have operators queued, or waiting on tickets.  Let the running
            # ones finish and drop the queued ones while the engines still
            # serve them; left to the caller's ``with``, which closes the
            # engines, a pool thread would wait forever on a ticket no
            # worker serves, and the process could not exit
            for pool in pipe.pools.values():
                pool.shutdown(wait=True, cancel_futures=True)
            raise
        pipe.close()
        # land the last double-buffered prefetch ticket left in flight
        with self._pf_lock:
            pf, self._pf_pending = self._pf_pending, None
            wb, self._wb_pending = self._wb_pending, None
        if pf is not None:
            self.cache.complete_prefetch(pf)
        # harvest the final split-phase embedding write ticket, then the
        # epoch barrier: every dirty embedding row becomes durable on
        # storage through ONE batched (striped, coalesced) write ticket
        if wb is not None:
            self.cache.complete_write(wb)
        epoch_flush = (self.cache.flush() if cfg.train_embeddings else None)
        if self.mom_cache is not None:
            self.mom_cache.flush()
        if self.adam_cache is not None:
            self.adam_cache.flush()
        # atomic snapshots: nothing here can read a concurrent completion
        # or refresh mid-update (the serving path shares these objects)
        cs_snap = self.cache.stats()
        io_snap = self.io.stats.snapshot()
        out["cache"] = {
            "hit_rate": cs_snap.hit_rate,
            "device_hits": cs_snap.device_hits,
            "host_hits": cs_snap.host_hits,
            "storage_misses": cs_snap.storage_misses,
            "policy": self.cache.policy.name,
            "refreshes": cs_snap.refreshes,
            "promotions": cs_snap.promotions,
            "demotions": cs_snap.demotions,
            "virtual_migrate_s": cs_snap.virtual_migrate_s,
            "prefetches": cs_snap.prefetches,
            "prefetched_rows": cs_snap.prefetched_rows,
            "virtual_prefetch_s": cs_snap.virtual_prefetch_s,
        }
        out["io"] = {"requests": io_snap.requests,
                     "bytes": io_snap.bytes,
                     "virtual_s": io_snap.virtual_io_s,
                     "ranges": io_snap.ranges,
                     "span_bytes": io_snap.span_bytes,
                     "write_requests": io_snap.write_requests,
                     "write_bytes": io_snap.write_bytes,
                     "virtual_write_s": io_snap.virtual_write_s,
                     # fault-recovery visibility (chaos legs assert on it)
                     "retries": io_snap.retries,
                     "timeouts": io_snap.timeouts,
                     "transient_errors": io_snap.transient_errors,
                     "virtual_backoff_s": io_snap.virtual_backoff_s,
                     "degraded_events": io_snap.degraded_events,
                     "degraded_skipped_rows":
                         cs_snap.degraded_skipped_rows,
                     # per-stream-class breakdown + back-pressure
                     # visibility (docs/streams.md)
                     "by_class": io_snap.by_class,
                     "throttle_engaged": io_snap.throttle_engaged,
                     "throttle_released": io_snap.throttle_released,
                     "throttled_skipped_rows":
                         cs_snap.throttled_skipped_rows,
                     # pipeline-bubble attribution (always on; see
                     # repro_torch.obs.analyze.overlap_report)
                     "overlap_efficiency":
                         out["overlap"]["overlap_efficiency"],
                     "bubble_frac": out["overlap"]["bubble_frac"]}
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            # the traced span tree yields the per-phase attribution
            out["obs"] = _analyze.analyze_epoch(tr,
                                                makespan=out["virtual_s"])
        if cfg.train_embeddings:
            cs = cs_snap
            out["writeback"] = {
                "written_rows": cs.written_rows,
                "write_through_rows": cs.write_through_rows,
                "flushed_rows": cs.flushed_rows,
                "flushes": cs.flushes,
                "virtual_write_s": cs.virtual_write_s,
                "virtual_flush_s": cs.virtual_flush_s,
                "epoch_flush_rows": epoch_flush.rows,
                "dirty_after_flush": self.cache.n_dirty,
            }
            if self.mom_cache is not None:
                ms = self.mom_cache.stats
                out["writeback"]["momentum"] = {
                    "written_rows": ms.written_rows,
                    "flushed_rows": ms.flushed_rows,
                    "flushes": ms.flushes,
                    "dirty_after_flush": self.mom_cache.n_dirty,
                }
            if self.adam_cache is not None:
                vs = self.adam_cache.stats
                out["writeback"]["adam"] = {
                    "written_rows": vs.written_rows,
                    "flushed_rows": vs.flushed_rows,
                    "flushes": vs.flushes,
                    "dirty_after_flush": self.adam_cache.n_dirty,
                }
        out["loss_first"] = self.metrics_log[0]["loss"] if self.metrics_log else None
        out["loss_last"] = self.metrics_log[-1]["loss"] if self.metrics_log else None
        return out

    # -----------------------------------------------------------------
    def close(self):
        """Release the IO stack: cache first (closes nothing it doesn't
        own), then the engine this trainer created (joins its workers).
        The optimizer-state caches own their engines and close them
        themselves.  Each step runs even when an earlier one raised (a
        cache settling a flush ticket that failed re-raises its fault), so
        no engine's workers outlive the trainer; the first error is
        raised after all of them."""
        err = None
        for c in (self.cache, self.io, self.mom_cache, self.adam_cache):
            if c is None:
                continue
            try:
                c.close()
            except BaseException as e:      # noqa: BLE001 - re-raised below
                err = err or e
        if err is not None:
            raise err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
