"""GNN inference server over the Helios cache/IO stack.

The server owns one shared ``HeteroCache`` + IO engine and a single
forward-only step (``make_gnn_infer_step``).  ``submit`` enqueues a request
and returns a future; ``flush`` drains the queue through the SLO scheduler
and micro-batcher.  Each micro-batch performs ONE planned gather over the
union of node ids across its requests (cross-request dedup), then scatters
rows back per request for the forward pass.

Virtual-time accounting mirrors the trainer's operator costs on the
calibrated hardware envelope:

  * helios — async engine; sample/IO/compute pipelined on separate
    ``VirtualClock`` resources, tier gathers overlap (max, not sum);
  * gids   — sync coupled engine (collapsed queue depth), serial stages;
  * cpu    — CPU-managed staging engine, slow host sampling, the whole
    mini-batch staged through host memory and re-crossed over PCIe.

PyTorch port of ``repro.serving.service``.  ``ServerConfig.device``
(default ``"cuda"``) places the cache's device tier, the parameters and the
forward pass; ``device="cpu"`` runs everything on the CPU with the
kernels' plain versions.  Virtual-time accounting is unchanged.
"""
from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import hotness as hotness_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.hetero_cache import HeteroCache, tier_rows
from repro_torch.core.iostack import FeatureStore, make_engine
from repro_torch.core.policy import make_policy
from repro_torch.core.simulator import (DEFAULT_ENVELOPE, HOST_STAGE_BW,
                                  MATMUL_RATE, SAMPLE_RATE_CPU,
                                  SAMPLE_RATE_DEVICE, VirtualClock,
                                  dram_gather_time, hbm_gather_time,
                                  pcie_time)
from repro_torch.gnn.graph import CSRGraph
from repro_torch.gnn.models import init_gnn_params, make_gnn_infer_step
from repro_torch.gnn.sampling import NeighborSampler
from repro_torch.obs import trace as _trace
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.scheduler import (INTERACTIVE, PriorityClass, ServeRequest,
                                     SLOScheduler)
from repro_torch.serving.stats import ServingStats


@dataclass
class ServerConfig:
    model: str = "sage"                # sage | gcn
    hidden: int = 256
    request_batch_size: int = 64       # seeds per request (padded to this)
    fanouts: tuple = (10, 5)
    mode: str = "helios"               # helios | gids | cpu
    dedup: bool = True                 # cross-request node dedup
    fused_lookup: bool = True          # fused plan+dedup+tier-split cache
                                       # lookup (PR 7); False = host plan()
    device_cache_frac: float = 0.05
    host_cache_frac: float = 0.10
    io_worker_budget: float = 0.3
    presample_batches: int = 4
    cache_policy: str = "static"       # static | online (core.policy):
                                       # online re-derives placement from
                                       # the live access stream
    refresh_every: int = 8             # micro-batches between refresh checks
    prefetch_rows: int = 0             # predicted-hot rows pulled per
                                       # micro-batch (0 = disabled)
    policy_half_life: float = 16.0
    policy_hysteresis: float = 0.1
    write_policy: str = "writeback"    # writeback | writethrough — fleet
                                       # replicas run writethrough so a
                                       # peer reading shared storage after
                                       # an owner-write sees the new value
    batch_window_v: float = 1e-3       # micro-batch time window (virtual s)
    max_batch_requests: int = 8        # micro-batch size window
    # fault injection + recovery (ft.chaos), same semantics as
    # TrainerConfig: "env" reads HELIOS_CHAOS, None disables
    chaos: object | None = "env"
    io_deadline_s: float | None = None
    io_max_retries: int = 4
    io_backoff_s: float = 1e-3
    # per-stream-class shard scheduling + back-pressure, same semantics
    # as TrainerConfig (docs/streams.md): serving demand gathers ride the
    # DEMAND class; prefetch admission honors the qwait watermark
    io_sched: str = "wfq"
    io_class_weights: dict | None = None
    io_qwait_high_s: float | None = None
    io_qwait_low_s: float | None = None
    seed: int = 0
    device: str = "cuda"               # cuda | cuda:N | cpu (no fallback)

    def retry_policy(self):
        from repro_torch.ft.chaos import DEFAULT_RETRY, RetryPolicy
        if (self.io_deadline_s is None and self.io_max_retries == 4
                and self.io_backoff_s == 1e-3):
            return DEFAULT_RETRY
        return RetryPolicy(max_retries=self.io_max_retries,
                           backoff_base_s=self.io_backoff_s,
                           deadline_s=self.io_deadline_s)


class GNNInferenceServer:
    """SLO-aware micro-batching inference server (request -> future)."""

    def __init__(self, graph: CSRGraph, store: FeatureStore,
                 cfg: ServerConfig | None = None, params=None):
        cfg = cfg if cfg is not None else ServerConfig()
        # resolved first: no card for device="cuda" raises before any
        # engine thread starts
        self.device = resolve_device(cfg.device)
        if cfg.request_batch_size > graph.n_vertices:
            raise ValueError(f"request_batch_size={cfg.request_batch_size} "
                             f"exceeds graph size {graph.n_vertices}: "
                             "requests cannot be padded with unique seeds")
        self.g, self.store, self.cfg = graph, store, cfg
        self.sampler = NeighborSampler(graph, cfg.fanouts, cfg.seed)

        # --- IO engine per mode (same ablation axes as the trainer) ------
        self.io = make_engine(cfg.mode, store, cfg.io_worker_budget,
                              chaos=cfg.chaos, retry=cfg.retry_policy(),
                              sched=cfg.io_sched,
                              class_weights=cfg.io_class_weights,
                              qwait_high_s=cfg.io_qwait_high_s,
                              qwait_low_s=cfg.io_qwait_low_s)

        # --- hotness placement; presample on a SEPARATE sampler so the
        # serving sampler's rng stream is untouched (replayable) ----------
        hot = hotness_mod.presample_gnn(
            NeighborSampler(graph, cfg.fanouts, cfg.seed + 1),
            cfg.request_batch_size * cfg.max_batch_requests,
            cfg.presample_batches, graph.n_vertices, cfg.seed)
        dev_rows, host_rows = tier_rows(cfg.mode, graph.n_vertices,
                                        cfg.device_cache_frac,
                                        cfg.host_cache_frac)
        # the unified gather path feeds every served access into the
        # policy, so cache_policy="online" re-derives placement from the
        # live (e.g. Zipf) request stream instead of the presample epoch
        policy = make_policy(cfg.cache_policy, graph.n_vertices,
                             presample=hot, refresh_every=cfg.refresh_every,
                             half_life=cfg.policy_half_life,
                             hysteresis=cfg.policy_hysteresis)
        self.cache = HeteroCache(store, None, dev_rows, host_rows, self.io,
                                 policy=policy,
                                 write_policy=cfg.write_policy,
                                 fused=cfg.fused_lookup,
                                 device=self.device)

        # --- model + single compiled forward step ------------------------
        if params is None:
            params = init_gnn_params(torch.Generator().manual_seed(cfg.seed),
                                     cfg.model, store.row_dim, cfg.hidden,
                                     graph.n_classes, device=self.device)
        self.params = params
        self.infer_step = make_gnn_infer_step(cfg.model,
                                              cfg.request_batch_size)

        self.batcher = MicroBatcher(self.sampler, cfg.request_batch_size)
        self.scheduler = SLOScheduler(cfg.batch_window_v,
                                      cfg.max_batch_requests)
        self.clock = VirtualClock()
        self.stats = ServingStats()
        self.env = DEFAULT_ENVELOPE
        self._rid = 0
        self._pipelined = cfg.mode == "helios"

    # ------------------------------------------------------------------
    def now_v(self) -> float:
        """Virtual time the server can next start batch work."""
        res = "host" if self._pipelined else "serial"
        return self.clock.resources.get(res, 0.0)

    def submit(self, seeds: np.ndarray,
               klass: PriorityClass = INTERACTIVE,
               arrival_v: float | None = None) -> Future:
        """Enqueue one inference request; resolves to ``{"logits",
        "latency_v", "klass"}`` or ``None`` if shed by admission.

        Invalid requests raise HERE, at the caller's boundary — a bad
        request must never poison the micro-batch it would have joined.
        """
        seeds = np.asarray(seeds, np.int64)
        if len(seeds) > self.cfg.request_batch_size:
            raise ValueError(f"request has {len(seeds)} seeds > "
                             f"request_batch_size="
                             f"{self.cfg.request_batch_size}")
        if len(np.unique(seeds)) != len(seeds):
            raise ValueError("request seeds must be unique "
                             "(sampler contract)")
        if len(seeds) == 0 or seeds.min() < 0 or seeds.max() >= self.g.n_vertices:
            raise ValueError("request seeds must be non-empty vertex ids "
                             f"in [0, {self.g.n_vertices})")
        req = ServeRequest(seeds,
                           self.now_v() if arrival_v is None else arrival_v,
                           klass, Future(), self._rid)
        self._rid += 1
        self.stats.submitted += 1
        self.scheduler.enqueue(req)
        return req.future

    def flush(self):
        """Drain the queue: form, execute, and account micro-batches."""
        while len(self.scheduler):
            self._serve_one()
        return self.stats

    # ------------------------------------------------------------------
    def _serve_one(self):
        import time as _time
        tr = _trace.TRACER
        tracing = tr is not None and tr.enabled
        w0 = _time.perf_counter() if tracing else 0.0
        admitted, start_v, rejected = self.scheduler.next_batch(self.now_v())
        for r in rejected:
            self.stats.reject(r.klass.name)
            r.future.set_result(None)
        if not admitted:
            return
        w1 = _time.perf_counter() if tracing else 0.0

        micro = self.batcher.build(admitted)
        w2 = _time.perf_counter() if tracing else 0.0
        cfg = self.cfg
        rb = self.store.row_bytes
        loc = self.cache.loc

        # --- one deduplicated gather (or per-request, for the ablation)
        # through the cache's split-phase API, same path as the trainer;
        # t_storage is the ticket-resolved virtual time (robust against a
        # shared engine serving concurrent consumers, unlike a stats delta)
        naive_storage = sum(int((loc[u] >= 2).sum())
                            for u in micro.unique_per_request)
        feats, n_dev, n_host, issued_storage, rows_fetched, t_storage = \
            self.batcher.gather(self.cache, micro, cfg.dedup)
        w3 = _time.perf_counter() if tracing else 0.0

        # --- forward pass per request (shared step) on the device; the
        # logits come back to the host in one copy per micro-batch -------
        dev = self.device

        def put(arrays):
            return tuple(torch.from_numpy(a).to(dev) for a in arrays)

        logits = []
        for mb, f in zip(micro.minibatches, feats):
            logits.append(self.infer_step(
                self.params, f,
                put(b.src_pos for b in mb.blocks),
                put(b.dst_pos for b in mb.blocks),
                put(b.edge_mask for b in mb.blocks)))
        results = list(torch.stack(logits).cpu().numpy())

        # --- virtual-time accounting (trainer-faithful operator costs) ---
        edges = micro.n_edges
        cpu_managed = cfg.mode == "cpu"
        t_sample = edges * 16 / (SAMPLE_RATE_CPU if cpu_managed
                                 else SAMPLE_RATE_DEVICE)
        t_host = (dram_gather_time(n_host * rb, self.env)
                  + pcie_time(n_host * rb, self.env))
        t_dev = hbm_gather_time(n_dev * rb, self.env)
        if cpu_managed:     # whole batch staged on host, re-crossed PCIe
            t_h2d = (rows_fetched * rb / HOST_STAGE_BW
                     + pcie_time(rows_fetched * rb))
        else:               # device-managed: only index tensors move
            t_h2d = pcie_time(edges * 8 + rows_fetched * 8)
        t_fwd = 2 * edges * self.store.row_dim * cfg.hidden / MATMUL_RATE

        t_gather = max(t_storage, t_host + t_dev) if self._pipelined \
            else t_storage + t_host + t_dev
        t_compute = t_h2d + t_fwd
        if self._pipelined:
            e_sample = self.clock.schedule("host", start_v, t_sample)
            # tier gathers overlap under the deep pipeline: bound by the
            # slowest tier, not the sum (paper's overlap ordering)
            e_io = self.clock.schedule("io", e_sample, t_gather)
            end_v = self.clock.schedule("device", e_io, t_compute)
        else:
            e_io = end_v = self.clock.schedule(
                "serial", start_v, t_sample + t_gather + t_compute)
            e_sample = end_v - t_gather - t_compute
            e_io = end_v - t_compute
        # logical-resource busy time, accumulated whether or not a tracer
        # is installed — summary()'s overlap/bubble numbers come from this
        self.stats.add_busy(host=t_sample, io=t_gather, device=t_compute)

        self.scheduler.observe_service(end_v - start_v)

        if tracing:
            w4 = _time.perf_counter()
            b = self.stats.batches
            tr.record("serve.admit", w0, w1, track="host", cat="serve",
                      args={"batch": b, "resource": "host",
                            "admitted": len(admitted),
                            "rejected": len(rejected)})
            tr.record("serve.batch", w1, w2, track="host", cat="serve",
                      v0=e_sample - t_sample, v1=e_sample,
                      args={"batch": b, "resource": "host",
                            "requests": len(admitted)})
            tr.record("serve.gather", w2, w3, track="io", cat="serve",
                      v0=e_io - t_gather, v1=e_io,
                      args={"batch": b, "resource": "io",
                            "rows": rows_fetched,
                            "storage_rows": issued_storage})
            tr.record("serve.forward", w3, w4, track="device", cat="serve",
                      v0=end_v - t_compute, v1=end_v,
                      args={"batch": b, "resource": "device",
                            "requests": len(admitted)})

        # asynchronous tier migration: the policy re-derives placement from
        # the served access stream; migration rides the io resource so it
        # hides under this batch's device compute (serial modes pay it)
        refresh = self.cache.maybe_refresh()
        if refresh is not None and refresh.virtual_s:
            self.clock.schedule("io" if self._pipelined else "serial",
                                e_io, refresh.virtual_s)
            self.stats.add_busy(io=refresh.virtual_s)
        # policy-driven prefetch: rows the score trend predicts will turn
        # hot are pulled ahead of their first request, riding the io
        # resource like migration does
        if cfg.prefetch_rows > 0:
            pf = self.cache.maybe_prefetch(cfg.prefetch_rows)
            if pf is not None and pf.virtual_s:
                self.clock.schedule("io" if self._pipelined else "serial",
                                    e_io, pf.virtual_s)
                self.stats.add_busy(io=pf.virtual_s)

        # --- complete futures + metrics ----------------------------------
        st = self.stats
        st.batches += 1
        st.rows_requested += micro.rows_requested
        st.rows_fetched += rows_fetched
        st.storage_rows_naive += naive_storage
        st.storage_rows_issued += issued_storage
        st.virtual_end = max(self.clock.resources.values())
        for req, logits, n_valid in zip(admitted, results, micro.n_valid):
            lat = end_v - req.arrival_v
            st.record(req.klass.name, lat)
            req.future.set_result({"logits": logits[:n_valid],
                                   "latency_v": lat,
                                   "klass": req.klass.name})

    # ------------------------------------------------------------------
    def close(self):
        """Shut down the shared cache/IO stack (joins engine workers)."""
        self.cache.close()
        self.io.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
