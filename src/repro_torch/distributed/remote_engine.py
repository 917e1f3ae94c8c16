"""Split-phase IO engine over a partitioned fleet's feature stores.

``RemoteIOEngine`` implements the SAME ``submit``/``submit_write``/ticket/
``CompletionQueue`` API as ``AsyncIOEngine``, so a remote peer is just one
more tier in the existing split-phase hierarchy instead of a separate RPC
path.  A request batch is striped by row OWNER — one SQE batch per peer,
exactly how ``AsyncIOEngine`` stripes by storage shard — and each peer's
batches drain through the same class-aware ``ShardScheduler`` a storage
shard uses (strict priority for demand, weighted-fair bulk, FIFO within a
class — docs/streams.md), so peers progress in parallel and the
scheduler's hazard checks keep a read submitted after an in-flight write
to the same peer observing that write.  DEMAND legs that cross the fabric
are booked as REMOTE_DEMAND; each peer's virtual busy-until clock is the
shared link all classes' in-flight batches push (NetworkModel inflight
sharing).

Timing per peer batch (virtual seconds, deterministic):

  * ``me``        — local array read/write, no network.
  * alive peer    — peer-side storage time (the owner still reads its own
                    SSDs) + ``NetworkModel`` transfer (round-trip latency,
                    per-message overhead, payload at link bandwidth).
  * dead peer     — degraded reroute: the owner's storage is reached
                    directly over the fabric at a collapsed queue depth
                    (no owner-side submission threads to keep the array
                    busy).  In-flight tickets still complete exactly once;
                    the reroute is visible only in stats and timing.

Dead-peer detection rides ``ft.failures.Coordinator`` (alive flags driven
by heartbeats or a ``FailureInjector`` schedule).
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from repro_torch.core.iostack import (CompletionQueue, IOStats, IOTicket,
                                StreamClass, _ShardedCompletion, _SQE,
                                _note_qwait, _recover_op, _sched_init,
                                keep_last_writer, stream_class_of)
from repro_torch.core.simulator import (ArrayModel, DEFAULT_ENVELOPE,
                                  HardwareEnvelope, NetworkModel)
from repro_torch.distributed.partition import PartitionedFeatureStore
from repro_torch.ft.chaos import ChaosSchedule, DEFAULT_RETRY, RetryPolicy
from repro_torch.obs import trace as _trace

# queue depth a dead peer's storage sustains without its owner's
# submission threads (fabric-attached direct access, no batching help)
DEGRADED_QD = 64


class RemoteIOEngine:
    """Peer-striped split-phase engine over a ``PartitionedFeatureStore``."""

    def __init__(self, pstore: PartitionedFeatureStore, me: int = 0,
                 worker_budget: float = 0.3, total_workers: int = 8,
                 env: HardwareEnvelope = DEFAULT_ENVELOPE,
                 net: NetworkModel | None = None, coordinator=None,
                 chaos: ChaosSchedule | None | str = "env",
                 retry: RetryPolicy | None = None,
                 degrade_after: int = 3,
                 sched: str = "wfq", class_weights: dict | None = None,
                 qwait_high_s: float | None = None,
                 qwait_low_s: float | None = None,
                 sched_log: bool = False):
        if not 0 <= me < pstore.n_workers:
            raise ValueError(f"me={me} outside fleet of {pstore.n_workers}")
        self.store = pstore
        self.me = me
        self.env = env
        self.net = net if net is not None else NetworkModel()
        self.coordinator = coordinator
        # fabric fault injection + hedged-read recovery: chaos streams
        # are PEERS here (the fabric misbehaves per-link), and a read
        # that times out against a peer is hedged — re-priced as the
        # dead-peer reroute (owner storage over the fabric at collapsed
        # queue depth), one mechanism for flaps and stuck peers alike
        self.chaos = ChaosSchedule.from_env() if chaos == "env" else chaos
        self.net.chaos = self.chaos
        self.retry = retry if retry is not None else DEFAULT_RETRY
        self.degrade_after = degrade_after
        self._fault = self.net.fault
        self._chaos_seq = [0] * pstore.n_workers
        self._fail_streak = [0] * pstore.n_workers
        self.worker_errors: list = []
        self.worker_budget = worker_budget
        self.n_workers = max(1, int(round(worker_budget * total_workers)))
        self._models = [ArrayModel(st.n_shards, env) for st in pstore.stores]
        self.stats = IOStats()
        # scale-out accounting beyond the shared IOStats fields
        self.local_rows = 0
        self.remote_rows = 0
        self.rerouted_rows = 0
        self.rerouted_batches = 0
        self.virtual_net_s = 0.0
        self._lock = threading.Lock()
        self.stats._lock = self._lock   # atomic IOStats.snapshot()
        n_peers = pstore.n_workers
        # class-aware per-peer schedulers replace the FIFO queues: each
        # peer's virtual busy-until clock IS the shared fabric link —
        # every class's in-flight batches against that peer push the same
        # clock, so a prefetch storm to one peer delays (and is seen by)
        # that peer's demand legs, exactly like NetworkModel inflight
        # sharing (see docs/streams.md)
        self._schedulers = _sched_init(self, n_peers, sched, class_weights,
                                       qwait_high_s, qwait_low_s, sched_log)
        self._cqs = [queue.Queue() for _ in range(n_peers)]
        self._peer_lk = [threading.Lock() for _ in range(n_peers)]
        self._ready: queue.Queue = queue.Queue()
        self._paused = False
        self._stop = False
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(self.n_workers)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------
    def peer_alive(self, w: int) -> bool:
        if w == self.me or self.coordinator is None:
            return True
        ws = self.coordinator.workers.get(w)
        return ws is None or ws.alive

    def _qd(self, peer: int) -> int:
        return int(256 * self.store.stores[peer].n_shards
                   * min(1.0, self.worker_budget / 0.3))

    def _leg_class(self, base: StreamClass, w: int) -> StreamClass:
        """Peer legs inherit the request's class, except DEMAND legs that
        cross the fabric: those are REMOTE_DEMAND — still strict-priority
        over bulk, but distinguishable in stats and one notch below local
        demand when both contend for the same peer."""
        if base == StreamClass.DEMAND and w != self.me:
            return StreamClass.REMOTE_DEMAND
        return base

    # -- submission ------------------------------------------------------
    def submit(self, ids: np.ndarray, out: np.ndarray | None = None,
               dest: np.ndarray | None = None, tag: str = "",
               cq: CompletionQueue | None = None,
               sclass: StreamClass | None = None,
               v_submit: float | None = None) -> IOTicket:
        fut: Future = Future()
        t0 = time.perf_counter()
        ids = np.asarray(ids)
        nbytes = len(ids) * self.store.row_bytes
        sc = stream_class_of(tag, sclass)
        buf = out
        if buf is None:
            buf = np.empty((len(ids), self.store.row_dim), self.store.dtype)
        dest_idx = (np.asarray(dest) if dest is not None
                    else np.arange(len(ids)))
        own, loc = self.store.to_local(ids)
        comp = _ShardedCompletion(self, fut, buf if out is None else None, 0)
        comp.sclass = sc
        batches = []
        for w in range(self.store.n_workers):
            m = own == w
            if m.any():
                batches.append((w, loc[m], dest_idx[m]))
        tk = IOTicket(fut, len(ids), nbytes, 0.0, tag, shards=len(batches))
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            comp.t0w = t0
            comp.tag = tag
            comp.psid = tr.current()
        if not batches:                 # empty request: resolve immediately
            fut.set_result((buf if out is None else None, 0.0))
        else:
            comp.pending = len(batches)
            for w, offs, d in batches:
                self._schedulers[w].put(
                    _SQE("r", offs, (d, buf), comp, t0,
                         self._leg_class(sc, w), v_submit))
                self._ready.put(w)
        tk.submit_wall = time.perf_counter() - t0
        with self._lock:
            self.stats.requests += len(ids)
            self.stats.bytes += nbytes
            self.stats.wall_submit_s += tk.submit_wall
            self.stats.batches += 1
            self.stats.shard_batches += len(batches)
            b = self.stats._bucket(sc.name)
            b["requests"] += len(ids)
            b["bytes"] += nbytes
            b["batches"] += 1
        if cq is not None:
            cq.add(tk)
        return tk

    def submit_write(self, ids: np.ndarray, rows: np.ndarray, tag: str = "",
                     cq: CompletionQueue | None = None,
                     sclass: StreamClass | None = None,
                     v_submit: float | None = None) -> IOTicket:
        """Owner-writes: the batch stripes by row owner and each slice
        lands in the OWNER's store (over the network for peers), so there
        is exactly one durable copy of every row fleet-wide."""
        if not self.store.writable:
            raise PermissionError("submit_write on a read-only store; "
                                  "open it with writable=True")
        fut: Future = Future()
        t0 = time.perf_counter()
        sc = stream_class_of(tag if tag else "write", sclass)
        ids = np.asarray(ids)
        rows = np.asarray(rows, self.store.dtype)
        if rows.shape != (len(ids), self.store.row_dim):
            raise ValueError(f"rows shape {rows.shape} != "
                             f"({len(ids)}, {self.store.row_dim})")
        ids, rows = keep_last_writer(ids, rows)
        nbytes = len(ids) * self.store.row_bytes
        own, loc = self.store.to_local(ids)
        comp = _ShardedCompletion(self, fut, None, 0, kind="w")
        comp.sclass = sc
        batches = []
        for w in range(self.store.n_workers):
            m = own == w
            if m.any():
                batches.append((w, loc[m], rows[m]))
        tk = IOTicket(fut, len(ids), nbytes, 0.0, tag, shards=len(batches))
        tr = _trace.TRACER
        if tr is not None and tr.enabled:
            comp.t0w = t0
            comp.tag = tag
            comp.psid = tr.current()
        if not batches:
            fut.set_result((None, 0.0))
        else:
            comp.pending = len(batches)
            for w, offs, data in batches:
                self._schedulers[w].put(
                    _SQE("w", offs, data, comp, t0,
                         self._leg_class(sc, w), v_submit))
                self._ready.put(w)
        tk.submit_wall = time.perf_counter() - t0
        with self._lock:
            self.stats.write_requests += len(ids)
            self.stats.write_bytes += nbytes
            self.stats.wall_submit_s += tk.submit_wall
            self.stats.write_batches += 1
            self.stats.write_shard_batches += len(batches)
            b = self.stats._bucket(sc.name)
            b["write_requests"] += len(ids)
            b["write_bytes"] += nbytes
            b["write_batches"] += 1
        if cq is not None:
            cq.add(tk)
        return tk

    # -- per-peer service ------------------------------------------------
    def _route(self, w: int, n: int, span_bytes: int, hedged: bool,
               model_time):
        """Price one service attempt against peer ``w``.  ``hedged``
        attempts and dead peers both take the reroute path: the owner's
        storage reached directly over the fabric at a collapsed queue
        depth (no owner-side submission threads to keep the array busy)."""
        st = self.store.stores[w]
        if w == self.me:
            return model_time(n, st.row_bytes, self._qd(w)), 0.0, "local"
        net_s = self.net.xfer_time(n, span_bytes)
        if self.peer_alive(w) and not hedged:
            return model_time(n, st.row_bytes, self._qd(w)) + net_s, \
                net_s, "remote"
        return model_time(n, st.row_bytes, DEGRADED_QD) + net_s, \
            net_s, "reroute"

    def _service_peer(self, w: int, offs: np.ndarray, dest: np.ndarray,
                      buf: np.ndarray):
        st = self.store.stores[w]
        n = len(offs)
        span_bytes = n * self.store.row_bytes
        last = {"net_s": 0.0, "kind": "local"}

        def time_fn(attempt, hedged):
            virt, net_s, kind = self._route(
                w, n, span_bytes, hedged, self._models[w].read_time)
            last["net_s"], last["kind"] = net_s, kind
            return virt

        def io_fn(fd):
            # one storage read on the successful attempt: retried and
            # hedged gathers return bit-identical bytes
            buf[dest] = st.read_rows(offs)

        virt, _, _ = _recover_op(self, w, "r", time_fn, io_fn, hedge=True)
        self._book_peer(last["kind"], n, last["net_s"], w)
        return virt, 1, span_bytes

    def _service_peer_write(self, w: int, offs: np.ndarray,
                            rows: np.ndarray):
        st = self.store.stores[w]
        n = len(offs)
        span_bytes = n * self.store.row_bytes
        last = {"net_s": 0.0, "kind": "local"}

        def time_fn(attempt, hedged):
            virt, net_s, kind = self._route(
                w, n, span_bytes, hedged, self._models[w].write_time)
            last["net_s"], last["kind"] = net_s, kind
            return virt

        def io_fn(fd):
            if fd is not None and fd.torn:
                # torn owner-write: only a prefix lands before the
                # simulated crash (the flush journal replays the barrier)
                k = n // 2
                st.write_rows(offs[:k], rows[:k], dedupe=False)
                return
            st.write_rows(offs, rows, dedupe=False)

        virt, _, _ = _recover_op(self, w, "w", time_fn, io_fn, hedge=True)
        self._book_peer(last["kind"], n, last["net_s"], w)
        return virt, 1, span_bytes

    def _book_peer(self, kind: str, n: int, net_s: float, w: int):
        with self._lock:
            self.virtual_net_s += net_s
            if kind == "local":
                self.local_rows += n
            elif kind == "remote":
                self.remote_rows += n
            else:
                self.remote_rows += n
                self.rerouted_rows += n
                self.rerouted_batches += 1
        if kind == "reroute":
            tr = _trace.TRACER
            if tr is not None and tr.enabled:
                tr.instant("net.reroute", track=f"peer{w}", cat="net",
                           args={"peer": w, "rows": n, "net_s": net_s})

    def _reap_cq(self, w: int):
        while True:
            try:
                comp, cqe = self._cqs[w].get_nowait()
            except queue.Empty:
                return
            if isinstance(cqe, BaseException):
                comp.shard_fail(cqe)
            else:
                comp.shard_done(*cqe)

    def _worker(self):
        while not self._stop:
            try:
                w = self._ready.get(timeout=0.1)
            except queue.Empty:
                continue
            if self._paused:
                self._ready.put(w)
                self._ready.task_done()
                time.sleep(2e-4)
                continue
            if not self._peer_lk[w].acquire(blocking=False):
                self._ready.put(w)
                self._ready.task_done()
                time.sleep(2e-4)
                continue
            try:
                sqe = self._schedulers[w].pop()
                if sqe is None:         # pragma: no cover - token per entry
                    continue
                comp = sqe.comp
                try:
                    t0 = time.perf_counter()
                    if sqe.kind == "w":
                        out = self._service_peer_write(w, sqe.offs,
                                                       sqe.payload)
                    else:
                        d, buf = sqe.payload
                        out = self._service_peer(w, sqe.offs, d, buf)
                    t1 = time.perf_counter()
                    v0, v1, qwait_v = self._schedulers[w].complete(sqe,
                                                                   out[0])
                    _note_qwait(self, w, sqe, v0, v1, qwait_v)
                    leg_virt = (v1 - sqe.v_submit
                                if sqe.v_submit is not None else out[0])
                    # one peer batch == one "range" of wire traffic
                    self._cqs[w].put(
                        (comp, (leg_virt, out[1], out[2], t1 - t0, qwait_v)))
                    tr = _trace.TRACER
                    if tr is not None and tr.enabled:
                        psid = getattr(comp, "psid", None)
                        tr.record("net.qwait", sqe.t_enq, t0,
                                  track=f"peer{w}/q", cat="net",
                                  parent=psid,
                                  args={"peer": w, "kind": sqe.kind,
                                        "sclass": sqe.sclass.name,
                                        "qwait_virt_s": qwait_v})
                        tr.record(
                            f"net.{'write' if sqe.kind == 'w' else 'read'}",
                            t0, t1, track=f"peer{w}", cat="net",
                            parent=psid,
                            args={"peer": w, "virt_s": out[0],
                                  "rows": len(sqe.offs),
                                  "sclass": sqe.sclass.name})
                except Exception as e:
                    # errored CQE: the owning ticket sees the exception
                    # via shard_fail and the worker stays alive for the
                    # next peer batch.  The scheduler entry still
                    # completes (zero service) so its hazards release
                    self._schedulers[w].complete(sqe, 0.0)
                    self._cqs[w].put((comp, e))
            finally:
                self._peer_lk[w].release()
                try:
                    self._reap_cq(w)
                except Exception as e:  # pragma: no cover - defensive
                    self.worker_errors.append(e)
                self._ready.task_done()

    # -- congestion control (same contract as AsyncIOEngine) --------------
    def pause(self):
        """Hold service: workers requeue ready tokens until ``resume()``
        so callers can stage a full virtual arrival schedule."""
        self._paused = True

    def resume(self):
        self._paused = False

    def throttled(self, sclass: StreamClass = StreamClass.PREFETCH) -> bool:
        """Back-pressure: True for PREFETCH/CHECKPOINT while strict-class
        p99 queue delay sits above the engaged watermark."""
        if sclass not in (StreamClass.PREFETCH, StreamClass.CHECKPOINT):
            return False
        return self._throttle_on

    def qwait_summary(self) -> dict:
        with self._lock:
            hists = dict(self._qwait_hist)
        return {name: h.summary() for name, h in hists.items()}

    # -- degraded-peer introspection -------------------------------------
    def degraded_shards(self) -> np.ndarray:
        """Peers whose consecutive-failure streak crossed
        ``degrade_after`` (same contract as
        ``AsyncIOEngine.degraded_shards``, streams are peers here)."""
        with self._lock:
            return np.array([w for w, v in enumerate(self._fail_streak)
                             if v >= self.degrade_after], np.int64)

    def shard_of(self, ids: np.ndarray) -> np.ndarray:
        """Owner peer of each global row id (the degradation stream)."""
        return self.store.to_local(np.asarray(ids))[0]

    # -- lifecycle -------------------------------------------------------
    def drain(self):
        self._ready.join()

    def close(self):
        if self._threads:
            self.drain()
        self._stop = True
        for t in self._threads:
            t.join()
        self._threads = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
