"""One run of one cell: inputs from the seed, set-up, warm-up with the
checked steps, one timed call of the trainer, the trace's reduction and
the check against the plain reference.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``,
its file as the ``configs`` entry gives it) and a traffic mix
(``traffic/<name>.json``); its limits are in ``limits/<cell>.json``, each
per-layer metric is read by ``metrics/<metric>.py``, and the
configuration's ``"model"`` is checked and counted by ``models/<model>.py``
with the configuration's ``"model_args"``.  Nothing here knows a cell, a
configuration, a model or a metric by name.
"""
from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import counts, data, devtrace, load_file, reference

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")

# a run's counts of batches, the same in every cell: the warm-up, the first
# steps of it that are checked (``limits/<cell>.json`` was set from this
# many), and the fewest batches a window times
WARMUP_BATCHES = 10
CHECK_STEPS = 3
MIN_BATCHES = 10


# ------------------------------------------------------------ the files
def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and
    metrics, as the files under ``portbench/`` give them."""
    bench = bench if bench is not None else _read_json(BENCHMARK)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return {
        "name": name,
        "chips": wl["chips"],
        "config": _read_json(os.path.join(ROOT, cfg_entry["file"])),
        "traffic": _read_json(os.path.join(HERE, "traffic",
                                           f"{wl['traffic']}.json")),
        "limits": _read_json(os.path.join(HERE, "limits", f"{name}.json")),
        "end_to_end": [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"]
                      if name in m.get("workloads", [name])],
    }


def load_reader(metric: str):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    return load_file(os.path.join(HERE, "metrics", f"{metric}.py")).read


def trainer_settings(cell: dict) -> dict:
    """The traffic's ``trainer`` settings (mode, tiers, placement,
    pipeline depth) and the configuration's model settings, as they go to
    ``TrainerConfig``; a key that both set is an error."""
    tr = cell["traffic"]["trainer"]
    margs = cell["config"].get("model_args", {})
    both = sorted(set(tr) & set(margs))
    if both:
        raise ValueError(f"{cell['name']}: {both} set by both the traffic's "
                         "trainer settings and the configuration's "
                         "model_args")
    return {**tr, **margs}


def jax_modules() -> list:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in JAX_NAMES})


# ---------------------------------------------------------------- taps
class StepTap:
    """Stands in for the trainer's step: calls it, stamps the time, and
    keeps what the first ``n_check`` steps were given and gave back."""

    def __init__(self, inner, n_check: int, batch_size: int):
        self.inner, self.n_check, self.batch_size = inner, n_check, batch_size
        self.times, self.records = [], []

    def __call__(self, state, feats, src, dst, em, labels):
        k = len(self.times)
        out = self.inner(state, feats, src, dst, em, labels)
        self.times.append(time.perf_counter())
        if k < self.n_check:
            pos = torch.cat([t[m] for t, m in zip(src + dst, em + em)])
            n_real = max(int(pos.max()) + 1 if pos.numel() else 0,
                         self.batch_size)
            rec = {"src": [t.cpu().numpy() for t in src],
                   "dst": [t.cpu().numpy() for t in dst],
                   "em": [t.cpu().numpy() for t in em],
                   "labels": labels.cpu().numpy(),
                   "loss": float(out[1]["loss"]),
                   "n_real": n_real,
                   "feats": feats[:n_real].cpu(),
                   "pad_nonzero": int(bool((feats[n_real:] != 0).any()))}
            state1 = reference.flatten(out[0]["params"])
            if k == 0:
                rec["m"] = {key: t.detach().cpu().clone() for key, t in
                            reference.flatten(out[0]["opt"]["m"]).items()}
            if k == self.n_check - 1:
                rec["params"] = {key: t.detach().cpu().clone()
                                 for key, t in state1.items()}
            self.records.append(rec)
        return out


class SampleTap:
    """Stands in for the sampler's ``sample``: keeps every batch drawn."""

    def __init__(self, inner):
        self.inner = inner
        self.batches = []

    def __call__(self, seeds):
        mb = self.inner(seeds)
        self.batches.append(mb)
        return mb


class LookupTap:
    """Stands in for the cache's ``submit_planned``: keeps each lookup's
    id count and its device and host tier hits."""

    def __init__(self, inner):
        self.inner = inner
        self.lookups = []

    def __call__(self, ids, n_rows=None):
        pg = self.inner(ids, n_rows=n_rows)
        self.lookups.append((len(ids), pg.n_device, pg.n_host))
        return pg


# --------------------------------------------------------------- the run
def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _digest(*arrays) -> str:
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(np.ascontiguousarray(a).data)
    return h.hexdigest()


class Setup:
    """The inputs of one run and the trainer built over them, with the
    taps in place.  ``close`` stops the trainer and removes the store."""

    def __init__(self, cell: dict, seed: int, device: str, log=None):
        from repro_torch.core.iostack import FeatureStore
        from repro_torch.gnn.graph import CSRGraph
        from repro_torch.gnn.train import OutOfCoreGNNTrainer, TrainerConfig

        log = log or (lambda msg: None)
        cfg, settings = cell["config"], trainer_settings(cell)
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        n, dim = cfg["n_vertices"], cfg["feature_dim"]
        self.trainer = None
        t = time.perf_counter()
        self.rowptr, self.col = data.synth_graph(
            n, cfg["avg_degree"], cfg["skew"], data.sub_seed(seed, 1))
        self.graph_digest = _digest(self.rowptr, self.col)
        log(f"graph {time.perf_counter() - t:.2f} s")
        self.row_seed = data.sub_seed(seed, 2)
        self.store_dir = tempfile.mkdtemp(prefix="portbench-store-")
        try:
            t = time.perf_counter()
            rows = data.feature_rows(n, dim, self.row_seed, self.dev)
            data.write_store(self.store_dir, rows, cfg["n_shards"])
            del rows
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(self.dev)
            log(f"store {time.perf_counter() - t:.2f} s")
            t = time.perf_counter()
            graph = CSRGraph(self.rowptr, self.col,
                             n_classes=cfg["n_classes"])
            store = FeatureStore(self.store_dir, n, dim, dtype=np.float32,
                                 n_shards=cfg["n_shards"])
            tcfg = TrainerConfig(
                model=cfg["model"], hidden=cfg["hidden"],
                batch_size=cfg["batch_size"], fanouts=tuple(cfg["fanouts"]),
                lr=cfg["lr"], chaos=None, seed=seed, device=device,
                **settings)
            self.trainer = OutOfCoreGNNTrainer(graph, store, tcfg)
            log(f"trainer {time.perf_counter() - t:.2f} s")
        except BaseException:
            self.close()
            raise
        self.step_tap = StepTap(self.trainer.step_fn, CHECK_STEPS,
                                cfg["batch_size"])
        self.sample_tap = SampleTap(self.trainer.sampler.sample)
        self.trainer.step_fn = self.step_tap
        self.trainer.sampler.sample = self.sample_tap

    def warm_up(self, n_batches: int) -> list:
        """The first ``n_batches`` through the trainer's own call, the
        checked steps among them; returns the batches sampled."""
        self.trainer.train(n_batches)
        _sync(self.dev)
        self.trainer.step_fn = self.step_tap.inner
        batches, self.sample_tap.batches = self.sample_tap.batches, []
        return batches

    def release_trainer(self) -> None:
        """Stop the trainer and free what it held on the device."""
        if self.trainer is not None:
            self.trainer.close()
            self.trainer = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        try:
            self.release_trainer()
        finally:
            shutil.rmtree(self.store_dir, ignore_errors=True)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, log=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result's fields."""
    cfg = cell["config"]
    bsz = cfg["batch_size"]
    log = log or (lambda msg: None)
    log(f"start {time.perf_counter() - t_start:.2f} s")
    su = Setup(cell, seed, device, log)
    dev = su.dev
    try:
        trainer = su.trainer
        t = time.perf_counter()
        warm = su.warm_up(WARMUP_BATCHES)
        log(f"warm-up {time.perf_counter() - t:.2f} s")
        # the warm-up's rate sizes the window, left out the checked steps
        # (which copy what they check to the host) and the two after them
        # (which find their inputs gathered while the checks copied)
        stamps = su.step_tap.times[CHECK_STEPS + 2:]
        if len(stamps) < 2:
            stamps = su.step_tap.times
        per_batch = (stamps[-1] - stamps[0]) / max(len(stamps) - 1, 1)
        n_batches = max(MIN_BATCHES,
                        round(seconds / per_batch) if per_batch > 0 else 0)
        if not trace:
            trainer.sampler.sample = su.sample_tap.inner

        # ---- the window
        rec = prof = tracer = lookup_tap = None
        cache0 = trainer.cache.stats()
        io0 = trainer.io.stats.snapshot()
        if trace:
            from repro_torch.obs import trace as obs_trace
            lookup_tap = LookupTap(trainer.cache.submit_planned)
            trainer.cache.submit_planned = lookup_tap
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            tracer = obs_trace.install()
        elif dev.type == "cuda":
            # the device alone: its busy time is an end-to-end metric
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        setup_s = time.perf_counter() - t_start
        t_mark = time.perf_counter()
        with torch.profiler.record_function(devtrace.WINDOW):
            t0, c0 = time.perf_counter(), time.process_time()
            trainer.train(n_batches)
            _sync(dev)
            t1, c1 = time.perf_counter(), time.process_time()
        if prof is not None:
            prof.stop()
        if trace:
            obs_trace.uninstall()
        window_s, cpu_s = t1 - t0, c1 - c0
        # the rate and the process's CPU seconds (every thread's) go to the
        # log: on this host-paced path they follow the host's load
        log(f"window {window_s:.2f} s, {n_batches} batches, "
            f"{n_batches * bsz / window_s:.1f} seeds/s, "
            f"host CPU {cpu_s:.2f} s")
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        cache1 = trainer.cache.stats()
        io1 = trainer.io.stats.snapshot()
        e2e = {"setup_s": setup_s}
        if prof is not None and not trace:
            # the device's busy seconds a batch of the timed call
            busy_s, n_work = devtrace.device_busy(
                prof.profiler.kineto_results.events()
                if prof.profiler.kineto_results is not None else [])
            if n_work:
                e2e["device_ms_per_batch"] = 1e3 * busy_s / n_batches
            log(f"device busy {busy_s:.3f} s in {n_work} records")
            del prof
        if trace:
            t = time.perf_counter()
            rec = {
                "model": cfg["model"],
                "model_args": cfg.get("model_args", {}),
                "feature_dim": cfg["feature_dim"],
                "hidden": cfg["hidden"], "n_classes": cfg["n_classes"],
                "row_bytes": cfg["feature_dim"] * 4, "n_batches": n_batches,
                "batch_size": bsz, "window_s": window_s,
                "spans": _span_durations(tracer),
                "cache": {k: getattr(cache1, k) - getattr(cache0, k)
                          for k in ("device_hits", "host_hits",
                                    "storage_misses", "remote_hits")},
                "io": {"requests": io1.requests - io0.requests},
                "lookups": lookup_tap.lookups,
                "batches": [counts.batch_sizes(
                    [(b.src_pos, b.dst_pos, b.edge_mask) for b in mb.blocks],
                    mb.node_mask, bsz) for mb in su.sample_tap.batches],
                "device": _device_record(prof, tracer, t_mark),
            }
            del prof, tracer
            log(f"trace read {time.perf_counter() - t:.2f} s")
        su.release_trainer()

        # ---- the check against the plain reference
        t = time.perf_counter()
        checks = check(cell, seed, su.step_tap.records, warm, su.rowptr,
                       su.col, su.graph_digest, su.row_seed, dev)
        log(f"reference {time.perf_counter() - t:.2f} s")
    finally:
        su.close()
    return {"e2e": e2e, "record": rec, "checks": checks,
            "n_batches": n_batches, "window_s": window_s,
            "memory_peak_bytes": int(peak)}


def _span_durations(tracer) -> dict:
    spans = {}
    for sp in tracer.spans:
        spans.setdefault(sp.name, []).append(sp.t1 - sp.t0)
    return spans


def _device_record(prof, tracer, t_mark: float) -> dict:
    """The profiler's window reduced (``devtrace``), with the pipeline's
    spans moved onto the profiler's clock by the window marker's start."""
    raw = prof.profiler.kineto_results.events() \
        if prof.profiler.kineto_results is not None else []
    marker = next((e for e in raw if e.name() == devtrace.WINDOW), None)
    if marker is None:
        return {}
    off = marker.start_ns() - t_mark * 1e9
    host = [(sp.name, (tracer.epoch + sp.t0) * 1e9 + off,
             (tracer.epoch + sp.t1) * 1e9 + off)
            for sp in tracer.spans if sp.name.startswith("pipe.")]
    return devtrace.reduce_events(raw, host)


# ------------------------------------------------------------- the check
def program_steps(records: list) -> dict:
    """What the program's first steps gave: each loss, the first gradient
    as the optimizer got it (its first moment after one step over
    ``1 - b1``), and the parameters after the last checked step."""
    m = records[0]["m"]
    return {"losses": [r["loss"] for r in records],
            "grad1": {k: v / (1 - reference.ADAM_B1) for k, v in m.items()},
            "params": records[-1]["params"]}


def reference_inputs(cell: dict, seed: int, records: list, warm: list,
                     rowptr, col, graph_digest: str, row_seed: int,
                     dev: torch.device):
    """The reference's view of the checked steps: the faults found in the
    sampled batches and the gathered rows, and each step's inputs (the
    regenerated rows of the batch's nodes, its valid edges, its labels)."""
    cfg = cell["config"]
    n, bsz = cfg["n_vertices"], cfg["batch_size"]
    faults = 0 if _digest(rowptr, col) == graph_digest else 1
    edges = reference.EdgeIndex(rowptr, col, dev)
    rows = data.feature_rows(n, cfg["feature_dim"], row_seed, dev)
    draws = [data.batch_seeds(seed, i, n, bsz)
             for i in range(WARMUP_BATCHES)]
    seen, steps, row_faults = set(), [], 0
    for r in records:
        mb = next((b for b in warm if _same_batch(b, r)), None)
        if mb is None:
            faults += sum(len(s) for s in r["src"])
            continue
        idx = next((i for i, d in enumerate(draws)
                    if np.array_equal(d, mb.seeds)), None)
        if idx is None or idx in seen:
            faults += 1
        seen.add(idx)
        n_real = int(np.count_nonzero(mb.node_mask))
        faults += int(n_real != r["n_real"])
        faults += int(np.count_nonzero(
            r["labels"] != data.labels_of(mb.seeds, cfg["n_classes"])))
        blocks = [(b.src_pos, b.dst_pos, b.edge_mask) for b in mb.blocks]
        faults += reference.sample_faults(edges, mb.nodes, n_real, mb.seeds,
                                          blocks, cfg["fanouts"], dev)
        nodes = torch.from_numpy(mb.nodes[:n_real]).to(dev)
        x = rows[nodes]
        if r["feats"].shape == x.shape:
            row_faults += int((r["feats"] != x.cpu()).any(dim=1).sum())
        else:
            row_faults += n_real
        row_faults += r["pad_nonzero"]
        steps.append({
            "x": x,
            "blocks": [(torch.from_numpy(s[m].astype(np.int64)).to(dev),
                        torch.from_numpy(d[m].astype(np.int64)).to(dev))
                       for s, d, m in blocks],
            "labels": torch.from_numpy(
                data.labels_of(mb.seeds, cfg["n_classes"])).to(dev)})
    del rows, edges
    return faults, row_faults, steps


def _same_batch(mb, r) -> bool:
    return (all(np.array_equal(b.src_pos, s) and np.array_equal(b.dst_pos, d)
                and np.array_equal(b.edge_mask, m)
                for b, s, d, m in zip(mb.blocks, r["src"], r["dst"], r["em"]))
            and np.array_equal(mb.labels, r["labels"]))


def check(cell: dict, seed: int, records: list, warm: list, rowptr, col,
          graph_digest: str, row_seed: int, dev: torch.device) -> dict:
    """Each number compared, with its limit (``limits/<cell>.json``, which
    names the numbers compared)."""
    cfg, lim = cell["config"], cell["limits"]
    faults, row_faults, steps = reference_inputs(
        cell, seed, records, warm, rowptr, col, graph_digest, row_seed, dev)
    out = {"sample_faults": faults, "row_faults": row_faults}
    if len(steps) == len(records) == CHECK_STEPS:
        margs = cfg.get("model_args", {})
        p0 = reference.init_params(cfg["model"], seed, cfg["feature_dim"],
                                   cfg["hidden"], cfg["n_classes"], **margs)
        want = reference.run_steps(p0, steps, cfg["model"], cfg["lr"],
                                   **margs)
        out.update(reference.numbers(program_steps(records), want, p0))
    # the cell's limits name the numbers compared
    return {k: {"value": out.get(k, float("inf")), "limit": lim[k]}
            for k in lim}


# ------------------------------------------------------------ the result
def result_line(cell: dict, res: dict, trace: bool, device_info: dict) -> dict:
    correct = all(c["value"] <= c["limit"] for c in res["checks"].values())
    metrics, breakdown = {}, None
    if not trace:
        for m in cell["end_to_end"]:
            if m["name"] in res["e2e"]:
                metrics[m["name"]] = {"value": res["e2e"][m["name"]],
                                      "unit": m["unit"]}
    else:
        rec = res["record"]
        for m in cell["per_layer"]:
            v = load_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        d = rec["device"]
        if d:
            device_info = dict(device_info, busy_s=d["busy_s"],
                               window_s=d["window_s"])
            breakdown = {"device_ops": d["top_ops"], "idle_gaps": d["gaps"]}
    line = {"correct": correct, "attempted": res["n_batches"], "failed": 0,
            "metrics": metrics,
            "device": dict(device_info,
                           memory_peak_bytes=res["memory_peak_bytes"])}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = res["checks"]
    return line
