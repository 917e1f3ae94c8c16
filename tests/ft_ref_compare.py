"""Shared helpers of the fault, congestion and tracing tests that hold the
port (``repro_torch``, on the CPU) against the reference (``repro``):
each package's objects under one namespace, and a trainer run that
records what every batch sampled and gathered.  Not a test module."""
import functools
import threading
from types import SimpleNamespace

import numpy as np
import torch

import jax

import repro.checkpoint.checkpoint as r_ckpt
import repro.core.hetero_cache as r_hc
import repro.core.iostack as r_io
import repro.core.writeback as r_wb
import repro.ft.chaos as r_chaos
import repro.gnn.graph as r_graph
import repro.gnn.train as r_train
import repro.obs.analyze as r_analyze
import repro.obs.export as r_export
import repro.obs.metrics as r_metrics
import repro.obs.trace as r_trace
import repro.serving as r_serving
import repro_torch.checkpoint.checkpoint as t_ckpt
import repro_torch.core.hetero_cache as t_hc
import repro_torch.core.iostack as t_io
import repro_torch.core.writeback as t_wb
import repro_torch.ft.chaos as t_chaos
import repro_torch.gnn.graph as t_graph
import repro_torch.gnn.train as t_train
import repro_torch.obs.analyze as t_analyze
import repro_torch.obs.export as t_export
import repro_torch.obs.metrics as t_metrics
import repro_torch.obs.trace as t_trace
import repro_torch.serving as t_serving
from repro_torch.gnn.models import params_from_numpy


def _pkg(name, io, hc, wb, chaos, ckpt, graph, train, trace, export,
         analyze, metrics, serving, **kw):
    return SimpleNamespace(
        name=name, FeatureStore=io.FeatureStore,
        AsyncIOEngine=io.AsyncIOEngine, SyncIOEngine=io.SyncIOEngine,
        make_engine=io.make_engine, StreamClass=io.StreamClass,
        HeteroCache=kw.get("cache", hc.HeteroCache),
        FlushJournal=wb.FlushJournal,
        CheckpointManager=ckpt.CheckpointManager,
        ChaosSchedule=chaos.ChaosSchedule, RetryPolicy=chaos.RetryPolicy,
        FatalIOError=chaos.FatalIOError,
        RetriesExhausted=chaos.RetriesExhausted,
        SimulatedCrash=chaos.SimulatedCrash, synth_graph=graph.synth_graph,
        Trainer=train.OutOfCoreGNNTrainer,
        TrainerConfig=kw.get("trainer_cfg", train.TrainerConfig),
        Server=serving.GNNInferenceServer,
        ServerConfig=kw.get("server_cfg", serving.ServerConfig),
        zipf_workload=serving.zipf_workload, trace=trace,
        export=export, analyze=analyze, metrics=metrics)


REF = _pkg("ref", r_io, r_hc, r_wb, r_chaos, r_ckpt, r_graph, r_train,
           r_trace, r_export, r_analyze, r_metrics, r_serving)
PORT = _pkg("port", t_io, t_hc, t_wb, t_chaos, t_ckpt, t_graph, t_train,
            t_trace, t_export, t_analyze, t_metrics, t_serving,
            cache=functools.partial(t_hc.HeteroCache, device="cpu"),
            trainer_cfg=functools.partial(t_train.TrainerConfig,
                                          device="cpu"),
            server_cfg=functools.partial(t_serving.ServerConfig,
                                         device="cpu"))
PKGS = {"ref": REF, "port": PORT}


def host(rows) -> np.ndarray:
    """Gathered rows of either package (the port's cache returns a
    tensor) as numpy."""
    return rows.numpy() if isinstance(rows, torch.Tensor) else \
        np.asarray(rows)


def no_wall(values: dict) -> dict:
    """Stats fields without the wall-clock ones (the only fields two runs
    of the same inputs may differ in)."""
    return {k: v for k, v in values.items() if not k.startswith("wall")}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def record(tr):
    """Wrap one trainer's sampler and gather to record what each batch
    sampled and gathered (instance attributes only)."""
    seen = {"nodes": [], "src": [], "rows": []}
    sample, complete = tr.sampler.sample, tr.cache.complete_planned

    def sample_rec(seeds):
        mb = sample(seeds)
        seen["nodes"].append(mb.nodes)
        seen["src"].append(np.concatenate([b.src_pos for b in mb.blocks]))
        return mb

    def complete_rec(pg):
        out = complete(pg)
        seen["rows"].append(host(out[:len(pg.ids)]).copy())
        return out
    tr.sampler.sample, tr.cache.complete_planned = sample_rec, complete_rec
    return seen


def start_from(trainer, params_np):
    """Start the port's trainer from the reference's parameters."""
    p = params_from_numpy(params_np, "cpu")
    trainer.state = {"params": p, "opt": trainer.opt.init(p)}


def run_trainer(pkg, graph, store, n_batches, params_np=None, **cfg):
    """``n_batches`` of ``pkg``'s trainer over ``store``: (report, losses,
    what each batch sampled and gathered, the parameters it started from
    as numpy, the trainer's chaos stream counters)."""
    with pkg.Trainer(graph, store, pkg.TrainerConfig(**cfg)) as tr:
        if params_np is not None:
            start_from(tr, params_np)
        start = np_tree(tr.state["params"]) if pkg is REF else None
        seen = record(tr)
        out = tr.train(n_batches)
        return (out, [m["loss"] for m in tr.metrics_log], seen, start,
                list(tr.io._chaos_seq))


def train_raising(pkg, graph, store, n_batches, timeout_s, params_np=None,
                  **cfg):
    """``pkg``'s trainer in a thread of its own, ``train`` expected to
    raise: (the exception's type or None, whether ``train`` returned
    within ``timeout_s``, the threads the run started that are still
    alive once ``with`` has exited and the collector has run)."""
    import gc
    before = set(threading.enumerate())
    box = {}

    def body():
        try:
            with pkg.Trainer(graph, store, pkg.TrainerConfig(**cfg)) as tr:
                if params_np is not None:
                    start_from(tr, params_np)
                tr.train(n_batches)
        except BaseException as e:         # noqa: BLE001 - reported below
            box["type"] = type(e)
    # a daemon: a run that never returns must not hold the process open
    t = threading.Thread(target=body, name="train-raising", daemon=True)
    t.start()
    t.join(timeout_s)
    in_time = not t.is_alive()
    gc.collect()
    left = [th for th in threading.enumerate() if th not in before]
    for th in left:
        th.join(5.0)
    return box.get("type"), in_time, [th.name for th in left
                                      if th.is_alive()]
