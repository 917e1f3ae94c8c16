"""The phase spans inside the out-of-core trainer's operators, on the CPU.

A traced ``OutOfCoreGNNTrainer.train`` opens each operator's ``pipe.<op>``
span before the operator runs, so what the operator opens on its thread
names it as parent: the six phase spans (the IO wait and the landing, the
step's dispatch and its wait for the device, the sampler's draws and
relabelling) and the cache's ``cache.gather.*`` spans, and through them
the IO engine's.  Tracing changes nothing the trainer computes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.iostack import FeatureStore  # noqa: E402
from repro_torch.core.pipeline import Operator, PipelineExecutor  # noqa: E402
from repro_torch.gnn.graph import synth_graph  # noqa: E402
from repro_torch.gnn.train import OutOfCoreGNNTrainer  # noqa: E402
from repro_torch.gnn.train import TrainerConfig  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

# each phase span and the operator whose span is its parent
PHASES = {"pipe.io_complete.wait": "pipe.io_complete",
          "pipe.io_complete.land": "pipe.io_complete",
          "pipe.train.dispatch": "pipe.train",
          "pipe.train.sync": "pipe.train",
          "sample.draw": "pipe.sample",
          "sample.relabel": "pipe.sample"}
N_V, N_BATCHES = 2000, 3
# small tiers, so that every batch reads rows from storage
CFG = dict(device="cpu", batch_size=32, fanouts=(4, 3), hidden=16,
           presample_batches=2, chaos=None, seed=0, device_cache_frac=0.05,
           host_cache_frac=0.1)
MODES = ("helios", "helios-nopipe")


def _train(root, traced, **cfg):
    """``train(N_BATCHES)`` on a fresh store and trainer, with a tracer
    installed around the call alone; returns (tracer, report, losses)."""
    g = synth_graph(N_V, 8, skew=1.0, seed=0)
    st = FeatureStore(str(root / "f"), n_rows=N_V, row_dim=16, n_shards=4,
                      create=True, rng_seed=3)
    prev, tr = trace.TRACER, None
    with OutOfCoreGNNTrainer(g, st, TrainerConfig(**CFG, **cfg)) as trn:
        if traced:
            tr = trace.install()
        try:
            out = trn.train(N_BATCHES)
        finally:
            trace.TRACER = prev
        losses = [m["loss"] for m in trn.metrics_log]
    return tr, out, losses


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    return {m: _train(tmp_path_factory.mktemp(m), True, mode=m)[0]
            for m in MODES}


def _ancestors(sp, by_id):
    while sp.parent in by_id:
        sp = by_id[sp.parent]
        yield sp


@pytest.mark.parametrize("mode", MODES)
def test_one_of_each_phase_per_batch(traced, mode):
    tr = traced[mode]
    for name in PHASES:
        assert sum(s.name == name for s in tr.spans) == N_BATCHES, name
        assert all(s.cat == "phase" and s.v0 is None
                   for s in tr.spans if s.name == name)


@pytest.mark.parametrize("mode", MODES)
def test_phases_lie_inside_their_operator(traced, mode):
    """Each phase names its operator's span as parent, on the same thread,
    inside its interval; the trainer's phases carry its batch, and every
    batch has each phase once."""
    tr = traced[mode]
    by_id = {s.sid: s for s in tr.spans}
    for name, op in PHASES.items():
        batches = []
        for s in (s for s in tr.spans if s.name == name):
            parent = by_id[s.parent]
            assert parent.name == op and parent.cat == "pipe"
            assert s.tname == parent.tname
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
            if name.startswith("pipe."):
                assert s.args["batch"] == parent.args["batch"]
            batches.append(parent.args["batch"])
        assert sorted(batches) == list(range(N_BATCHES)), name


@pytest.mark.parametrize("mode", MODES)
def test_phase_args_count_their_work(traced, mode):
    tr = traced[mode]
    spans = {n: [s for s in tr.spans if s.name == n] for n in PHASES}
    assert all(s.args["storage_rows"] > 0
               for s in spans["pipe.io_complete.wait"])
    assert [s.args["rows"] for s in spans["pipe.io_complete.land"]] == [
        s.args["storage_rows"] + s.args["remote_rows"]
        for s in spans["pipe.io_complete.wait"]]
    # 32 seeds, 4 neighbours each, then 3 for each distinct one of those
    for s in spans["sample.draw"]:
        hop2 = s.args["edges"] - 32 * 4
        assert 0 < hop2 <= 32 * 4 * 3 and hop2 % 3 == 0
    assert all(32 < s.args["nodes"] <= 32 * (1 + 4 + 12)
               for s in spans["sample.relabel"])
    assert {s.args["seeds"] for s in spans["pipe.train.dispatch"]} == {32}


@pytest.mark.parametrize("mode", MODES)
def test_gather_and_engine_spans_reach_their_operator(traced, mode):
    """Every ``cache.gather.*`` span has a ``pipe.*`` span as its nearest
    ancestor outside the cache, and every engine read it issued
    (``io.qwait``, ``io.service.r``) reaches one too."""
    tr = traced[mode]
    by_id = {s.sid: s for s in tr.spans}
    gathers = [s for s in tr.spans if s.name.startswith("cache.gather.")]
    assert gathers
    for s in gathers:
        outer = next(a for a in _ancestors(s, by_id)
                     if not a.name.startswith("cache."))
        assert outer.name.startswith("pipe."), (s.name, outer.name)
    reads = [s for s in tr.spans if s.name in ("io.qwait", "io.service.r")]
    assert reads
    for s in reads:
        assert any(a.cat == "pipe" for a in _ancestors(s, by_id)), s.name


@pytest.mark.parametrize("mode", MODES)
def test_tracing_changes_nothing_computed(tmp_path, mode):
    """At one batch in flight (the sampler's draws then do not interleave)
    the traced run's losses, cache and IO report are the plain run's."""
    _, plain, plain_losses = _train(tmp_path / "a", False, mode=mode,
                                    prefetch_depth=1)
    tr, got, losses = _train(tmp_path / "b", True, mode=mode,
                             prefetch_depth=1)
    assert any(s.name == "sample.draw" for s in tr.spans)
    assert losses == plain_losses
    assert got["cache"] == plain["cache"]
    assert got["io"] == plain["io"]
    assert got["virtual_s"] == plain["virtual_s"]


def test_operator_that_raises_leaves_no_span():
    """The raising operator's span is dropped and the thread's stack left
    empty; the operator before it keeps its span and virtual stamps."""
    def boom(ctx):
        with trace.TRACER.span("inner", cat="phase"):
            raise RuntimeError("fault")

    plan = [Operator("first", lambda ctx: None, "host"),
            Operator("second", boom, "host", ("first",))]
    pipe = PipelineExecutor(plan, mode="nopipe")
    prev, tr = trace.TRACER, trace.install()
    try:
        with pytest.raises(RuntimeError, match="fault"):
            pipe.run(lambda i: {}, 1)
        assert tr.current() is None
    finally:
        trace.TRACER = prev
        pipe.close()
    names = [s.name for s in tr.spans]
    assert "pipe.first" in names and "pipe.second" not in names
    first = next(s for s in tr.spans if s.name == "pipe.first")
    assert first.v0 is not None and first.args["batch"] == 0
    inner = next(s for s in tr.spans if s.name == "inner")
    assert inner.args["error"] is True


def test_untraced_operator_opens_no_span():
    seen = []
    plan = [Operator("only", lambda ctx: seen.append(trace.TRACER), "host")]
    pipe = PipelineExecutor(plan, mode="nopipe")
    prev = trace.uninstall()
    try:
        out = pipe.run(lambda i: {}, 2)
    finally:
        trace.TRACER = prev
        pipe.close()
    assert seen == [None, None]
    assert out["stages"]["only"]["calls"] == 2
    assert np.isfinite(out["virtual_s"])
