"""The readers of the phases inside the trainer's operators, the idle-gap
labels those phases give, and the in-memory IG cell, on the CPU."""
from __future__ import annotations

import time

import pytest

from portbench import devtrace, harness
from portbench.test_portbench_metrics import EVENTS

# each reader and the span it reads
PHASE_READERS = {"io.wait_ms": "pipe.io_complete.wait",
                 "io.land_ms": "pipe.io_complete.land",
                 "step.dispatch_ms": "pipe.train.dispatch",
                 "step.sync_ms": "pipe.train.sync",
                 "sampler.draw_ms": "sample.draw",
                 "sampler.relabel_ms": "sample.relabel"}
TRACED_CELLS = ("sage-ig.ooc", "gcn-pa.inmem", "sage-ig.inmem")


@pytest.mark.parametrize("metric", sorted(PHASE_READERS))
def test_phase_reader_on_a_record(metric):
    span = PHASE_READERS[metric]
    rec = {"spans": {span: [0.010, 0.030, 0.020],
                     "pipe.train": [1.0], "pipe.io_complete": [1.0]}}
    assert harness.load_reader(metric)(rec) == pytest.approx(20.0)


@pytest.mark.parametrize("metric", sorted(PHASE_READERS))
def test_phase_reader_finds_nothing_to_read(metric):
    # the parent program has the operators' spans and none of the phases
    rec = {"spans": {"pipe.train": [1.0], "pipe.io_complete": [1.0],
                     "pipe.sample": [1.0]}}
    assert harness.load_reader(metric)(rec) is None
    assert harness.load_reader(metric)({"spans": {}}) is None


def test_gap_inside_the_io_wait_is_labelled_with_the_phase():
    # the longest idle interval, 6000-9000, has its middle at 7500: inside
    # the operator and its wait, not inside its landing
    spans = [("pipe.io_complete", 3500, 9500),
             ("pipe.io_complete.wait", 5800, 8000),
             ("pipe.io_complete.land", 8000, 9500)]
    d = devtrace.reduce_events(EVENTS, spans)
    assert d["gaps"][0] == ["io_complete+io_complete.wait",
                            pytest.approx(3000e-9)]
    # 4000-5000: the operator open, neither phase
    assert ["io_complete", pytest.approx(1000e-9)] in d["gaps"]


def test_in_memory_cell_is_the_out_of_core_cells_model():
    """``sage-ig.inmem`` runs ``sage-ig.ooc``'s configuration and limits
    with every row on the device tier."""
    inmem, ooc = harness.load_cell("sage-ig.inmem"), harness.load_cell(
        "sage-ig.ooc")
    assert inmem["config"] == ooc["config"]
    assert inmem["limits"] == ooc["limits"]
    tiers = inmem["traffic"]["trainer"]
    assert (tiers["device_cache_frac"], tiers["host_cache_frac"]) == (1.0,
                                                                      0.0)
    assert {k: v for k, v in tiers.items() if not k.endswith("cache_frac")} \
        == {k: v for k, v in ooc["traffic"]["trainer"].items()
            if not k.endswith("cache_frac")}


@pytest.mark.parametrize("name", TRACED_CELLS)
def test_traced_tiny_run_reports_the_phases(name, tiny_cell):
    """A traced run of each cell at a tiny size is correct and its line
    carries the six phase metrics; the operators' phases lie within the
    operators' time."""
    cell = tiny_cell(name)
    res = harness.run_cell(cell, 2**31 + 5, 0.2, True, "cpu",
                           time.perf_counter())
    line = harness.result_line(cell, res, True, {})
    assert line["correct"], line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(PHASE_READERS) <= set(m)
    for part, whole in (("io.wait_ms", "io.complete_ms"),
                        ("step.dispatch_ms", "step.train_ms"),
                        ("sampler.draw_ms", "sampler.sample_ms")):
        if whole in m:
            assert 0 < m[part] < m[whole]
    spans = res["record"]["spans"]
    for pair, op in ((("pipe.io_complete.wait", "pipe.io_complete.land"),
                      "pipe.io_complete"),
                     (("pipe.train.dispatch", "pipe.train.sync"),
                      "pipe.train")):
        assert sum(sum(spans[p]) for p in pair) <= sum(spans[op])
