"""Fixtures of the benchmark's CPU tests: its cells at a tiny size."""
from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _first_cells() -> tuple:
    """The first cell of each configuration in ``BENCHMARK.json``: the CPU
    checks run each configuration's model and limits once."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    first: dict = {}
    for w in bench["workloads"]:
        first.setdefault(w["config"], w["name"])
    return tuple(first.values())


CELLS = _first_cells()


@pytest.fixture
def tiny_cell(monkeypatch):
    """``tiny_cell(name)``: the cell ``name`` as its files give it, with
    the sizes and the run's counts of batches cut so that a run takes
    about a second on a CPU."""
    from portbench import harness
    monkeypatch.setattr(harness, "WARMUP_BATCHES", 5)
    monkeypatch.setattr(harness, "MIN_BATCHES", 2)

    def make(name: str) -> dict:
        cell = harness.load_cell(name)
        cell["config"].update(n_vertices=2000, feature_dim=16, hidden=16,
                              batch_size=32, fanouts=[4, 3])
        return cell
    return make
