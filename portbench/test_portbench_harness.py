"""The harness finds each cell's files and each metric's reader by name,
refuses to run without a card, and loads neither JAX nor the JAX package."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.conftest import CELLS, ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(name):
    cell = harness.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    cfg_entry = next(c for c in BENCH["configs"]
                     if c["name"] == entry["config"])
    assert cell["config"]["name"] == entry["config"]
    assert set(cfg_entry["reduced"]) <= set(cell["config"]["reduced_why"])
    assert cell["config"]["reduced"] == cfg_entry["reduced"]
    from repro_torch.gnn.train import TrainerConfig
    assert set(cell["traffic"]["trainer"]) <= set(
        TrainerConfig.__dataclass_fields__)
    # the run's counts of batches are the harness's, the same in every cell
    assert set(cell["traffic"]) == {"what", "trainer"}
    # exact sampling and rows, one of the two loss gaps, the output layer's
    # first gradients and the change over the checked steps; the worst
    # leaf's first gradient where a limit fits between its readings
    lim = set(cell["limits"])
    assert {"sample_faults", "row_faults", "head_grad_gap",
            "update_gap"} <= lim
    assert len(lim & {"loss_gap", "loss1_gap"}) == 1
    assert lim <= {"sample_faults", "row_faults", "loss_gap", "loss1_gap",
                   "grad_gap", "head_grad_gap", "update_gap"}
    assert {m["name"] for m in cell["end_to_end"]} == {
        "device_ms_per_batch", "setup_s"}
    assert cell["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.load_reader(metric))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no-such.cell")


def test_every_file_lies_under_paths():
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p))
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    assert BENCH["command"][1].startswith(tuple(BENCH["paths"]))


def _run(code: str, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)


def test_run_without_a_card_prints_no_result():
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_no_jax_after_a_cpu_dry_run():
    """The harness's modules, every metric reader and a CPU run of a tiny
    cell leave no module whose top-level name is jax, jaxlib, flax or the
    JAX package ``repro`` (``repro_torch`` is not ``repro``)."""
    code = f"""
import sys, time
sys.path[:0] = [{ROOT!r}]
from portbench import harness, calibrate, run
from portbench.conftest import CELLS
harness.WARMUP_BATCHES, harness.MIN_BATCHES = 4, 2
for name in CELLS:
    cell = harness.load_cell(name)
    cell["config"].update(n_vertices=1500, feature_dim=8, hidden=8,
                          batch_size=16, fanouts=[3, 2])
    res = harness.run_cell(cell, 3, 0.1, True, "cpu", time.perf_counter())
    harness.result_line(cell, res, True, {{}})
print("found:", ",".join(harness.jax_modules()))
print("repro_torch loaded:", "repro_torch" in sys.modules)
"""
    p = _run(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "found: \n" in p.stdout
    assert "repro_torch loaded: True" in p.stdout


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake.sub", object())
    monkeypatch.setitem(sys.modules, "reprox", object())
    assert "repro_torch_fake" not in harness.jax_modules()
    assert "reprox" not in harness.jax_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_sub", object())
    assert "repro" in harness.jax_modules()
