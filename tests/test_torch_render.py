"""``experiments/render_tables_torch.py`` on a three-row dry-run fixture
(one cell ``ok``, one ``skip``, one ``fail``) and a two-variant hillclimb
chain made here."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "experiments", "render_tables_torch.py")


def _row(**kw):
    row = {"cell": "llama3.2-3b/train_4k/2x16x16", "status": "ok",
           "peak_mem_gb_per_chip": 10.49, "fits_80gb": True,
           "t_compute_ms": 279.0, "t_memory_ms": 1410.9,
           "t_memory_floor_ms": 4.1, "t_collective_ms": 373.4,
           "bottleneck": "memory", "useful_flops_frac": 0.23,
           "mfu_bound": 0.0635, "t_run_s": 77.7,
           "collectives": {"all-reduce": 6092, "all-gather": 1576},
           "collectives_in_backward": {"all-reduce": 680,
                                       "all-gather": 896}}
    row.update(kw)
    return row


def _render(tmp_path, which, doc):
    path = tmp_path / f"{which}.json"
    path.write_text(json.dumps(doc))
    res = subprocess.run([sys.executable, SCRIPT, which, str(path)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip().splitlines()


def test_roofline_table_rows(tmp_path):
    lines = _render(tmp_path, "roofline", [
        _row(),
        {"cell": "llama3.2-3b/long_500k/2x16x16", "status": "skip",
         "reason": "full-attention arch"},
        {"cell": "whisper-small/decode_32k/2x16x16", "status": "fail",
         "error": "RuntimeError: Attempted to split the sharded dimension"}])
    assert len(lines) == 5 and "fits" in lines[0] and "run s" in lines[0]
    ok, skip, fail = lines[2:]
    assert ok.split(" | ")[1:4] == ["10.5", "yes", "279.0"]
    assert "| 77.7 |" in ok
    assert "all-gather 1576, all-reduce 6092 (all-gather 896, " \
        "all-reduce 680)" in ok
    assert "| skip: sub-quadratic only |" in skip
    assert "| FAIL |" in fail and "RuntimeError: Attempted to split the" \
        in fail


def test_perf_table_verdicts(tmp_path):
    base = _row(variant="baseline", hypothesis="paper-faithful")
    nxt = _row(variant="bf16_grads", hypothesis="halve the grad bytes",
               t_memory_ms=1269.8, t_collective_ms=186.7,
               peak_mem_gb_per_chip=9.49, t_run_s=70.0)
    lines = _render(tmp_path, "perf", [{"cell": "llama_train",
                                        "rows": [base, nxt]}])
    assert lines[0] == "**Cell: llama_train**"
    assert lines[-2].startswith("| baseline | paper-faithful | 1411 | 373 ")
    assert lines[-1].endswith("| 70.0 | mem -10%, coll -50%, peak -1.0GB |")
