"""The port's twins of ``examples/quickstart.py`` and
``examples/serve_gnn.py`` at a tiny size on the CPU: each runs to its end
with ``--device cpu``, the server under ``HELIOS_CHAOS`` retries and still
answers every request, its ``--trace`` writes a Chrome trace that passes
``validate_trace``; without ``--device`` each asks for the card and, with
none, raises."""
import importlib.util
import json
import os

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_runs_on_the_cpu(capsys):
    st = _example("quickstart_torch").main(["--device", "cpu", "--rows",
                                            "4000", "--dim", "16"])
    out = capsys.readouterr().out
    assert "gathered" in out and "onto cpu" in out and "after drift" in out
    assert st.refreshes > 0 and st.promotions > 0
    assert st.device_hits + st.host_hits > 0


def test_serve_gnn_torch_runs_under_chaos_and_traces(tmp_path, monkeypatch,
                                                     capsys):
    from repro_torch.obs import trace
    from repro_torch.obs.export import validate_trace
    monkeypatch.setenv("HELIOS_CHAOS", "seed=7,read_error_rate=0.05")
    path = str(tmp_path / "serve.json")
    prev = trace.TRACER
    try:
        report = _example("serve_gnn_torch").main([
            "--device", "cpu", "--requests", "12", "--vertices", "3000",
            "--dim", "16", "--seeds-per-request", "8", "--rate", "2000",
            "--trace", path])
    finally:
        trace.TRACER = prev
    assert set(report) == {"helios", "gids", "cpu"}
    for mode, r in report.items():
        assert r["served"] + r["shed"] == 12, mode
    assert report["helios"]["served"] == 12
    assert report["helios"]["retries"] > 0
    with open(path) as fh:
        doc = json.load(fh)
    validate_trace(doc)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "ft.retry.r" in names and "cache.gather.submit" in names
    assert "trace:" in capsys.readouterr().out


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example("quickstart_torch").main(["--rows", "1000", "--dim", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example("serve_gnn_torch").main(["--requests", "2", "--vertices",
                                          "1024", "--dim", "8"])
