"""Guards for the port's package rules: it imports no JAX and nothing of
the reference package (not even a module with no JAX in it), and its
entry points default to the card and refuse to run quietly on the CPU."""
import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _bad_imports(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call):
            f = node.func
            fname = (f.attr if isinstance(f, ast.Attribute)
                     else f.id if isinstance(f, ast.Name) else "")
            if fname in ("import_module", "__import__", "find_spec"):
                bad += [a.value for a in node.args
                        if isinstance(a, ast.Constant)
                        and isinstance(a.value, str) and _forbidden(a.value)]
    return bad


def test_port_sources_exist():
    srcs = _sources()
    assert os.path.exists(srcs[0]), "chip_smoke.py is missing"
    assert len(srcs) > 20


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    assert _bad_imports(path) == []


def test_guard_catches_forbidden_imports(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("import jax.numpy as jnp\nfrom repro.core import rng\n"
                 "import importlib\nimportlib.import_module('repro.gnn')\n"
                 "__import__('jaxlib')\nimport repro_torch.core.rng\n")
    assert _bad_imports(str(p)) == ["jax.numpy", "repro.core", "repro.gnn",
                                    "jaxlib"]


def test_server_config_defaults_to_the_card():
    from repro_torch.serving import ServerConfig
    assert ServerConfig().device == "cuda"


def test_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core.hetero_cache import HeteroCache
    from repro_torch.core.iostack import FeatureStore
    from repro_torch.gnn.graph import synth_graph
    from repro_torch.gnn.models import init_gnn_params
    from repro_torch.serving import GNNInferenceServer, ServerConfig
    store = FeatureStore(str(tmp_path / "f"), n_rows=256, row_dim=8,
                         n_shards=2, create=True, rng_seed=0)
    g = synth_graph(256, 4, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNNInferenceServer(g, store, ServerConfig(request_batch_size=4,
                                                  chaos=None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HeteroCache(store, np.zeros(256), 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_gnn_params(torch.Generator(), "sage", 8, 4, 3)
