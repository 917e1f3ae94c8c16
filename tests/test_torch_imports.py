"""Guards for the port's package rules: it imports no JAX and nothing of
the reference package (not even a module with no JAX in it), its copies
of the reference's framework-free modules differ from them only in import
and docstring lines, and its entry points default to the card and refuse
to run quietly on the CPU."""
import ast
import difflib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "examples", "train_gnn_outofcore_torch.py"),
           os.path.join(ROOT, "examples", "serve_decode_torch.py"),
           os.path.join(ROOT, "examples", "train_llm_tiered_torch.py"),
           os.path.join(ROOT, "examples", "quickstart_torch.py"),
           os.path.join(ROOT, "examples", "serve_gnn_torch.py"),
           # the write leg's checks, which chip_smoke.py imports
           os.path.join(ROOT, "tests", "writeback_compare.py")]
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
    assert os.path.exists(srcs[1]), "the port's trainer example is missing"
    assert os.path.exists(srcs[2]), "the port's serving example is missing"
    assert os.path.exists(srcs[3]), "the port's LM training example is missing"
    assert os.path.exists(srcs[4]), "the port's quickstart is missing"
    assert os.path.exists(srcs[5]), "the port's GNN serving example is missing"
    assert os.path.exists(srcs[6]), "the write leg's checks are missing"
    for mod in ("models/moe", "models/rglru", "models/encdec",
                "models/frontends", "data/tokens", "launch/train",
                "distributed/sharding", "launch/mesh", "launch/roofline",
                "launch/op_cost", "launch/dryrun", "launch/hillclimb",
                "kernels/dry_run"):
        assert os.path.join(PORT, f"{mod}.py") in srcs, mod
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


# the reference's framework-free modules the port keeps as copies, paths
# relative to src/repro and src/repro_torch
COPIES = (["core/" + m + ".py" for m in ("rng", "simulator", "iostack",
                                         "writeback", "policy", "hotness",
                                         "pipeline")]
          + ["data/tokens.py", "ft/chaos.py", "ft/failures.py",
             "gnn/graph.py",
             "gnn/sampling.py", "serving/scheduler.py", "serving/stats.py",
             "distributed/partition.py", "distributed/remote_engine.py"]
          + ["obs/" + f for f in sorted(os.listdir(os.path.join(PORT, "obs")))
             if f.endswith(".py")]
          + ["configs/" + f
             for f in sorted(os.listdir(os.path.join(PORT, "configs")))
             if f.endswith(".py")])


# where a copy departs from the reference on purpose: the functions, by
# qualified name, whose lines (and the blank lines around them) may differ
# on either side, each for a reason of the port's own
PORT_ONLY = {
    # the operator's ``pipe.<op>`` span opens before the operator runs, so
    # the spans the operator opens name it as parent
    "core/pipeline.py": ("PipelineExecutor._run_op",
                         "PipelineExecutor._run_op_traced",
                         "PipelineExecutor._account"),
    # the sampler's neighbour draws and relabelling, timed apart when traced
    "gnn/sampling.py": ("NeighborSampler.sample", "NeighborSampler._draw",
                        "NeighborSampler._relabel"),
    # an operator that raises leaves no span; the operators' phase spans
    "obs/trace.py": ("Tracer.drop", "phase"),
    # the port's trainer publishes no queue-wait gauges, so no bridge
    "obs/metrics.py": ("publish_qwait",),
}


def _function_lines(src: str, names) -> set:
    """Line numbers of the functions ``names`` (``Class.method`` or a
    module-level name) in ``src``, with the blank lines around each."""
    lines, out = src.splitlines(), set()

    def visit(body, prefix):
        for node in body:
            if isinstance(node, ast.ClassDef):
                visit(node.body, prefix + node.name + ".")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and prefix + node.name in names:
                first = min([node.lineno] + [d.lineno
                                             for d in node.decorator_list])
                last = node.end_lineno
                while first > 1 and not lines[first - 2].strip():
                    first -= 1
                while last < len(lines) and not lines[last].strip():
                    last += 1
                out.update(range(first, last + 1))

    visit(ast.parse(src).body, "")
    return out


def _import_or_docstring_lines(src: str) -> set:
    """Line numbers of ``src`` inside an import statement (``import``,
    ``from``, ``importlib.import_module``) or a docstring."""
    ok = set()
    for node in ast.walk(ast.parse(src)):
        span = None
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            span = node
        elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and \
                node.func.attr == "import_module":
            span = node
        elif isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                               ast.AsyncFunctionDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and \
                isinstance(node.body[0].value, ast.Constant) and \
                isinstance(node.body[0].value.value, str):
            span = node.body[0]
        if span is not None:
            ok.update(range(span.lineno, span.end_lineno + 1))
    return ok


def _copy_drift(ref_src: str, port_src: str, port_only=()) -> list:
    """Lines where the copy differs from the reference outside import and
    docstring lines and the functions ``port_only``: ``(side, line
    number, text)``."""
    ok_ref = (_import_or_docstring_lines(ref_src)
              | _function_lines(ref_src, port_only))
    ok_port = (_import_or_docstring_lines(port_src)
               | _function_lines(port_src, port_only))
    a, b = ref_src.splitlines(), port_src.splitlines()
    drift = []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, a, b, autojunk=False).get_opcodes():
        if tag != "equal":
            drift += [("-", i + 1, a[i]) for i in range(i1, i2)
                      if i + 1 not in ok_ref]
            drift += [("+", j + 1, b[j]) for j in range(j1, j2)
                      if j + 1 not in ok_port]
    return drift


@pytest.mark.parametrize("rel", COPIES)
def test_copies_differ_only_in_imports_and_docstrings(rel):
    with open(os.path.join(ROOT, "src", "repro", rel)) as f:
        ref_src = f.read()
    with open(os.path.join(PORT, rel)) as f:
        port_src = f.read()
    assert _copy_drift(ref_src, port_src, PORT_ONLY.get(rel, ())) == []


def test_copy_check_catches_code_changes():
    ref_src = ('"""doc."""\nfrom repro.core import rng\n\n\ndef f(x):\n'
               '    """Add one."""\n    return x + 1\n')
    ok = ref_src.replace("repro.core", "repro_torch.core").replace(
        "Add one.", "Add one, as the reference does.")
    assert _copy_drift(ref_src, ok) == []
    bad = ok.replace("x + 1", "x + 2")
    assert _copy_drift(ref_src, bad) == [("-", 7, "    return x + 1"),
                                         ("+", 7, "    return x + 2")]


def test_copy_check_allows_only_the_named_functions():
    ref_src = ('"""doc."""\n\n\nclass A:\n    def f(self, x):\n'
               '        return x + 1\n\n    def g(self, x):\n'
               '        return x - 1\n\n\ndef h():\n    return 0\n')
    f_changed = ref_src.replace("x + 1", "x + 2")
    assert _copy_drift(ref_src, f_changed, ("A.f",)) == []
    assert _copy_drift(ref_src, f_changed, ("A.g", "f")) == [
        ("-", 6, "        return x + 1"), ("+", 6, "        return x + 2")]
    # a function of the port's own, or one the port dropped
    added = ref_src.replace("\n\ndef h", "\n\ndef k():\n    pass\n\n\ndef h")
    assert _copy_drift(ref_src, added, ("k",)) == []
    assert _copy_drift(ref_src, added) != []
    dropped = ref_src[:ref_src.index("\n\n\ndef h")] + "\n"
    assert _copy_drift(ref_src, dropped, ("h",)) == []
    assert _copy_drift(ref_src, dropped) != []


@pytest.mark.parametrize("rel", sorted(PORT_ONLY))
def test_port_only_functions_exist(rel):
    """Each function named as the port's own departure is found in the
    port's copy or, where the port dropped it, in the reference."""
    with open(os.path.join(ROOT, "src", "repro", rel)) as f:
        ref_src = f.read()
    with open(os.path.join(PORT, rel)) as f:
        port_src = f.read()
    for name in PORT_ONLY[rel]:
        assert (_function_lines(port_src, (name,))
                or _function_lines(ref_src, (name,))), name


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


def test_trainer_config_defaults_to_the_card():
    from repro_torch.gnn.train import TrainerConfig
    assert TrainerConfig().device == "cuda"


def test_trainer_raises_without_a_card(tmp_path):
    """The trainer, its example and a checkpoint restore to the card all
    refuse to run quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib.util
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core.iostack import FeatureStore
    from repro_torch.gnn.graph import synth_graph
    from repro_torch.gnn.train import OutOfCoreGNNTrainer, TrainerConfig
    store = FeatureStore(str(tmp_path / "f"), n_rows=256, row_dim=8,
                         n_shards=2, create=True, rng_seed=0)
    g = synth_graph(256, 4, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OutOfCoreGNNTrainer(g, store, TrainerConfig(batch_size=8,
                                                    fanouts=(2, 2),
                                                    chaos=None))
    spec = importlib.util.spec_from_file_location(
        "train_gnn_outofcore_torch",
        os.path.join(ROOT, "examples", "train_gnn_outofcore_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--steps", "1", "--vertices", "1024", "--dim", "8"])
    ck = CheckpointManager(str(tmp_path / "ck"), async_write=False)
    ck.save(1, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.restore(device="cuda")


def test_lm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = get_config("llama3.2-3b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "rwkv6-7b"])


def test_lm_family_entry_points_default_to_the_card():
    """Every family's parameters, caches, frontend, launcher and the
    serving example refuse to run quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib.util
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import encdec, frontends, lm
    for name in ("qwen2-moe-a2.7b", "recurrentgemma-2b",
                 "phi-3-vision-4.2b", "whisper-small"):
        cfg = get_config(name).reduced()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm.init_params(torch.Generator(), cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", name])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(get_config("recurrentgemma-2b").reduced(), 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encdec.init_cache(get_config("whisper-small").reduced(), 2, 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frontends.init_frontend(torch.Generator(), 8, torch.float32)
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch",
        os.path.join(ROOT, "examples", "serve_decode_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--arch", "kimi-k2-1t-a32b"])


def test_lm_train_entry_points_default_to_the_card():
    """The training launcher and the LM training example refuse to run
    quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib.util
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "llama3.2-3b", "--steps", "1"])
    spec = importlib.util.spec_from_file_location(
        "train_llm_tiered_torch",
        os.path.join(ROOT, "examples", "train_llm_tiered_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--steps", "1"])


def test_dry_run_defaults_to_the_card():
    """The dry run counts the card's program unless asked for the CPU's:
    ``--device`` and ``run_cell`` default to cuda, and without a CUDA
    build its cell fails rather than count the CPU program."""
    import inspect

    from repro_torch.launch import dryrun
    assert inspect.signature(dryrun.run_cell).parameters[
        "device"].default == "cuda"
    assert inspect.signature(dryrun.count_step).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        assert dryrun.main(["--arch", "llama3.2-3b", "--shape", "train_4k",
                            "--mesh", "1x1", "--width", "reduced"]) == 1
