"""A configuration's model found by name (``models/<model>.py``): each
model's layer is its formula and takes every product through the ``mm`` it
is given; a model planted in a directory of its own is checked, counted
and read with no file of ``portbench/`` edited; the configuration's
``model_args`` reach the trainer, the model's file and the traced record;
and the trace's reduction times every kernel by name."""
from __future__ import annotations

import os
import textwrap
import time

import numpy as np
import pytest
import torch

from portbench import counts, devtrace, harness, models, reference
from portbench.conftest import CELLS, ROOT
from portbench.test_portbench_counts import BLOCKS, MASK
from portbench.test_portbench_metrics import EVENTS, SPANS


# ------------------------------------------------------------- inputs
def _steps(seed: int, n=40, dim=6, batch=8, n_classes=3) -> list:
    """Three steps over two tiny seeded batches (the first one twice):
    outer hop first, the inner hop's edges ending at the seeds."""
    gen = torch.Generator().manual_seed(seed)
    batches = []
    for _ in range(2):
        outer = (torch.randint(0, n, (60,), generator=gen),
                 torch.randint(0, n, (60,), generator=gen))
        inner = (torch.randint(0, n, (24,), generator=gen),
                 torch.randint(0, batch, (24,), generator=gen))
        batches.append({
            "x": torch.randn((n, dim), generator=gen),
            "blocks": [outer, inner],
            "labels": torch.randint(0, n_classes, (batch,), generator=gen)})
    return [batches[0], batches[1], batches[0]]


# ------------------------------------------------------- the two models
def _edges(seed: int, n=12, e=30):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randint(0, n, (e,), generator=gen),
            torch.randint(0, n // 2, (e,), generator=gen),
            torch.randn((n, 5), generator=gen, dtype=torch.float64))


def _adjacency(src, dst, n):
    """``a[v, u]``: the number of valid edges from ``u`` to ``v``."""
    a = np.zeros((n, n))
    np.add.at(a, (dst.numpy(), src.numpy()), 1.0)
    return a


@pytest.mark.parametrize("model", ["sage", "gcn"])
def test_model_layer_is_its_formula(model):
    """Each model's layer, in float64, is its paper's formula written with
    the block's dense adjacency matrix: sage ``relu(h w_self + D^-1 A h
    w_neigh + b)``, gcn ``relu(D_dst^-1/2 A D_src^-1/2 h w + b)``, the
    degrees counted over the valid edges and at least 1."""
    mod = models.load(model)
    src, dst, h = _edges(5)
    n = h.shape[0]
    gen = torch.Generator().manual_seed(6)

    def dense(d_in, d_out):
        return torch.randn((d_in, d_out), generator=gen, dtype=torch.float64)

    p = {k: v.double() + 0.1 for k, v in
         mod.init_layer(dense, 0, 5, 4).items()}
    got = mod.layer(p, 0, h, src, dst, n, torch.matmul).numpy()
    a, x = _adjacency(src, dst, n), h.numpy()
    if model == "sage":
        mean = a / np.maximum(a.sum(1), 1.0)[:, None]
        want = (x @ p["layers.0.w_self"].numpy()
                + mean @ x @ p["layers.0.w_neigh"].numpy()
                + p["layers.0.b"].numpy())
    else:
        d_dst = np.maximum(a.sum(1), 1.0) ** -0.5
        d_src = np.maximum(a.sum(0), 1.0) ** -0.5
        want = ((d_dst[:, None] * a * d_src[None, :]) @ x
                @ p["layers.0.w"].numpy() + p["layers.0.b"].numpy())
    np.testing.assert_allclose(got, np.maximum(want, 0.0), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("model,products", [("sage", 2), ("gcn", 1)])
def test_model_layer_takes_every_product_through_mm(model, products):
    """Every dense product of a layer goes through the ``mm`` it is given,
    so that the TF32 control and the float64 witness reach all of them."""
    mod = models.load(model)
    src, dst, h = _edges(7)
    h = h.float()
    gen = torch.Generator().manual_seed(8)
    p = mod.init_layer(
        lambda i, o: torch.randn((i, o), generator=gen), 0, 5, 4)
    calls = []

    def mm(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return a @ b
    ref = mod.layer(p, 0, h, src, dst, h.shape[0], torch.matmul)
    got = mod.layer(p, 0, h, src, dst, h.shape[0], mm)
    assert torch.equal(got, ref)
    assert calls == [((h.shape[0], 5), (5, 4))] * products
    # a product left out of ``mm`` would survive a zero ``mm``
    zero = mod.layer(p, 0, h, src, dst, h.shape[0],
                     lambda a, b: torch.zeros(a.shape[0], b.shape[1]))
    assert torch.equal(zero, torch.relu(p["layers.0.b"]).expand_as(zero))


# ------------------------------------------------------ a planted model
TOY = '''
"""A toy model: h <- tanh((h + the sum at dst of h[src]) @ w * scale)."""
import torch

from portbench import counts

SEEN = []


def init_layer(dense, i, d_in, hidden, scale):
    SEEN.append(("init_layer", scale))
    return {f"layers.{i}.w": dense(d_in, hidden)}


def layer(p, i, h, src, dst, n, mm, scale):
    SEEN.append(("layer", scale))
    s = torch.zeros((n, h.shape[1]), dtype=h.dtype,
                    device=h.device).index_add(0, dst, h[src])
    return torch.tanh(mm(h + s, p[f"layers.{i}.w"]) * scale)


def flops(sizes, d_in, hidden, n_classes, scale):
    SEEN.append(("flops", scale))
    return 7 * sizes["batch"]


def agg_calls(sizes, d_in, hidden, scale):
    SEEN.append(("agg_calls", scale))
    return [counts.k2_call(sizes["hops"][0], d_in, "src_valid_distinct")]
'''


def _plant(tmp_path, monkeypatch, **files):
    d = tmp_path / "models"
    d.mkdir()
    for name, text in files.items():
        (d / f"{name}.py").write_text(text)
    monkeypatch.setattr(models, "DIR", str(d))


def _toy_loss(p, st, scale):
    """The toy's forward and the reference's head, by hand."""
    h = st["x"]
    for i, (src, dst) in enumerate(reversed(st["blocks"])):
        s = torch.zeros_like(h).index_add(0, dst, h[src])
        h = torch.tanh(((h + s) @ p[f"layers.{i}.w"]) * scale)
    logits = h[:len(st["labels"])] @ p["head.w"] + p["head.b"]
    return torch.nn.functional.cross_entropy(logits, st["labels"])


def test_a_planted_model_is_checked_and_counted(tmp_path, monkeypatch):
    """A model file in a directory of its own is what the reference runs
    and the counts count, with its settings; no file of ``portbench/``
    names it."""
    before = sorted(os.listdir(os.path.join(ROOT, "portbench", "models")))
    _plant(tmp_path, monkeypatch, toy=TOY)
    p0 = reference.init_params("toy", 3, 6, 5, 3, scale=0.5)
    assert list(p0) == ["layers.0.w", "layers.1.w", "head.w", "head.b"]
    steps = _steps(31)
    loss = reference.forward_loss(p0, steps[0]["x"], steps[0]["blocks"],
                                  steps[0]["labels"], "toy", scale=0.5)
    assert float(loss) == pytest.approx(float(_toy_loss(p0, steps[0], 0.5)),
                                        rel=1e-6)
    got = reference.run_steps(p0, steps, "toy", 1e-2, scale=0.5)
    assert len(got["losses"]) == 3
    assert got["losses"][0] == pytest.approx(float(loss), rel=1e-6)
    assert all(not torch.equal(got["params"][k], p0[k]) for k in p0)
    sizes = counts.batch_sizes(BLOCKS, MASK, 2)
    assert counts.model_flops("toy", sizes, 4, 3, 2, scale=0.5) == \
        3.0 * (7 * 2 + 2 * 2 * 3 * 2)
    assert counts.agg_calls("toy", sizes, 4, 3, scale=0.5) == [
        ("k2", (4, 4), counts.k2_bytes(4, 4, 3))]
    seen = models.load("toy").SEEN
    assert {k for k, _ in seen} == {"init_layer", "layer", "flops",
                                    "agg_calls"}
    assert {v for _, v in seen} == {0.5}
    assert sorted(os.listdir(os.path.join(ROOT, "portbench",
                                          "models"))) == before


def test_the_readers_count_a_planted_model(tmp_path, monkeypatch):
    """``step.mfu`` and ``kernels.agg_roofline`` count a traced record's
    batches by the model it names, with its settings."""
    _plant(tmp_path, monkeypatch, toy=TOY)
    sizes = counts.batch_sizes(BLOCKS, MASK, 2)
    k2 = counts.k2_bytes(4, 4, 3)
    rec = {"model": "toy", "model_args": {"scale": 1.0}, "feature_dim": 4,
           "hidden": 3, "n_classes": 2, "batches": [sizes, sizes],
           "window_s": 1.0,
           "device": {"by_class": {"agg": {"s": 1e-6, "launches": 2}}}}
    assert harness.load_reader("kernels.agg_roofline")(rec) == \
        pytest.approx(100.0 * 2 * k2 / counts.HBM_BYTES_S / 1e-6)
    assert harness.load_reader("step.mfu")(rec) == pytest.approx(
        100.0 * 2 * 3.0 * (14 + 24) / counts.F32_OPS_S)
    # a launch more in the trace than the model lists: nothing is read
    rec["device"]["by_class"]["agg"]["launches"] = 3
    assert harness.load_reader("kernels.agg_roofline")(rec) is None


def test_unknown_model_fails_loudly():
    with pytest.raises(KeyError, match="nope.py"):
        models.load("nope")
    with pytest.raises(KeyError, match="nope"):
        reference.init_params("nope", 0, 4, 3, 2)
    sizes = counts.batch_sizes(BLOCKS, MASK, 2)
    with pytest.raises(KeyError, match="nope"):
        counts.model_flops("nope", sizes, 4, 3, 2)
    with pytest.raises(KeyError, match="nope"):
        counts.agg_calls("nope", sizes, 4, 3)


@pytest.mark.parametrize("name", CELLS)
def test_every_configuration_has_its_model_file(name):
    model = harness.load_cell(name)["config"]["model"]
    mod = models.load(model)
    for fn in ("init_layer", "layer", "flops", "agg_calls"):
        assert callable(getattr(mod, fn)), (model, fn)


# --------------------------------------------------- the model's settings
def test_a_setting_in_traffic_and_model_args_is_refused(tiny_cell):
    cell = tiny_cell(CELLS[0])
    key = sorted(cell["traffic"]["trainer"])[0]
    cell["config"]["model_args"] = {key: cell["traffic"]["trainer"][key]}
    with pytest.raises(ValueError, match=key):
        harness.trainer_settings(cell)
    with pytest.raises(ValueError, match=key):
        harness.Setup(cell, 1, "cpu")


def test_model_args_reach_trainer_model_and_record(tiny_cell, tmp_path,
                                                   monkeypatch):
    """A traced CPU run of a tiny cell whose configuration carries a model
    setting: the trainer's config gets it beside the traffic's settings,
    the model's file gets it in the check and in the readers, and the
    traced record keeps it."""
    from repro_torch.gnn import train

    cell = tiny_cell(CELLS[0])
    model = cell["config"]["model"]
    real = os.path.join(models.DIR, f"{model}.py")
    # the real model's file, wrapped to keep what each function was given
    _plant(tmp_path, monkeypatch, **{model: textwrap.dedent(f'''
        import importlib.util
        _spec = importlib.util.spec_from_file_location("real", {real!r})
        _real = importlib.util.module_from_spec(_spec)
        _spec.loader.exec_module(_real)
        SEEN = []

        def init_layer(dense, i, d_in, hidden, width_tag):
            SEEN.append(("init_layer", width_tag))
            return _real.init_layer(dense, i, d_in, hidden)

        def layer(p, i, h, src, dst, n, mm, width_tag):
            SEEN.append(("layer", width_tag))
            return _real.layer(p, i, h, src, dst, n, mm)

        def flops(sizes, d_in, hidden, n_classes, width_tag):
            SEEN.append(("flops", width_tag))
            return _real.flops(sizes, d_in, hidden, n_classes)

        def agg_calls(sizes, d_in, hidden, width_tag):
            SEEN.append(("agg_calls", width_tag))
            return _real.agg_calls(sizes, d_in, hidden)
        ''')})
    configs = []
    real_config = train.TrainerConfig

    def config(**kw):
        configs.append(kw)
        return real_config(**{k: v for k, v in kw.items()
                              if k != "width_tag"})
    monkeypatch.setattr(train, "TrainerConfig", config)
    cell["config"]["model_args"] = {"width_tag": 7}
    res = harness.run_cell(cell, 2**31 + 5, 0.1, True, "cpu",
                           time.perf_counter())
    line = harness.result_line(cell, res, True, {})
    assert line["correct"], res["checks"]
    assert configs[0]["width_tag"] == 7
    assert set(cell["traffic"]["trainer"]) < set(configs[0])
    assert res["record"]["model_args"] == {"width_tag": 7}
    assert "step.mfu" in line["metrics"]
    seen = models.load(model).SEEN
    # the CPU's trace times no K2 or K3 launch, so ``kernels.agg_roofline``
    # stops before it counts them
    assert {k for k, _ in seen} == {"init_layer", "layer", "flops"}
    assert {v for _, v in seen} == {7}


# ------------------------------------------------- every kernel's time
def test_by_kernel_times_every_kernel():
    d = devtrace.reduce_events(EVENTS, SPANS)
    fill = ("at::native::vectorized_elementwise_kernel<4, "
            "at::native::FillFunctor<float>>")
    assert d["by_kernel"] == {
        fill: {"s": pytest.approx(1.5e-6), "launches": 2},
        "segment_rows_kernel<float, 4, 2, int>": {
            "s": pytest.approx(1e-6), "launches": 1},
        "sgemm_kernel": {"s": pytest.approx(0.5e-6), "launches": 1},
        "dedup_kernel<int>": {"s": pytest.approx(0.5e-6), "launches": 1}}
    # the classes and the top operations as they were
    assert d["by_class"] == {
        "k3_fill": {"s": 1000 * 1e-9, "launches": 1},
        "agg": {"s": 1000 * 1e-9, "launches": 1},
        "k1": {"s": 500 * 1e-9, "launches": 1}}
    top = [[fill, pytest.approx(1.5e-6)],
           ["segment_rows_kernel<float, 4, 2, int>", pytest.approx(1e-6)]]
    assert d["top_ops"][:2] == top
    assert {k for k, _ in d["top_ops"]} == set(d["by_kernel"])
    assert devtrace.reduce_events(EVENTS, SPANS, n_top=2)["top_ops"] == top
