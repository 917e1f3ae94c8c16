"""The port's GNN (sampler + GraphSAGE/GCN forward on K2/K3) against the
reference package's, on the same real ``NeighborSampler`` minibatches and
the same parameters (the reference's, carried over by
``params_from_numpy``).  Logits agree within rtol/atol 1e-5 in float32 on
the CPU: the aggregation sums in another order than XLA's scatter-add."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.gnn.graph import synth_graph as ref_graph  # noqa: E402
from repro.gnn.models import init_gnn_params  # noqa: E402
from repro.gnn.models import make_gnn_infer_step as ref_step  # noqa: E402
from repro.gnn.sampling import NeighborSampler as RefSampler  # noqa: E402
from repro_torch.gnn.graph import synth_graph  # noqa: E402
from repro_torch.gnn.models import (gnn_forward,  # noqa: E402
                                    init_gnn_params as port_init,
                                    make_gnn_infer_step, make_gnn_train_step,
                                    params_from_numpy)
from repro_torch.gnn.sampling import NeighborSampler  # noqa: E402
from repro_torch.train.optim import adamw  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

N_V, ROW_DIM, HIDDEN, BATCH, FANOUTS = 2000, 32, 16, 16, (4, 3)


@pytest.fixture(scope="module")
def graphs():
    return ref_graph(N_V, 8, skew=1.1, seed=0), synth_graph(N_V, 8, skew=1.1,
                                                            seed=0)


def _batches(graphs, n=3):
    """Same-seed minibatches from both samplers, asserted identical."""
    rg, tg = graphs
    np.testing.assert_array_equal(rg.rowptr, tg.rowptr)
    np.testing.assert_array_equal(rg.col, tg.col)
    rs, ts = RefSampler(rg, FANOUTS, seed=5), NeighborSampler(tg, FANOUTS,
                                                              seed=5)
    rng = np.random.default_rng(9)
    out = []
    for _ in range(n):
        seeds = rng.choice(N_V, BATCH, replace=False)
        a, b = rs.sample(seeds), ts.sample(seeds)
        np.testing.assert_array_equal(a.nodes, b.nodes)
        np.testing.assert_array_equal(a.node_mask, b.node_mask)
        for ba, bb in zip(a.blocks, b.blocks):
            np.testing.assert_array_equal(ba.src_pos, bb.src_pos)
            np.testing.assert_array_equal(ba.dst_pos, bb.dst_pos)
            np.testing.assert_array_equal(ba.edge_mask, bb.edge_mask)
            assert ba.n_dst == bb.n_dst
        out.append(b)
    return out


def _port_blocks(mb):
    return tuple(tuple(torch.from_numpy(getattr(b, k)) for b in mb.blocks)
                 for k in ("src_pos", "dst_pos", "edge_mask"))


@pytest.mark.parametrize("model", ["sage", "gcn"])
def test_infer_step_matches_reference(graphs, model):
    params = init_gnn_params(jax.random.key(3), model, ROW_DIM, HIDDEN, 7)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rstep = ref_step(model, BATCH)
    tstep = make_gnn_infer_step(model, BATCH)
    rng = np.random.default_rng(1)
    for mb in _batches(graphs):
        feats = rng.normal(size=(len(mb.nodes), ROW_DIM)).astype(np.float32)
        want = rstep(params, feats,
                     *[tuple(getattr(b, k) for b in mb.blocks)
                       for k in ("src_pos", "dst_pos", "edge_mask")])
        got = tstep(tparams, torch.from_numpy(feats), *_port_blocks(mb))
        assert got.dtype == torch.float32 and got.shape == (BATCH, 7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_forward_hidden_matches_reference(graphs):
    """All N_pad rows of the last hidden layer, not only the seeds."""
    from repro.gnn.models import gnn_forward as ref_forward
    params = init_gnn_params(jax.random.key(4), "sage", ROW_DIM, HIDDEN, 5)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    mb = _batches(graphs, 1)[0]
    feats = np.random.default_rng(2).normal(
        size=(len(mb.nodes), ROW_DIM)).astype(np.float32)
    want = ref_forward(params, feats, [(b.src_pos, b.dst_pos, b.edge_mask)
                                       for b in mb.blocks], "sage")
    src, dst, em = _port_blocks(mb)
    got = gnn_forward(tparams, torch.from_numpy(feats),
                      list(zip(src, dst, em)), "sage")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("model", ["sage", "gcn"])
def test_port_init_layout(model):
    """The port's own init has the reference's tree layout and shapes."""
    ref = init_gnn_params(jax.random.key(0), model, ROW_DIM, HIDDEN, 7)
    got = port_init(torch.Generator().manual_seed(0), model, ROW_DIM, HIDDEN,
                    7, device="cpu")
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got))
    assert [(p, x.shape) for p, x in flat_ref] == \
        [(p, x.shape) for p, x in flat_got]
    w = got["layers"][0]["w_self" if model == "sage" else "w"]
    assert 0.5 < float(w.std()) * np.sqrt(ROW_DIM) < 1.5


class _Products(TorchDispatchMode):
    """Records every dense product, forward and backward, as ``(layer,
    rows)``: the layer told apart by its weight's shape, the rows by the
    one dimension that is no width.  A product reaches the mode as
    ``aten.mm`` under autograd, as ``aten.matmul`` in inference mode."""

    PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.matmul.default)

    def __init__(self, weights: dict):
        super().__init__()
        self.weights, self.seen = weights, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.PRODUCTS:
            shapes = {tuple(t.shape) for t in (args[0], args[1], out)}
            layer, = {name for name, wshape in self.weights.items()
                      if shapes & {wshape, wshape[::-1]}}
            rows, = {d for t in args[:2] for d in t.shape
                     if d not in {d for w in self.weights.values()
                                  for d in w}}
            self.seen.append((layer, rows))
        return out


@pytest.mark.parametrize("path", ["train", "infer", "forward"])
@pytest.mark.parametrize("model", ["sage", "gcn"])
def test_last_layer_products_run_on_the_rows_read(graphs, model, path):
    """The train and infer steps read only the seeds' rows of the last
    layer, so its products (forward and, in training, both gradients) run
    on ``BATCH`` rows; the first layer's, and ``gnn_forward``'s without
    ``n_out``, on all N_pad."""
    hidden, n_classes = 24, 7            # every width apart from BATCH
    weights = {"layer0": (ROW_DIM, hidden), "layer1": (hidden, hidden),
               "head": (hidden, n_classes)}
    params = port_init(torch.Generator().manual_seed(0), model, ROW_DIM,
                       hidden, n_classes, device="cpu")
    mb = _batches(graphs, 1)[0]
    n_pad = len(mb.nodes)
    feats = torch.randn(n_pad, ROW_DIM, generator=torch.Generator()
                        .manual_seed(1))
    src, dst, em = _port_blocks(mb)
    with _Products(weights) as spy:
        if path == "train":
            opt = adamw(1e-2)
            make_gnn_train_step(model, opt, BATCH)(
                {"params": params, "opt": opt.init(params)}, feats, src,
                dst, em, torch.from_numpy(mb.seeds % n_classes))
        elif path == "infer":
            make_gnn_infer_step(model, BATCH)(params, feats, src, dst, em)
        else:
            gnn_forward(params, feats, list(zip(src, dst, em)), model)
    per_layer = {"sage": 2, "gcn": 1}[model]    # products a layer, forward
    last = BATCH if path != "forward" else n_pad
    # forward, then (training) the weights' and the inputs' gradients;
    # the first layer's inputs (the gathered rows) take none
    want = {"layer0": [n_pad] * per_layer * (2 if path == "train" else 1),
            "layer1": [last] * per_layer * (3 if path == "train" else 1),
            "head": [BATCH] * {"train": 3, "infer": 1, "forward": 0}[path]}
    got = {name: sorted(r for n, r in spy.seen if n == name)
           for name in weights}
    assert got == want, spy.seen
