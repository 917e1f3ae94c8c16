"""The port's out-of-core GNN training (``repro_torch.gnn.train``) against
the reference package's, on the CPU, from the same numpy inputs and the
same parameters (the reference's, carried over by ``params_from_numpy``).

What must be identical and what agrees within a tolerance:

  * AdamW, its schedule and its clipping: float32 arithmetic in the same
    order, within rtol 1e-5 (``pow``/``sqrt`` of two libraries);
  * one train step: loss, accuracy, every parameter gradient and
    dL/dfeats within rtol/atol 1e-5 — the aggregation sums in another
    order than XLA's scatter-add;
  * the trainer: sampled batches, gathered feature rows, cache and IO
    stats and ``virtual_s`` identical wherever the reference is
    deterministic (every mode at ``prefetch_depth=1``); per-batch losses
    within rtol 1e-4 over 20 batches (the last bits of each step's
    gradients carried through AdamW);
  * trainable embeddings: the store's rows after the epoch flush within
    atol 1e-4 of the reference's (sparse Adam divides each row's update by
    its own gradient scale, which lifts the last-bit differences), in
    ``helios-nopipe`` and ``helios`` at ``prefetch_depth=1`` under each
    write-leg knob (``WRITE_CASES``); at ``prefetch_depth=2`` no update is
    lost: each row ends at its start value plus the deltas that reached
    ``apply_delta``;
  * checkpoints: a trainer state saved by either package restores in the
    other to identical arrays.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import \
    CheckpointManager as RefCheckpoints  # noqa: E402
from repro.core.iostack import FeatureStore as RefStore  # noqa: E402
from repro.gnn import models as ref_models  # noqa: E402
from repro.gnn.graph import synth_graph as ref_graph  # noqa: E402
from repro.gnn.train import OutOfCoreGNNTrainer as RefTrainer  # noqa: E402
from repro.gnn.train import TrainerConfig as RefConfig  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.iostack import FeatureStore  # noqa: E402
from repro_torch.gnn import models  # noqa: E402
from repro_torch.gnn.graph import synth_graph  # noqa: E402
from repro_torch.gnn.sampling import NeighborSampler  # noqa: E402
from repro_torch.gnn.train import OutOfCoreGNNTrainer  # noqa: E402
from repro_torch.gnn.train import TrainerConfig  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from writeback_compare import (lost_update_errors,  # noqa: E402
                               prefetch_invariants, without_prefetch_timing)

N_V, ROW_DIM, HIDDEN, BATCH, FANOUTS, N_CLASSES = 2000, 16, 16, 32, (4, 3), 7
N_BATCHES = 20
TRAIN = dict(batch_size=BATCH, fanouts=FANOUTS, hidden=HIDDEN,
             presample_batches=2, chaos=None, seed=0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: leaf} of a dict/list tree of either package (JAX sorts dict
    keys when it flattens, a dict keeps its order: compare by path); a
    float32 torch leaf becomes numpy."""
    if isinstance(tree, dict):
        return {k: v for n, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{n}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}{i}/").items()}
    if isinstance(tree, torch.Tensor) and tree.dtype != torch.bfloat16:
        tree = tree.detach().numpy()
    return {prefix[:-1]: tree}


def _assert_trees_close(got, want, **tol):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k,
                                   **tol)


# ---------------------------------------------------------------------------
# train/optim.py
# ---------------------------------------------------------------------------

def _param_arrays(rng):
    """A GNN-shaped parameter tree (weights and biases) as numpy."""
    return {"layers": [{"w": rng.normal(size=(8, 5)).astype(np.float32),
                        "b": rng.normal(size=5).astype(np.float32)}],
            "head": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                     "b": np.zeros(3, np.float32)}}


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
def test_adamw_matches_reference(schedule):
    """20 AdamW updates from the same parameters and gradients.  The
    gradients' global norm is about 30, so every update is clipped to
    norm 1.0; weight decay 0.1 reaches the biases too."""
    rng = np.random.default_rng(0)
    p_np = _param_arrays(rng)
    if schedule == "constant":
        ref, port = ref_optim.adamw(1e-2), optim.adamw(1e-2)
    else:
        ref = ref_optim.adamw(ref_optim.warmup_cosine(1e-2, 5, 20))
        port = optim.adamw(optim.warmup_cosine(1e-2, 5, 20))
    rp = jax.tree.map(jnp.asarray, p_np)
    tp = models.params_from_numpy(p_np, "cpu")
    rs, ts = ref.init(rp), port.init(tp)
    for _ in range(20):
        g_np = jax.tree.map(lambda a: (8 * rng.normal(size=a.shape))
                            .astype(np.float32), p_np)
        assert float(ref_optim.global_norm(g_np)) > 10.0
        rp, rs = ref.update(jax.tree.map(jnp.asarray, g_np), rs, rp)
        tp, ts = port.update(models.params_from_numpy(g_np, "cpu"), ts, tp)
        _assert_trees_close([tp, ts["m"], ts["v"]], [rp, rs["m"], rs["v"]],
                            rtol=1e-5, atol=1e-7)
        assert int(ts["step"]) == int(rs["step"])
    assert ts["step"].dtype == torch.int32


def test_warmup_cosine_matches_reference():
    ref, port = (ref_optim.warmup_cosine(3e-3, 10, 100, floor=0.2),
                 optim.warmup_cosine(3e-3, 10, 100, floor=0.2))
    for step in (0, 1, 9, 10, 11, 50, 99, 100, 150):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        got = float(port(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6), step


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(1)
    tree = _param_arrays(rng)
    for scale, max_norm in ((1.0, 100.0), (30.0, 1.0)):
        t = jax.tree.map(lambda a: a * scale, tree)
        (rg, rn), (tg, tn) = (ref_optim.clip_by_global_norm(t, max_norm),
                              optim.clip_by_global_norm(
                                  models.params_from_numpy(t, "cpu"),
                                  max_norm))
        assert float(tn) == pytest.approx(float(rn), rel=1e-6)
        _assert_trees_close(tg, rg, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# gnn/models.py: gnn_loss and the train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graph_np():
    return synth_graph(N_V, 8, skew=1.1, seed=0)


def _minibatches(g, n=2):
    """Real sampler minibatches: the hop-2 block carries padded edges
    (``edge_mask`` False, positions 0) wherever the frontier is short."""
    s = NeighborSampler(g, FANOUTS, seed=4)
    rng = np.random.default_rng(2)
    out = [s.sample(rng.choice(N_V, BATCH, replace=False)) for _ in range(n)]
    assert all((~mb.blocks[-1].edge_mask).any() for mb in out)
    return out


@pytest.mark.parametrize("embedding_grads", [False, True])
@pytest.mark.parametrize("model", ["sage", "gcn"])
def test_train_step_matches_reference(graph_np, model, embedding_grads):
    """One train step on real minibatches: loss, accuracy and the
    gradients (``jax.value_and_grad`` of the reference's ``gnn_loss``
    against the port's autograd through K2/K3's backward rules), then the
    step's updated parameters and optimizer state."""
    params = ref_models.init_gnn_params(jax.random.key(1), model, ROW_DIM,
                                        HIDDEN, N_CLASSES)
    p_np = _np_tree(params)
    rng = np.random.default_rng(3)
    ref_opt, port_opt = ref_optim.adamw(1e-2), optim.adamw(1e-2)
    ref_step = ref_models.make_gnn_train_step(model, ref_opt, BATCH,
                                              embedding_grads)
    port_step = models.make_gnn_train_step(model, port_opt, BATCH,
                                           embedding_grads)
    tp = models.params_from_numpy(p_np, "cpu")
    rstate = {"params": params, "opt": ref_opt.init(params)}
    tstate = {"params": tp, "opt": port_opt.init(tp)}
    for mb in _minibatches(graph_np):
        feats = rng.normal(size=(len(mb.nodes), ROW_DIM)).astype(np.float32)
        labels = (mb.seeds % N_CLASSES).astype(np.int32)
        arrs = [tuple(getattr(b, k) for b in mb.blocks)
                for k in ("src_pos", "dst_pos", "edge_mask")]
        blocks = [tuple(jnp.asarray(a) for a in blk) for blk in zip(*arrs)]
        (loss, acc), (pg, fg) = jax.value_and_grad(
            lambda p, f: ref_models.gnn_loss(p, f, blocks,
                                             jnp.asarray(labels), BATCH,
                                             model),
            argnums=(0, 1), has_aux=True)(rstate["params"],
                                          jnp.asarray(feats))
        t_arrs = [tuple(torch.from_numpy(a) for a in k) for k in arrs]
        out = port_step(tstate, torch.from_numpy(feats), *t_arrs,
                        torch.from_numpy(labels))
        rout = ref_step(rstate, jnp.asarray(feats),
                        *[tuple(jnp.asarray(a) for a in k) for k in arrs],
                        jnp.asarray(labels))
        tstate, m = out[0], out[1]
        assert float(m["loss"]) == pytest.approx(float(loss), rel=1e-5)
        assert float(m["acc"]) == float(acc)
        if embedding_grads:
            assert out[2].shape == feats.shape
            np.testing.assert_allclose(out[2].numpy(), np.asarray(fg),
                                       rtol=1e-5, atol=1e-5)
            # the padding rows enter no loss: their gradient is zero
            assert not out[2][~torch.from_numpy(mb.node_mask)].any()
        # the step's gradients, through a fresh autograd of the port's loss
        p = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                         .requires_grad_(True), _np_tree(rstate["params"]))
        tl, _ = models.gnn_loss(p, torch.from_numpy(feats),
                                list(zip(*t_arrs)),
                                torch.from_numpy(labels), BATCH, model)
        tl.backward()
        _assert_trees_close(optim.tree_map(lambda t: t.grad, p), pg,
                            rtol=1e-5, atol=1e-5)
        rstate = rout[0]
        _assert_trees_close(tstate, rstate, rtol=1e-5, atol=1e-5)


def test_loss_is_the_reference_cross_entropy():
    """gnn_loss's head: float32 logsumexp minus the gold logit, averaged;
    accuracy by argmax (ties to the first class, as jnp.argmax)."""
    rng = np.random.default_rng(7)
    h = rng.normal(size=(6, 4)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    labels = np.array([0, 4, 2, 2, 1, 3], np.int32)
    logits = h @ w
    logits[1] = 1.0                                     # a tie
    lse = np.log(np.exp(logits.astype(np.float64)).sum(-1))
    want = float(np.mean(lse - logits[np.arange(6), labels]))
    t = torch.from_numpy(logits)
    loss = torch.logsumexp(t, -1) - torch.gather(
        t, -1, torch.from_numpy(labels)[:, None].long())[:, 0]
    assert float(loss.mean()) == pytest.approx(want, rel=1e-6)
    assert int(torch.argmax(t[1])) == int(jnp.argmax(jnp.asarray(logits[1])))


# ---------------------------------------------------------------------------
# gnn/train.py: the trainer, mode by mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs():
    return ref_graph(N_V, 8, skew=1.0, seed=0), synth_graph(N_V, 8, skew=1.0,
                                                            seed=0)


def _record(tr):
    """Wrap one trainer's sampler and gather to record what each batch
    sampled and gathered (instance attributes only; no package code
    changes)."""
    seen = {"nodes": [], "src": [], "rows": []}
    sample, complete = tr.sampler.sample, tr.cache.complete_planned

    def sample_rec(seeds):
        mb = sample(seeds)
        seen["nodes"].append(mb.nodes)
        seen["src"].append(np.concatenate([b.src_pos for b in mb.blocks]))
        return mb

    def complete_rec(pg):
        out = complete(pg)
        seen["rows"].append(np.array(out[:len(pg.ids)]))
        return out
    tr.sampler.sample, tr.cache.complete_planned = sample_rec, complete_rec
    return seen


def _run_pair(tmp_path, graphs, n_batches=N_BATCHES, writable=False,
              params=None, probe=None, **kw):
    """The reference's trainer and the port's (on the CPU, started from
    the reference's parameters) over identically seeded stores.  With a
    ``params`` dict, its "start", "ref" and "port" get the parameters
    both started from and each package's after training, as the port's
    tensors.  ``probe(trainer)``, where given, is called on each trainer
    before it trains."""
    rg, tg = graphs
    rs = RefStore(str(tmp_path / "ref"), N_V, ROW_DIM, n_shards=4,
                  create=True, rng_seed=3, writable=writable)
    ts = FeatureStore(str(tmp_path / "port"), N_V, ROW_DIM, n_shards=4,
                      create=True, rng_seed=3, writable=writable)
    with RefTrainer(rg, rs, RefConfig(**TRAIN, **kw)) as rt:
        P = _np_tree(rt.state["params"])
        rseen = _record(rt)
        if probe is not None:
            probe(rt)
        rout = rt.train(n_batches)
        rlog = list(rt.metrics_log)
        if params is not None:
            params["start"] = models.params_from_numpy(P, "cpu")
            params["ref"] = models.params_from_numpy(
                _np_tree(rt.state["params"]), "cpu")
    with OutOfCoreGNNTrainer(tg, ts, TrainerConfig(device="cpu", **TRAIN,
                                                   **kw)) as tr:
        p = models.params_from_numpy(P, "cpu")
        tr.state = {"params": p, "opt": tr.opt.init(p)}
        tseen = _record(tr)
        if probe is not None:
            probe(tr)
        tout = tr.train(n_batches)
        tlog = list(tr.metrics_log)
        if params is not None:
            params["port"] = tr.state["params"]
    return (rout, rlog, rseen, rs), (tout, tlog, tseen, ts)


@pytest.mark.parametrize("mode", ["helios-nopipe", "gids", "cpu", "helios",
                                  "helios-nocache"])
def test_trainer_matches_reference(tmp_path, graphs, mode):
    """20 batches in each mode (``prefetch_depth=1``, where every mode is
    deterministic): the same sampled batches and gathered rows, identical
    cache and IO stats (overlap and bubble shares included), per-operator
    virtual seconds and ``virtual_s``; losses within rtol 1e-4."""
    (rout, rlog, rseen, _), (tout, tlog, tseen, _) = _run_pair(
        tmp_path, graphs, mode=mode, prefetch_depth=1)
    assert len(tseen["nodes"]) == len(rseen["nodes"]) == N_BATCHES
    for k in ("nodes", "src", "rows"):
        for a, b in zip(rseen[k], tseen[k]):
            np.testing.assert_array_equal(a, b)
    assert tout["cache"] == rout["cache"]
    assert tout["io"] == rout["io"]
    assert tout["virtual_s"] == rout["virtual_s"]
    assert {k: (v["virtual_s"], v["calls"]) for k, v in
            tout["stages"].items()} == {k: (v["virtual_s"], v["calls"])
                                        for k, v in rout["stages"].items()}
    np.testing.assert_allclose([m["loss"] for m in tlog],
                               [m["loss"] for m in rlog], rtol=1e-4)
    assert tout["loss_first"] == tlog[0]["loss"]
    assert tout["loss_last"] == tlog[-1]["loss"]
    assert set(tout) == set(rout)


def _probe_loss(params, store, g, n=8):
    """The mean loss of ``n`` fixed minibatches (a sampler and seeds of
    their own, rows read from ``store``) under ``params``: a held-out
    measure of training that no thread order moves."""
    sampler = NeighborSampler(g, FANOUTS, seed=11)
    rng = np.random.default_rng(12)
    losses = []
    for _ in range(n):
        mb = sampler.sample(rng.choice(N_V, BATCH, replace=False))
        feats = np.zeros((len(mb.nodes), ROW_DIM), np.float32)
        real = int(mb.node_mask.sum())       # the real nodes come first
        feats[:real] = store.read_rows(mb.nodes[:real])
        blocks = [tuple(torch.from_numpy(np.asarray(getattr(b, k)))
                        for k in ("src_pos", "dst_pos", "edge_mask"))
                  for b in mb.blocks]
        with torch.no_grad():
            loss, _ = models.gnn_loss(
                params, torch.from_numpy(feats), blocks,
                torch.from_numpy(mb.labels.astype(np.int32)), BATCH, "sage")
        losses.append(float(loss))
    return float(np.mean(losses))


def test_trainer_deep_pipeline_depth_two(tmp_path, graphs):
    """``helios`` at ``prefetch_depth=2``: two batches share the sampler's
    rng and the parameter updates, so which samples and trains first
    follows the threads, in the reference too.  Compared: training lowers
    the loss, in both packages, every batch is counted once, the cache's
    tier counts add up to the rows the batches asked for and its storage
    misses are the IO engine's requests, and the hit rate is within 0.05
    of the reference's.

    Training lowers the loss: each package's trained parameters give a
    lower mean loss than the parameters both started from, on 8 fixed
    minibatches that no thread order touches.  The reference's own form,
    the mean of the last 3 training losses below the first 3, failed 1 of
    30 runs in each package under 6 other test processes: once the threads
    swap which batch draws from the shared rng every later sample differs,
    and 3 batches' means lie within their batch-to-batch spread."""
    params = {}
    (rout, rlog, _, _), (tout, tlog, tseen, ts) = _run_pair(
        tmp_path, graphs, mode="helios", prefetch_depth=2, params=params)
    for log in (tlog, rlog):
        losses = [m["loss"] for m in log]
        assert len(losses) == N_BATCHES and np.isfinite(losses).all()
    start = _probe_loss(params["start"], ts, graphs[1])
    for pkg in ("port", "ref"):
        assert _probe_loss(params[pkg], ts, graphs[1]) < start, pkg
    c = tout["cache"]
    assert c["device_hits"] + c["host_hits"] + c["storage_misses"] == sum(
        len(r) for r in tseen["rows"])
    assert c["storage_misses"] == tout["io"]["requests"]
    assert tout["stages"]["train"]["calls"] == N_BATCHES
    assert abs(c["hit_rate"] - rout["cache"]["hit_rate"]) < 0.05


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_trainable_embeddings_match_reference(tmp_path, graphs, opt):
    """Trainable embeddings in ``helios-nopipe`` with momentum 0.9, or
    with momentum 0.9 and sparse Adam (b2 0.99): the momentum/Adam tables'
    gathered rows come back from the port's cache as tensors and are
    turned into host numpy.  After the epoch flush the feature store (and
    the optimizer stores) hold the reference's rows within atol 1e-4;
    write-back, cache and IO stats and ``virtual_s`` are identical."""
    kw = dict(mode="helios-nopipe", train_embeddings=True,
              embedding_momentum=0.9,
              embedding_adam=0.99 if opt == "adam" else 0.0)
    (rout, rlog, _, rs), (tout, tlog, _, ts) = _run_pair(
        tmp_path, graphs, n_batches=12, writable=True, **kw)
    assert tout["writeback"] == rout["writeback"]
    assert tout["cache"] == rout["cache"] and tout["io"] == rout["io"]
    assert tout["virtual_s"] == rout["virtual_s"]
    np.testing.assert_allclose([m["loss"] for m in tlog],
                               [m["loss"] for m in rlog], rtol=1e-4)
    ids = np.arange(N_V)
    fresh = FeatureStore(str(tmp_path / "fresh"), N_V, ROW_DIM, n_shards=4,
                         create=True, rng_seed=3)
    assert np.abs(ts.read_rows(ids) - fresh.read_rows(ids)).max() > 1e-3
    suffixes = ["", "_momentum"] + (["_adam"] if opt == "adam" else [])
    for suffix in suffixes:
        a = RefStore(rs.path + suffix, N_V, ROW_DIM, n_shards=4)
        b = FeatureStore(ts.path + suffix, N_V, ROW_DIM, n_shards=4)
        np.testing.assert_allclose(b.read_rows(ids), a.read_rows(ids),
                                   atol=1e-4)


# the write leg's knobs, each a ``TrainerConfig`` knob of both packages,
# and the counter each case exists for (``_write_counters``): online
# placement refreshes every 2 batches at the default 5%/10% cache, so
# demotions evict dirty embedding rows (79 over 12 batches); a combiner of
# 32 rows takes the demotion batches smaller than that and releases a
# combined ticket (none at 16 or 96: the batches either bypass it or
# never fill it)
WRITE_CASES = {
    "writethrough": (dict(write_policy="writethrough"), "through_rows"),
    "combine": (dict(cache_policy="online", refresh_every=2,
                     write_combine_rows=32), "combined_tickets"),
    "flush_every": (dict(embedding_flush_every=3), "flush_barriers"),
    "online": (dict(cache_policy="online", refresh_every=2,
                    prefetch_rows=64), "dirty_demotions"),
}
EMBEDDINGS = dict(train_embeddings=True, embedding_momentum=0.9,
                  embedding_adam=0.99)


def _write_counters(counters):
    """A probe for ``_run_pair`` that counts, on each trainer's feature
    cache, the dirty rows its demotions flush and the combined tickets the
    write combiner releases (instance attributes only); one dict per
    trainer is appended to ``counters``."""
    def probe(tr):
        c = {"dirty_demotions": 0, "combined_tickets": 0}
        counters.append(c)
        demoted, submit = tr.cache._flush_demoted, tr.cache._write_back_submit

        def demoted_rec(ids):
            n, virt = demoted(ids)
            c["dirty_demotions"] += n
            return n, virt

        def submit_rec(ids, rows, tag):
            c["combined_tickets"] += tag == "flush-combine"
            return submit(ids, rows, tag)
        tr.cache._flush_demoted = demoted_rec
        tr.cache._write_back_submit = submit_rec
    return probe


def _store_rows(root, n_v, suffixes, Store):
    return [Store(root + sfx, n_v, ROW_DIM, n_shards=4).read_rows(
        np.arange(n_v)) for sfx in suffixes]


@pytest.mark.parametrize("case", list(WRITE_CASES))
@pytest.mark.parametrize("mode", ["helios-nopipe", "helios"])
def test_embedding_write_leg_matches_reference(tmp_path, graphs, mode,
                                               case):
    """Trainable embeddings (momentum 0.9, sparse Adam b2 0.99) through
    the deep pipeline's split-phase write-back (``helios``, one write
    ticket in flight across batches) and the serial one, at
    ``prefetch_depth=1``, under write-through, the write combiner, flush
    barriers every 3 batches, and online placement with prefetch whose
    refreshes demote dirty rows: write-back, cache and IO stats and
    ``virtual_s`` identical (in ``helios`` with prefetch, less what
    ``writeback_compare.PREFETCH_TIMED`` names, held by
    ``prefetch_invariants``), losses
    within rtol 1e-4, the feature, momentum and Adam stores within atol
    1e-4 after the epoch flush, and the counter the case exists for above
    0 in both packages alike."""
    knobs, counter = WRITE_CASES[case]
    counters = []
    (rout, rlog, _, rs), (tout, tlog, _, ts) = _run_pair(
        tmp_path, graphs, n_batches=12, writable=True, mode=mode,
        prefetch_depth=1, probe=_write_counters(counters), **EMBEDDINGS,
        **knobs)
    assert tout["writeback"] == rout["writeback"]
    if mode == "helios" and knobs.get("prefetch_rows"):
        for out in (rout, tout):
            prefetch_invariants(out)
        rout, tout = (without_prefetch_timing(o) for o in (rout, tout))
    assert tout["cache"] == rout["cache"] and tout["io"] == rout["io"]
    assert tout["virtual_s"] == rout["virtual_s"]
    np.testing.assert_allclose([m["loss"] for m in tlog],
                               [m["loss"] for m in rlog], rtol=1e-4)
    sfx = ("", "_momentum", "_adam")
    for a, b in zip(_store_rows(rs.path, N_V, sfx, RefStore),
                    _store_rows(ts.path, N_V, sfx, FeatureStore)):
        np.testing.assert_allclose(b, a, atol=1e-4)
    wb = tout["writeback"]
    counters[0].update(through_rows=rout["writeback"]["write_through_rows"],
                       flush_barriers=rout["writeback"]["flushes"] - 1)
    counters[1].update(through_rows=wb["write_through_rows"],
                       flush_barriers=wb["flushes"] - 1)
    assert counters[1] == counters[0]
    assert counters[1][counter] > 0, counters
    assert wb["dirty_after_flush"] == 0


# float32: a row's updates are added one at a time, each rounding to half
# an ulp of the row (|row| < 8 here: 2.4e-7), over at most 12 updates; the
# dropped delta in the control is far above it
LOST_UPDATE_ATOL = 1e-5


def test_embedding_no_lost_update_at_depth_two(tmp_path, graphs,
                                               monkeypatch):
    """``helios`` at the trainer's default ``prefetch_depth=2`` with every
    write-leg knob on: two batches share the sampler's rng and their
    updates interleave, so which rows each batch touches follows the
    threads, in the reference too.  Held instead, in both packages: every
    ``(ids, delta)`` that reached the feature cache's ``apply_delta`` is
    recorded, and after the epoch flush every row of the store equals its
    start value plus the sum of its recorded deltas within
    ``LOST_UPDATE_ATOL``; with the largest recorded delta dropped from
    the expectation the check fails."""
    rg, tg = graphs
    cfg = dict(TRAIN, mode="helios", prefetch_depth=2, **EMBEDDINGS,
               cache_policy="online", refresh_every=2, prefetch_rows=64,
               write_combine_rows=32, embedding_flush_every=3)
    for name, Store, Trainer, Config, g in (
            ("ref", RefStore, RefTrainer, RefConfig, rg),
            ("port", FeatureStore, OutOfCoreGNNTrainer, TrainerConfig, tg)):
        extra = {} if name == "ref" else {"device": "cpu"}
        store = Store(str(tmp_path / name), N_V, ROW_DIM, n_shards=4,
                      create=True, rng_seed=3, writable=True)
        start = store.read_rows(np.arange(N_V)).copy()
        records = []
        with Trainer(g, store, Config(**cfg, **extra)) as tr:
            apply_delta = tr.cache.apply_delta

            def rec(ids, delta, wait=True, apply_delta=apply_delta,
                    records=records):
                records.append((np.array(ids), np.array(
                    delta.cpu().numpy() if hasattr(delta, "cpu") else delta,
                    np.float32)))
                return apply_delta(ids, delta, wait=wait)
            monkeypatch.setattr(tr.cache, "apply_delta", rec)
            out = tr.train(N_BATCHES)
        assert out["writeback"]["dirty_after_flush"] == 0
        assert out["writeback"]["flushes"] > 1
        assert len(records) == N_BATCHES
        final = _store_rows(store.path, N_V, ("",), Store)[0]
        biggest = max(range(len(records)),
                      key=lambda k: np.abs(records[k][1]).max())
        err, control = lost_update_errors(start, final, records, biggest)
        assert err <= LOST_UPDATE_ATOL, (name, err)
        assert control > 100 * LOST_UPDATE_ATOL, (name, control)


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_embedding_table_apply_grads_matches_reference(tmp_path, opt):
    """``TrainableEmbeddingTable.apply_grads`` with momentum 0.9 (and
    sparse Adam, b2 0.99) over caches with device, host and storage rows:
    the port's caches' ``gather`` returns a tensor, which the table turns
    into host numpy.  After 6 steps on duplicated ids and a flush, the
    embedding, velocity and second-moment stores hold the reference's
    rows within atol 1e-6 (the same float32 updates; numpy sums
    duplicates the same way in both)."""
    from repro.core.hetero_cache import HeteroCache as RefCache
    from repro.gnn.train import TrainableEmbeddingTable as RefTable
    from repro_torch.core.hetero_cache import HeteroCache
    from repro_torch.gnn.train import TrainableEmbeddingTable
    n, d = 300, 8
    hot = np.arange(n, dtype=np.float64)[::-1].copy()
    b2 = 0.99 if opt == "adam" else 0.0

    def table(Store, Cache, Table, root, **dev):
        stores = [Store(str(tmp_path / f"{root}{sfx}"), n, d, n_shards=2,
                        create=True, rng_seed=4 if not sfx else None,
                        writable=True) for sfx in ("", "_m", "_v")]
        caches = [Cache(stores[0], hot, 20, 40, **dev)] + [
            Cache(st, hot, 0, 40, **dev) for st in stores[1:]]
        return stores, caches, Table(caches[0], 0.05, caches[1], 0.9,
                                     caches[2] if b2 else None, b2)
    rs, rc, rt = table(RefStore, RefCache, RefTable, "ref")
    ts, tc, tt = table(FeatureStore, HeteroCache, TrainableEmbeddingTable,
                       "port", device="cpu")
    rng = np.random.default_rng(8)
    for _ in range(6):
        ids = rng.integers(0, n, 64)
        grads = rng.normal(size=(64, d)).astype(np.float32)
        rt.apply_grads(ids, grads)
        tt.apply_grads(ids, grads)
    assert isinstance(tc[1].gather(np.arange(5)), torch.Tensor)
    everything = np.arange(n)
    for a, b, ca, cb in zip(rs, ts, rc, tc):
        ca.flush()
        cb.flush()
        np.testing.assert_allclose(b.read_rows(everything),
                                   a.read_rows(everything), atol=1e-6)
    assert np.abs(ts[1].read_rows(everything)).max() > 0
    for c in rc + tc:
        c.close()


# ---------------------------------------------------------------------------
# checkpoint/checkpoint.py: the trainer's restart state across packages
# ---------------------------------------------------------------------------

def _port_state():
    p = models.init_gnn_params(torch.Generator().manual_seed(0), "sage",
                               ROW_DIM, HIDDEN, N_CLASSES, device="cpu")
    opt = optim.adamw(1e-3)
    state = {"params": p, "opt": opt.init(p)}
    g = optim.tree_map(lambda t: torch.ones_like(t), p)
    new_p, new_opt = opt.update(g, state["opt"], p)
    return {"params": new_p, "opt": new_opt,
            "emb": torch.randn(5, 3, generator=torch.Generator()
                               .manual_seed(1)).to(torch.bfloat16)}


def test_checkpoint_port_state_restores_in_reference(tmp_path):
    state = _port_state()
    CheckpointManager(str(tmp_path), async_write=False).save(
        3, state, extra={"batch": 7})
    got, extra = RefCheckpoints(str(tmp_path)).restore()
    assert extra == {"batch": 7, "step": 3}
    flat_t, flat_r = _flat(state), _flat(got)
    assert flat_t.keys() == flat_r.keys()
    for k, t in flat_t.items():
        r = np.asarray(flat_r[k])
        if isinstance(t, torch.Tensor):                 # bfloat16
            assert str(r.dtype) == "bfloat16"
            np.testing.assert_array_equal(
                r.view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))
        else:
            assert r.dtype == t.dtype and r.shape == t.shape, k
            np.testing.assert_array_equal(r, t)


def test_checkpoint_reference_state_restores_in_port(tmp_path):
    params = ref_models.init_gnn_params(jax.random.key(0), "gcn", ROW_DIM,
                                        HIDDEN, N_CLASSES)
    opt = ref_optim.adamw(1e-3)
    st = opt.init(params)
    params, st = opt.update(jax.tree.map(jnp.ones_like, params), st, params)
    state = {"params": params, "opt": st,
             "emb": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)}
    RefCheckpoints(str(tmp_path), async_write=False).save(5, state)
    ck = CheckpointManager(str(tmp_path))
    assert ck.latest_step() == 5
    host, _ = ck.restore()
    dev, extra = ck.restore(device="cpu")
    assert extra == {"step": 5}
    want, host, dev_flat = _flat(_np_tree(state)), _flat(host), _flat(dev)
    assert want.keys() == host.keys() == dev_flat.keys()
    for k, w in want.items():
        h, d = host[k], dev_flat[k]
        if str(w.dtype) == "bfloat16":
            for t in (h, d):
                assert t.dtype == torch.bfloat16 and tuple(t.shape) == w.shape
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy().view(np.uint16),
                    w.view(np.uint16))
        else:
            assert isinstance(h, np.ndarray) and h.dtype == w.dtype, k
            assert d.dtype == w.dtype and d.shape == w.shape, k
            np.testing.assert_array_equal(h, w)
            np.testing.assert_array_equal(d, w)
    assert int(dev["opt"]["step"]) == 1 and dev["opt"]["step"].dtype == \
        torch.int32


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """``save`` copies the state to the host before it returns: an update
    in place after the call does not reach the checkpoint."""
    t = torch.zeros(4)
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, {"w": t})
    t += 1
    ck.wait()
    got, _ = ck.restore()
    np.testing.assert_array_equal(got["w"], np.zeros(4, np.float32))
