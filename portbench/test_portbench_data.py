"""The benchmark's frozen generators against the program's, at a tiny size."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import data


@pytest.mark.parametrize("n,deg,skew,seed", [(500, 4, 0.9, 3),
                                             (1200, 14, 0.8, 2**31 + 9)])
def test_graph_is_the_programs(n, deg, skew, seed):
    from repro_torch.gnn.graph import synth_graph
    rowptr, col = data.synth_graph(n, deg, skew, seed)
    g = synth_graph(n, deg, skew, seed)
    assert np.array_equal(rowptr, g.rowptr)
    assert np.array_equal(col, g.col)
    assert np.array_equal(data.labels_of(np.arange(n), 47), g.labels)


@pytest.mark.parametrize("n,k", [(10_000, 64), (100, 40)])
def test_seed_draw_is_the_programs(n, k):
    from repro_torch.core.rng import draw_unique
    for i in range(3):
        a = data.draw_unique(np.random.default_rng([5, 0x5EED, i]), n, k)
        b = draw_unique(np.random.default_rng([5, 0x5EED, i]), n, k)
        assert np.array_equal(a, b)


def test_trainer_draws_the_benchmarks_seeds():
    """The seeds of the trainer's batches, in a pipeline one batch deep,
    are ``data.batch_seeds`` of their index."""
    from repro_torch.gnn.graph import CSRGraph
    from repro_torch.gnn.train import OutOfCoreGNNTrainer, TrainerConfig
    from repro_torch.core.iostack import FeatureStore
    import tempfile
    n, seed = 800, 2**31 + 11
    rowptr, col = data.synth_graph(n, 4, 0.9, 1)
    with tempfile.TemporaryDirectory() as d:
        data.write_store(d, data.feature_rows(n, 8, 2, "cpu"), 3)
        store = FeatureStore(d, n, 8, n_shards=3)
        cfg = TrainerConfig(hidden=8, batch_size=16, fanouts=(3, 2),
                            prefetch_depth=1, chaos=None, seed=seed,
                            device="cpu")
        with OutOfCoreGNNTrainer(CSRGraph(rowptr, col), store, cfg) as tr:
            seen = []
            inner = tr.sampler.sample
            tr.sampler.sample = lambda s: seen.append(s.copy()) or inner(s)
            tr.train(3)
    for i, s in enumerate(seen):
        assert np.array_equal(s, data.batch_seeds(seed, i, n, 16))


def test_store_opens_in_the_program_with_the_rows_in_place(tmp_path):
    from repro_torch.core.iostack import FeatureStore
    n, dim, shards = 101, 6, 4
    rows = data.feature_rows(n, dim, 7, "cpu")
    data.write_store(str(tmp_path), rows, shards)
    store = FeatureStore(str(tmp_path), n, dim, n_shards=shards)
    ids = np.array([0, 3, 4, 100, 57, 57])
    assert np.array_equal(store.read_rows(ids), rows[ids].numpy())


def test_rows_repeat_for_a_seed_and_differ_across_seeds():
    a = data.feature_rows(70_000, 3, 5, "cpu")
    b = data.feature_rows(70_000, 3, 5, "cpu")
    c = data.feature_rows(70_000, 3, 6, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert data.sub_seed(2**31 + 1, 1) != data.sub_seed(2**31 + 1, 2)
