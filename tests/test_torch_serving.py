"""The port's ``GNNInferenceServer`` (``device="cpu"``) against the
reference package's, on the same graph, store and ``zipf_workload``, with
the reference's parameters carried over by ``params_from_numpy``.

Served/shed/batch counts, ``rows_fetched``, ``storage_rows_issued`` and
every request's virtual latency match exactly (the virtual clock is the
same code on the same inputs); per-request logits match within the GNN
tolerance (rtol/atol 1e-5)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.iostack import FeatureStore as RefStore  # noqa: E402
from repro.gnn.graph import synth_graph as ref_graph  # noqa: E402
from repro.serving import GNNInferenceServer as RefServer  # noqa: E402
from repro.serving import ServerConfig as RefConfig  # noqa: E402
from repro.serving import zipf_workload as ref_workload  # noqa: E402
from repro_torch.core.iostack import FeatureStore  # noqa: E402
from repro_torch.gnn.graph import synth_graph  # noqa: E402
from repro_torch.gnn.models import params_from_numpy  # noqa: E402
from repro_torch.serving import (GNNInferenceServer,  # noqa: E402
                                 ServerConfig, zipf_workload)

N_V, ROW_DIM = 2000, 32


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve_parity"))
    kw = dict(n_rows=N_V, row_dim=ROW_DIM, n_shards=4, create=True,
              rng_seed=1)
    rg, tg = (ref_graph(N_V, 8, skew=1.2, seed=0),
              synth_graph(N_V, 8, skew=1.2, seed=0))
    wl = ref_workload(N_V, 16, 8, rate_rps=60_000, degrees=rg.degrees(),
                      seed=1)
    twl = zipf_workload(N_V, 16, 8, rate_rps=60_000, degrees=tg.degrees(),
                        seed=1)
    for (s, t, k), (s2, t2, k2) in zip(wl, twl):
        np.testing.assert_array_equal(s, s2)
        assert (t, k.name) == (t2, k2.name)
    return (rg, RefStore(os.path.join(root, "ref"), **kw), tg,
            FeatureStore(os.path.join(root, "port"), **kw), wl, twl)


def _serve(server, workload):
    futs = [server.submit(s, k, t) for s, t, k in workload]
    stats = server.flush()
    return stats, [f.result() for f in futs]


@pytest.mark.parametrize("mode,model,dedup", [
    ("helios", "sage", True), ("helios", "gcn", True),
    ("helios", "sage", False), ("gids", "sage", True), ("cpu", "gcn", True)])
def test_server_matches_reference(world, mode, model, dedup):
    rg, rstore, tg, tstore, wl, twl = world
    kw = dict(model=model, mode=mode, dedup=dedup, request_batch_size=8,
              fanouts=(4, 3), hidden=16, device_cache_frac=0.05,
              host_cache_frac=0.1, max_batch_requests=4, seed=0, chaos=None)
    with RefServer(rg, rstore, RefConfig(**kw)) as ref:
        sa, ra = _serve(ref, wl)
        params = jax.tree.map(np.asarray, ref.params)
    with GNNInferenceServer(tg, tstore, ServerConfig(device="cpu", **kw),
                            params=params_from_numpy(params, "cpu")) as srv:
        sb, rb = _serve(srv, twl)
        assert srv.cache.device_tier.device.type == "cpu"
    assert (sb.served, sb.rejected_total, sb.batches) == \
        (sa.served, sa.rejected_total, sa.batches)
    assert sb.rows_fetched == sa.rows_fetched
    assert sb.storage_rows_issued == sa.storage_rows_issued
    assert sb.storage_rows_naive == sa.storage_rows_naive
    assert sa.served > 0
    for a, b in zip(ra, rb):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert b["latency_v"] == a["latency_v"] and b["klass"] == a["klass"]
        assert isinstance(b["logits"], np.ndarray)
        np.testing.assert_allclose(b["logits"], np.asarray(a["logits"]),
                                   rtol=1e-5, atol=1e-5)


def test_port_server_own_params(world):
    """Without reference params the port draws its own from a seeded
    ``torch.Generator``: two servers with one seed agree exactly."""
    _, _, tg, tstore, _, twl = world
    cfg = ServerConfig(device="cpu", request_batch_size=8, fanouts=(4, 3),
                       hidden=16, max_batch_requests=4, chaos=None)
    outs = []
    for _ in range(2):
        with GNNInferenceServer(tg, tstore, cfg) as srv:
            outs.append(_serve(srv, twl[:6])[1])
    for a, b in zip(*outs):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a["logits"], b["logits"])
