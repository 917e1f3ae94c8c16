"""The benchmark's inputs, made from the run's seed: the graph, the feature
rows and the store they are written to, and the trainer's seed draw.

These are frozen copies, kept here so that a later change to the program
cannot change what the benchmark feeds it:

- ``synth_graph`` is ``repro_torch.gnn.graph.synth_graph`` (a Zipf
  power-law graph over a random permutation of the vertices);
- ``draw_unique`` is ``repro_torch.core.rng.draw_unique``, which the
  trainer calls with ``default_rng([seed, 0x5EED, batch_index])``;
- ``write_store`` writes the files ``repro_torch.core.iostack.FeatureStore``
  opens (``round-robin.v1``: row ``i`` on shard ``i % n_shards`` at offset
  ``i // n_shards``, each shard a ``.npy`` file named ``shard_<s>.bin``).

The rows are standard normal float32, drawn by ``torch.randn`` from one
generator on the device the run uses, in blocks of ``ROW_BLOCK`` rows.
The store's own numpy generator draws float64 normals on the host one
shard at a time, several seconds of set-up a run at the benchmark's
sizes; ``feature_rows`` gives the same rows again to the reference.
"""
from __future__ import annotations

import os

import numpy as np
import torch

LAYOUT = "round-robin.v1"
ROW_BLOCK = 1 << 16
TRAINER_SEED_TAG = 0x5EED          # repro_torch.gnn.train.train's make_ctx


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one input, derived from the run's seed and a tag."""
    return int(np.random.SeedSequence([seed, tag]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def synth_graph(n_vertices: int, avg_degree: int, skew: float, seed: int):
    """(rowptr, col) of the power-law graph; a copy of the program's
    ``synth_graph``, which returns them in a ``CSRGraph``."""
    rng = np.random.default_rng(seed)
    n_edges = n_vertices * avg_degree
    ranks = rng.permutation(n_vertices)
    pop = (ranks + 1.0) ** (-skew)
    pop /= pop.sum()
    deg = rng.multinomial(n_edges, pop)
    rowptr = np.zeros(n_vertices + 1, np.int64)
    np.cumsum(deg, out=rowptr[1:])
    col = rng.choice(n_vertices, size=n_edges, p=pop).astype(np.int64)
    return rowptr, col


def labels_of(ids: np.ndarray, n_classes: int) -> np.ndarray:
    """The class of each vertex: its id modulo the class count, as the
    program's ``CSRGraph`` sets it when given no labels."""
    return np.asarray(ids) % n_classes


def draw_unique(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """``k`` distinct ids of ``range(n)``; a copy of the program's."""
    if k > n:
        raise ValueError(f"cannot draw {k} unique ids from range({n})")
    if 4 * k >= n:
        return rng.choice(n, size=k, replace=False)
    got = np.unique(rng.integers(0, n, size=2 * k))
    while len(got) < k:
        got = np.union1d(got, rng.integers(0, n, size=2 * k))
    return rng.permutation(got)[:k]


def batch_seeds(seed: int, batch_index: int, n_vertices: int,
                batch_size: int) -> np.ndarray:
    """The seed vertices the trainer draws for ``batch_index``."""
    rng = np.random.default_rng([seed, TRAINER_SEED_TAG, batch_index])
    return draw_unique(rng, n_vertices, batch_size)


def feature_rows(n_rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """All ``n_rows`` feature rows, (n_rows, dim) float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n_rows, dim), dtype=torch.float32, device=device)
    for a in range(0, n_rows, ROW_BLOCK):
        b = min(n_rows, a + ROW_BLOCK)
        out[a:b] = torch.randn((b - a, dim), generator=gen,
                               dtype=torch.float32, device=device)
    return out


def layout_tag(n_rows: int, dim: int, n_shards: int) -> str:
    return (f"{LAYOUT}/nshards={n_shards}/nrows={n_rows}/rowdim={dim}"
            f"/dtype=float32")


def write_store(path: str, rows: torch.Tensor, n_shards: int) -> None:
    """Write ``rows`` as a float32 feature store of ``n_shards`` shards,
    synced to disk so that no write-back of its pages runs in the window
    (its pages stay in the page cache, where the program reads them)."""
    os.makedirs(path, exist_ok=True)
    n_rows, dim = rows.shape
    for s in range(n_shards):
        shard = np.ascontiguousarray(rows[s::n_shards].cpu().numpy())
        with open(os.path.join(path, f"shard_{s}.bin"), "wb") as fh:
            np.lib.format.write_array(fh, shard, allow_pickle=False)
            fh.flush()
            os.fsync(fh.fileno())
    with open(os.path.join(path, "LAYOUT"), "w") as fh:
        fh.write(layout_tag(n_rows, dim, n_shards) + "\n")
