"""Graph container + synthetic terabyte-class dataset generation.

CSR topology lives in host memory (the paper stores all topology in the CPU
cache tier — Table 1 topology sizes fit 768 GB DRAM); features live on the
storage tier (``core.iostack.FeatureStore``).

The paper's five datasets are registered with their *real* sizes; synthetic
instances are generated at a configurable ``scale`` with a Zipf-like degree
distribution so cache-skew behaviour matches (CL: caching 10% of rows
removes ~70% of storage traffic — reproduced by the skew parameter).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from repro_torch.core.iostack import FeatureStore


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_vertices: int
    n_edges: int
    feature_dim: int
    topology_gb: float
    feature_tb: float
    skew: float = 1.0          # Zipf exponent for degree/access skew


# paper Table 1
DATASETS = {
    "PA": DatasetSpec("PA", 111_000_000, 1_600_000_000, 128, 14, 0.056, 0.8),
    "IG": DatasetSpec("IG", 269_000_000, 4_000_000_000, 1024, 34, 1.1, 0.9),
    "UK": DatasetSpec("UK", 790_000_000, 47_200_000_000, 1024, 384, 3.2, 1.1),
    "CL": DatasetSpec("CL", 1_000_000_000, 42_500_000_000, 1024, 348, 4.1, 1.2),
    "LD": DatasetSpec("LD", 5_600_000_000, 10_000_000_000, 1024, 125, 23.0, 0.9),
}


class CSRGraph:
    """In-memory CSR topology (the host/CPU tier of the paper)."""

    def __init__(self, rowptr: np.ndarray, col: np.ndarray,
                 labels: np.ndarray | None = None, n_classes: int = 47):
        self.rowptr = rowptr
        self.col = col
        self.n_vertices = len(rowptr) - 1
        self.n_edges = len(col)
        self.n_classes = n_classes
        self.labels = (labels if labels is not None
                       else np.arange(self.n_vertices) % n_classes)

    def degrees(self) -> np.ndarray:
        return np.diff(self.rowptr)


def synth_graph(n_vertices: int, avg_degree: int, skew: float = 1.0,
                seed: int = 0, n_classes: int = 47) -> CSRGraph:
    """Power-law graph: vertex v's popularity ~ (v+1)^-skew (pre-shuffled)."""
    rng = np.random.default_rng(seed)
    n_edges = n_vertices * avg_degree
    # degree assignment ~ Zipf over a random permutation of vertices
    ranks = rng.permutation(n_vertices)
    pop = (ranks + 1.0) ** (-skew)
    pop /= pop.sum()
    deg = rng.multinomial(n_edges, pop)
    rowptr = np.zeros(n_vertices + 1, np.int64)
    np.cumsum(deg, out=rowptr[1:])
    # endpoints also drawn from the popularity distribution (skewed access)
    col = rng.choice(n_vertices, size=n_edges, p=pop).astype(np.int64)
    return CSRGraph(rowptr, col, n_classes=n_classes)


def make_dataset(name: str, root: str, scale: float = 1e-5,
                 n_shards: int = 12, seed: int = 0):
    """Scaled synthetic instance of a paper dataset.

    Returns (CSRGraph, FeatureStore, DatasetSpec).  ``scale`` shrinks vertex
    count (features keep the real per-row dimension so IO granularity
    matches the paper's SSD-access-size experiments).
    """
    spec = DATASETS[name]
    n_v = max(1024, int(spec.n_vertices * scale))
    avg_deg = max(2, int(spec.n_edges / spec.n_vertices))
    g = synth_graph(n_v, avg_deg, spec.skew, seed)
    store = FeatureStore(os.path.join(root, f"{name.lower()}_features"),
                         n_rows=n_v, row_dim=spec.feature_dim,
                         dtype=np.float32, n_shards=n_shards, create=True,
                         rng_seed=seed)
    return g, store, spec
