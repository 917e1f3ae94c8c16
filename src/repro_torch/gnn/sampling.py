"""Fanout neighbor sampling over CSR topology (paper: 2-hop, fanouts 25/10).

Sampling runs on the host against the CPU-tier topology (the paper's
neighbor-sampling operator); output blocks are padded to static shapes so
the device-side training step is jit-stable across batches.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.rng import draw_unique  # noqa: F401  (seed-draw re-export)
from repro_torch.gnn.graph import CSRGraph


@dataclass
class Block:
    """One message-passing block: edges src_pos -> dst_pos into ``nodes``."""
    src_pos: np.ndarray        # (E_pad,) int32 indices into the node array
    dst_pos: np.ndarray        # (E_pad,) int32
    edge_mask: np.ndarray      # (E_pad,) bool
    n_dst: int                 # number of destination nodes (prefix of nodes)


@dataclass
class MiniBatch:
    nodes: np.ndarray          # (N_pad,) global vertex ids (unique, seeds first)
    node_mask: np.ndarray      # (N_pad,) bool
    blocks: list               # outer-to-inner hop blocks
    seeds: np.ndarray          # (B,) global ids
    labels: np.ndarray         # (B,)

    @property
    def all_nodes(self) -> np.ndarray:
        return self.nodes[self.node_mask]


class NeighborSampler:
    def __init__(self, graph: CSRGraph, fanouts=(25, 10), seed: int = 0):
        self.g = graph
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, vertices: np.ndarray, fanout: int):
        """With-replacement fanout sampling; isolated vertices self-loop."""
        g = self.g
        deg = g.rowptr[vertices + 1] - g.rowptr[vertices]
        r = self.rng.integers(0, np.maximum(deg, 1)[:, None],
                              (len(vertices), fanout))
        idx = g.rowptr[vertices][:, None] + r
        nbr = g.col[np.minimum(idx, len(g.col) - 1)]
        nbr = np.where(deg[:, None] > 0, nbr, vertices[:, None])
        return nbr                      # (V, fanout)

    def sample(self, seeds: np.ndarray) -> MiniBatch:
        """Layered sampling; returns blocks outer-hop-first for aggregation
        inner->outer (GraphSAGE computes hop-(k) from hop-(k+1) frontier).
        ``seeds`` must be unique (sampled without replacement)."""
        seeds = seeds.astype(np.int64)
        frontier = seeds
        hop_edges = []
        for fanout in self.fanouts:
            nbr = self._sample_neighbors(frontier, fanout)     # (V,f)
            dst = np.repeat(frontier, fanout)
            src = nbr.reshape(-1)
            hop_edges.append((src, dst))
            frontier = np.unique(src)

        # node array: seeds first, then every other touched vertex
        touched = np.unique(np.concatenate([seeds] + [s for s, _ in hop_edges]))
        rest = np.setdiff1d(touched, seeds, assume_unique=False)
        nodes_arr = np.concatenate([seeds, rest])
        order = np.argsort(nodes_arr, kind="stable")
        sorted_nodes = nodes_arr[order]

        def pos_of(x):
            return order[np.searchsorted(sorted_nodes, x)].astype(np.int32)

        n_pad = self._node_pad(len(seeds))
        node_mask = np.zeros(n_pad, bool)
        node_mask[:len(nodes_arr)] = True
        nodes_out = np.zeros(n_pad, np.int64)
        nodes_out[:len(nodes_arr)] = nodes_arr

        blocks = []
        for h, (src, dst) in enumerate(hop_edges):
            e_pad = self._edge_pad(len(seeds), h)
            sp = np.zeros(e_pad, np.int32)
            dp = np.zeros(e_pad, np.int32)
            em = np.zeros(e_pad, bool)
            k = len(src)
            sp[:k] = pos_of(src)
            dp[:k] = pos_of(dst)
            em[:k] = True
            blocks.append(Block(sp, dp, em, len(dst)))
        return MiniBatch(nodes_out, node_mask, blocks, seeds,
                         self.g.labels[seeds])

    def _node_pad(self, batch: int) -> int:
        n = batch
        total = batch
        for f in self.fanouts:
            n = n * f
            total += n
        return total

    def _edge_pad(self, batch: int, hop: int) -> int:
        e = batch
        for f in self.fanouts[:hop + 1]:
            e *= f
        return e
