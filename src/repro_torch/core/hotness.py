"""Pre-sampling hotness *measurement* (paper §3.2.2, after Legion/GNNLab).

Before training starts, run one epoch of the *actual* access pattern
(neighbor sampling for GNNs; router statistics for MoE; token frequencies
for embeddings) and count per-row accesses.  The resulting counts seed a
``core.policy`` cache policy; placement itself (rank by score, hottest to
the device tier) lives in ``core.policy.placement`` and is re-exported
here for compatibility.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.policy import placement  # noqa: F401  (compat re-export)
from repro_torch.core.rng import draw_unique


def presample_gnn(sampler, seeds_per_batch: int, n_batches: int,
                  n_rows: int, seed: int = 0) -> np.ndarray:
    """One pre-sampling epoch: counts vertex accesses under the sampler."""
    # decorrelated stream: with plain default_rng(seed) the draws below are
    # bit-identical to the trainer's own batch seeds (same seed, same
    # choice() call), handing placement oracle knowledge of the first
    # training batches and inflating measured hit rates
    rng = np.random.default_rng([seed, 0x9E3779B9])
    counts = np.zeros(n_rows, np.int64)
    for _ in range(n_batches):
        # unique seeds, matching the trainer's draw and the sampler's
        # documented without-replacement contract; bounded-cost draw so the
        # presample epoch stays O(batch) at terabyte-scale vertex counts
        seeds = draw_unique(rng, n_rows, min(seeds_per_batch, n_rows))
        batch = sampler.sample(seeds)
        ids, c = np.unique(batch.all_nodes, return_counts=True)
        np.add.at(counts, ids, c)
    return counts


def token_hotness(token_stream: np.ndarray, vocab: int) -> np.ndarray:
    """Token-frequency hotness for out-of-core embedding tables."""
    return np.bincount(token_stream.reshape(-1), minlength=vocab).astype(np.int64)


def expert_hotness(routing_counts: np.ndarray) -> np.ndarray:
    """Per-expert hotness from router statistics (MoE expert streaming)."""
    return routing_counts.astype(np.int64)


