"""RNG utilities shared across the core and workload layers."""
from __future__ import annotations

import numpy as np


def draw_unique(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """Uniform without-replacement draw of ``k`` ids from ``range(n)`` in
    O(k) expected time.

    ``rng.choice(n, k, replace=False)`` materialises O(n) state per call —
    pathological when ``n`` is a terabyte-scale vertex count and ``k`` a
    mini-batch.  For sparse draws (k << n) rejection sampling is used: the
    distinct values of iid uniform draws form, by symmetry, a uniform
    subset of their size, and a random ``k`` of those is a uniform
    ``k``-subset.  Expected cost is O(k); the dense regime (k within 4x of
    n) falls back to the exact permutation draw where O(n) is optimal.
    """
    if k > n:
        raise ValueError(f"cannot draw {k} unique ids from range({n})")
    if 4 * k >= n:
        return rng.choice(n, size=k, replace=False)
    got = np.unique(rng.integers(0, n, size=2 * k))
    while len(got) < k:
        got = np.union1d(got, rng.integers(0, n, size=2 * k))
    return rng.permutation(got)[:k]
