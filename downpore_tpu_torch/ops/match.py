"""Hash-space helpers of candidate retrieval (copied from
``downpore_tpu/ops/match.py``, which imports jax at the top).

Seed ids map to a power-of-two bucket space ``H``: identity when every id
fits, else Knuth multiplicative hashing.  Hash collisions only add
retrieval counts, so recall is preserved; the chain DP filters.
"""
from __future__ import annotations

import numpy as np

KNUTH = 2654435761


def choose_hash_size(num_seeds: int, max_h: int = 1 << 17) -> int:
    """Bucket-space size: the next power of two over ``num_seeds``,
    capped at ``max_h``."""
    h = 1
    while h < num_seeds:
        h *= 2
    return min(h, max_h)


def hash_ids(ids: np.ndarray, num_seeds: int, H: int) -> np.ndarray:
    """Seed id -> bucket.  Identity when everything fits; Knuth
    multiplicative hashing otherwise."""
    if num_seeds <= H:
        return np.asarray(ids, dtype=np.int64)
    return ((np.asarray(ids, dtype=np.uint64) * np.uint64(KNUTH))
            % np.uint64(H)).astype(np.int64)
