"""Batching utilities: a numpy copy of ``repro.data.loader`` (same draws)."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def epoch_batches(x: np.ndarray, y: np.ndarray, batch_size: int,
                  rng: np.random.RandomState) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled mini-batches over one epoch (drops the ragged tail)."""
    order = rng.permutation(len(y))
    for start in range(0, len(y) - batch_size + 1, batch_size):
        ids = order[start:start + batch_size]
        yield x[ids], y[ids]


def batch_iterator(x: np.ndarray, y: np.ndarray, batch_size: int,
                   num_batches: int, seed: int = 0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite-style iterator yielding exactly ``num_batches`` batches."""
    rng = np.random.RandomState(seed)
    produced = 0
    while produced < num_batches:
        for bx, by in epoch_batches(x, y, batch_size, rng):
            yield bx, by
            produced += 1
            if produced >= num_batches:
                return
        if len(y) < batch_size:   # tiny dataset: sample with replacement
            ids = rng.randint(0, len(y), batch_size)
            yield x[ids], y[ids]
            produced += 1
