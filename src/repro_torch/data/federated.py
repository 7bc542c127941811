"""Federated dataset container + non-IID partitioners.

A copy of ``repro.data.federated`` (numpy only, bit-identical output).

``FederatedDataset`` stores equal-size per-device shards as dense arrays
``x (N, m, ...), y (N, m)`` so client local training can be ``vmap``-ed over
the device axis (the paper's eq. (1) assumes equal |D_k|; unequal sizes are
supported through per-device sample masks and p_k weights).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class FederatedDataset:
    x: np.ndarray          # (N, m, ...) per-device features
    y: np.ndarray          # (N, m)      per-device labels
    mask: np.ndarray       # (N, m)      1.0 where the sample is real
    test_x: np.ndarray     # (M, ...)    held-out global test set
    test_y: np.ndarray     # (M,)
    num_classes: int

    @property
    def num_devices(self) -> int:
        return self.x.shape[0]

    @property
    def samples_per_device(self) -> int:
        return self.x.shape[1]

    def client_weights(self) -> np.ndarray:
        """p_k = |D_k| / |D| (paper §II-A)."""
        sizes = self.mask.sum(axis=1)
        return (sizes / sizes.sum()).astype(np.float32)


def dirichlet_partition(x: np.ndarray, y: np.ndarray, num_devices: int,
                        concentration: float, num_classes: int,
                        seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dirichlet(β) label-skew partition (standard non-IID FL benchmark).

    Lower ``concentration`` → more skew. Returns equal-size padded shards
    ``(x_dev, y_dev, mask)``; devices short of the quota are padded by
    resampling their own data (mask marks the real samples)."""
    rng = np.random.RandomState(seed)
    n = len(y)
    idx_by_class = [np.where(y == c)[0] for c in range(num_classes)]
    for ix in idx_by_class:
        rng.shuffle(ix)
    proportions = rng.dirichlet([concentration] * num_devices, num_classes)
    device_indices: list[list[int]] = [[] for _ in range(num_devices)]
    for c in range(num_classes):
        splits = (np.cumsum(proportions[c]) * len(idx_by_class[c])).astype(int)[:-1]
        for dev, part in enumerate(np.split(idx_by_class[c], splits)):
            device_indices[dev].extend(part.tolist())

    m = max(1, int(np.median([len(d) for d in device_indices])))
    xs, ys, masks = [], [], []
    for dev in range(num_devices):
        ids = np.array(device_indices[dev], dtype=np.int64)
        if len(ids) == 0:   # give an empty device one random sample
            ids = rng.randint(0, n, size=1)
        if len(ids) >= m:
            take = ids[:m]
            mask = np.ones(m, np.float32)
        else:
            pad = rng.choice(ids, m - len(ids), replace=True)
            take = np.concatenate([ids, pad])
            mask = np.concatenate([np.ones(len(ids), np.float32),
                                   np.zeros(m - len(ids), np.float32)])
        xs.append(x[take])
        ys.append(y[take])
        masks.append(mask)
    return np.stack(xs), np.stack(ys), np.stack(masks)


def make_federated(x: np.ndarray, y: np.ndarray, num_devices: int,
                   num_classes: int, concentration: Optional[float] = 0.5,
                   test_frac: float = 0.15, seed: int = 0) -> FederatedDataset:
    """Split off a test set, then partition the rest across devices.
    ``concentration=None`` → IID uniform partition."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(y))
    x, y = x[order], y[order]
    n_test = int(len(y) * test_frac)
    test_x, test_y = x[:n_test], y[:n_test]
    x, y = x[n_test:], y[n_test:]

    if concentration is None:
        m = len(y) // num_devices
        xs = x[:m * num_devices].reshape(num_devices, m, *x.shape[1:])
        ys = y[:m * num_devices].reshape(num_devices, m)
        mask = np.ones((num_devices, m), np.float32)
    else:
        xs, ys, mask = dirichlet_partition(x, y, num_devices, concentration,
                                           num_classes, seed)
    return FederatedDataset(xs, ys, mask, test_x, test_y, num_classes)
