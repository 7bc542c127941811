"""Procedural dataset generators (no downloads).

A copy of ``repro.data.synthetic``: numpy ``RandomState`` only, so its
output is bit-identical to the reference's for the same seed.

* ``make_synthetic(alpha, beta)`` — the Synthetic(α,β) construction of
  Shamir et al. / Li et al. used by the paper: per-device softmax-linear
  models ``y = argmax softmax(W_k x + b_k)`` where ``W_k, b_k ~ N(u_k, 1)``,
  ``u_k ~ N(0, α)``, and device inputs ``x_k ~ N(v_k, Σ)`` with
  ``v_k ~ N(B_k, 1), B_k ~ N(0, β)``.  α controls model heterogeneity,
  β controls feature heterogeneity; Synthetic_IID uses a single shared
  (W, b) and shared input distribution.

* ``make_mnist_like`` / ``make_femnist_like`` — class-conditional Gaussian
  mixtures over 784 dims with 10/62 classes, standing in for the real
  MNIST/FEMNIST.

* ``make_token_stream`` — deterministic synthetic token corpus for the LM
  architectures (Zipf-distributed unigrams with Markov bigram structure so
  models have learnable signal).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_synthetic(alpha: float, beta: float, num_devices: int = 30,
                   samples_per_device: int = 200, dim: int = 60,
                   num_classes: int = 10, iid: bool = False,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Return ``(x, y)`` with shapes ``(num_devices, m, dim)`` and
    ``(num_devices, m)`` following the Synthetic(α,β) recipe."""
    rng = np.random.RandomState(seed)
    # Shared diagonal input covariance Σ_jj = j^{-1.2}
    diag = np.array([(j + 1) ** (-1.2) for j in range(dim)])

    if iid:
        W = rng.normal(0, 1, (dim, num_classes))
        b = rng.normal(0, 1, (num_classes,))

    xs, ys = [], []
    for k in range(num_devices):
        if iid:
            Wk, bk, vk = W, b, np.zeros(dim)
        else:
            uk = rng.normal(0, alpha)
            Wk = rng.normal(uk, 1, (dim, num_classes))
            bk = rng.normal(uk, 1, (num_classes,))
            Bk = rng.normal(0, beta)
            vk = rng.normal(Bk, 1, dim)
        xk = rng.multivariate_normal(vk, np.diag(diag), samples_per_device)
        logits = xk @ Wk + bk
        yk = np.argmax(logits, axis=1)
        xs.append(xk.astype(np.float32))
        ys.append(yk.astype(np.int32))
    return np.stack(xs), np.stack(ys)


def _class_gaussian(num_classes: int, dim: int, rng: np.random.RandomState,
                    sep: float = 3.0) -> np.ndarray:
    """Well-separated class means on a sphere."""
    means = rng.normal(0, 1, (num_classes, dim))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    return means * sep


def make_mnist_like(num_samples: int = 6000, dim: int = 784,
                    num_classes: int = 10, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussian mixture standing in for MNIST."""
    rng = np.random.RandomState(seed)
    means = _class_gaussian(num_classes, dim, rng)
    y = rng.randint(0, num_classes, num_samples).astype(np.int32)
    x = means[y] + rng.normal(0, 1.0, (num_samples, dim))
    return x.astype(np.float32), y


def make_femnist_like(num_samples: int = 8000, dim: int = 784,
                      num_classes: int = 62, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """62-class variant standing in for Federated-EMNIST."""
    return make_mnist_like(num_samples, dim, num_classes, seed)


def make_token_stream(num_tokens: int, vocab_size: int, seed: int = 0,
                      zipf_a: float = 1.2) -> np.ndarray:
    """Zipf unigram + bigram-Markov synthetic corpus (learnable structure)."""
    rng = np.random.RandomState(seed)
    base = rng.zipf(zipf_a, num_tokens).astype(np.int64)
    base = (base - 1) % vocab_size
    # Inject bigram determinism: every even position partially predicts the next.
    out = base.copy()
    mask = rng.rand(num_tokens) < 0.5
    shifted = (np.roll(out, 1) * 31 + 7) % vocab_size
    out[mask] = shifted[mask]
    return out.astype(np.int32)
