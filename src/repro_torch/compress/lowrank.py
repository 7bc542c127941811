"""Rank-r factored summaries (``repro.compress.lowrank``).

Reshapes the flat n-vector into a near-square (rows × cols) matrix (zero
padded) and ships the best rank-r approximation as two factors:
``r·(rows + cols)`` wire words.  A projection, so error feedback makes it
convergent; at full rank it is exact.  The factors are sign-ambiguous under
SVD, so only the decodes are comparable across implementations.
"""
from __future__ import annotations

import math

import torch

from .base import Compressed, CompressConfig, Compressor, register_scheme


def _shape_for(n: int):
    rows = int(math.ceil(math.sqrt(n)))
    cols = int(math.ceil(n / rows))
    return rows, cols


class LowRankCompressor(Compressor):
    """Truncated-SVD factorization of the near-square reshape."""

    name = "lowrank"
    linear = False

    def __init__(self, rank: int):
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.rank = int(rank)

    def _rank_for(self, n: int) -> int:
        rows, cols = _shape_for(n)
        return min(self.rank, rows, cols)

    def encode(self, vec: torch.Tensor, seed: int = 0) -> Compressed:
        n = int(vec.shape[0])
        rows, cols = _shape_for(n)
        r = self._rank_for(n)
        m = torch.zeros((rows * cols,), dtype=torch.float32, device=vec.device)
        m[:n] = vec.float()
        u, s, vt = torch.linalg.svd(m.view(rows, cols), full_matrices=False)
        return Compressed(self.name, n, (u[:, :r] * s[:r], vt[:r, :]), seed)

    def decode(self, comp: Compressed) -> torch.Tensor:
        a, b = comp.data
        return (a @ b).reshape(-1)[:comp.n]

    def wire_floats(self, n: int) -> int:
        rows, cols = _shape_for(n)
        return self._rank_for(n) * (rows + cols)


def _build(cfg: CompressConfig, n: int) -> LowRankCompressor:
    if cfg.rank is not None:
        return LowRankCompressor(cfg.rank)
    rows, cols = _shape_for(n)
    return LowRankCompressor(max(1, int(n / (cfg.ratio * (rows + cols)))))


register_scheme("lowrank", _build)
