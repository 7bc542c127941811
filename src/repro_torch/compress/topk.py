"""Top-k magnitude masking — the selection compressor (``repro.compress.topk``).

Keeps the k largest-|v| coordinates and ships (value, index) pairs: 2k wire
words for an n-vector, so ``CompressConfig.ratio`` resolves
``k = n/(2·ratio)``.  The decode is the exact sparse vector the receiver
applies; error feedback re-injects the dropped residual next round.  The
selection goes through ``kernels.ops.topk_select`` (the ``topk`` kernel on
the card).
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .base import Compressed, CompressConfig, Compressor, register_scheme


class TopKCompressor(Compressor):
    """Magnitude top-k with exact sparse decode."""

    name = "topk"
    linear = False

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)

    def encode(self, vec: torch.Tensor, seed: int = 0) -> Compressed:
        n = int(vec.shape[0])
        vals, idx = ops.topk_select(vec.float().contiguous(), min(self.k, n))
        return Compressed(self.name, n, (vals, idx), seed)

    def decode(self, comp: Compressed) -> torch.Tensor:
        vals, idx = comp.data
        out = torch.zeros((comp.n,), dtype=torch.float32, device=vals.device)
        out[idx.long()] = vals
        return out

    def wire_floats(self, n: int) -> int:
        return 2 * min(self.k, n)


def _build(cfg: CompressConfig, n: int) -> TopKCompressor:
    k = cfg.k if cfg.k is not None else max(1, int(n / (2.0 * cfg.ratio)))
    return TopKCompressor(k)


register_scheme("topk", _build)
