"""Linear sketch compressors: signed random projection and SRHT
(``repro.compress.sketch``).

Both are a matrix ``S (m, n)`` with ``E[SᵀS] = I``; S never rides the wire:
every party regenerates it from the shared per-round ``seed``.

  * :class:`SignSketch` — dense Rademacher projection ``S = R/√m``.  Encode
    and decode go through ``kernels.ops.sign_sketch`` and
    ``sign_sketch_adjoint`` (the ``sign_sketch`` kernels on the card): R's
    entries are a hash of (row, column, seed), generated inside the
    contraction and never stored.  The signs are bit-identical to the
    reference's.
  * :class:`SRHTSketch` — subsampled randomized Hadamard transform
    ``S = √(N/m)·P·H_N/√N·D``, in plain torch (the reference has no kernel
    for it).  Its sign flips D and row sample P come from a
    ``torch.Generator`` seeded by (seed_base, seed) on the CPU, so the CPU
    and the card draw the same ones; they are not the reference's
    ``jax.random`` draws, which torch cannot reproduce.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops
from ..kernels.ref import rng_sign_matrix
from .base import Compressed, CompressConfig, Compressor, register_scheme


def _seed32(seed_base: int, seed: int) -> int:
    """Fold (seed_base, per-round seed) into the uint32 counter-RNG seed
    (Python ints, as ``repro.compress.sketch._seed32``)."""
    return (int(seed_base) * 0x9E3779B1 + int(seed) * 0x85EBCA6B
            + 0x1B873593) & 0xFFFFFFFF


class SignSketch(Compressor):
    """Signed random projection ``v ↦ R v / √m`` (unbiased: E[SᵀS] = I).

    The decode applies the MMSE shrinkage ``m/(m+n+1)·Sᵀs``: the naive
    adjoint inflates norms by ~n/m, which makes error feedback's
    round-to-round operator an expansion; shrunk, it contracts."""

    name = "sign_sketch"
    linear = True

    def __init__(self, m: int, seed_base: int = 0):
        if m < 1:
            raise ValueError(f"sketch_dim must be >= 1, got {m}")
        self.m = int(m)
        self.seed_base = seed_base

    def sign_matrix(self, n: int, seed: int = 0) -> torch.Tensor:
        """Materialized ``S = R/√m`` — for tests only; encode and decode
        never build it."""
        r = rng_sign_matrix(_seed32(self.seed_base, seed), self.m, n)
        return r / torch.sqrt(torch.tensor(float(self.m)))

    def encode(self, vec: torch.Tensor, seed: int = 0) -> Compressed:
        s = ops.sign_sketch(vec.float().contiguous()[None, :],
                            _seed32(self.seed_base, seed), self.m)[0]
        return Compressed(self.name, int(vec.shape[0]), (s,), seed)

    def decode(self, comp: Compressed) -> torch.Tensor:
        shrink = self.m / (self.m + comp.n + 1.0)
        return shrink * ops.sign_sketch_adjoint(
            comp.data[0].contiguous(), _seed32(self.seed_base, comp.seed),
            comp.n)

    def wire_floats(self, n: int) -> int:
        return self.m


def fwht(x: torch.Tensor) -> torch.Tensor:
    """In-order fast Walsh–Hadamard transform of a power-of-2 vector,
    unnormalized: ``fwht(fwht(x)) = N·x``."""
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"fwht needs a power-of-2 length, got {n}")
    y, h = x, 1
    while h < n:
        y = y.reshape(-1, 2, h)
        y = torch.stack([y[:, 0, :] + y[:, 1, :],
                         y[:, 0, :] - y[:, 1, :]], dim=1)
        h *= 2
    return y.reshape(-1)


class SRHTSketch(Compressor):
    """Subsampled randomized Hadamard transform (structured, matrix-free).

    ``S = √(N/m) · P · (H_N/√N) · D``, N = n padded to a power of 2.  The
    decode shrinks by ``m/N``, which makes decode ∘ encode the orthogonal
    projection onto the sampled rotated coordinates (exact at m = N)."""

    name = "srht"
    linear = True

    def __init__(self, m: int, seed_base: int = 0):
        if m < 1:
            raise ValueError(f"sketch_dim must be >= 1, got {m}")
        self.m = int(m)
        self.seed_base = seed_base

    def _padded(self, n: int) -> int:
        return 1 << max(int(math.ceil(math.log2(max(n, 1)))), 0)

    def _signs_rows(self, n: int, seed: int):
        """``(d (N,) ±1 f32, rows (m,) int64, N, m)`` on the CPU, drawn from a
        generator seeded by (seed_base, seed)."""
        N = self._padded(n)
        m = min(self.m, N)
        gen = torch.Generator()
        gen.manual_seed(_seed32(self.seed_base, seed))
        d = 1.0 - 2.0 * torch.randint(0, 2, (N,), generator=gen).float()
        rows = torch.randperm(N, generator=gen)[:m]
        return d, rows, N, m

    def encode(self, vec: torch.Tensor, seed: int = 0) -> Compressed:
        n = int(vec.shape[0])
        d, rows, N, m = self._signs_rows(n, seed)
        dev = vec.device
        v = torch.zeros((N,), dtype=torch.float32, device=dev)
        v[:n] = vec.float()
        t = fwht(d.to(dev) * v) / torch.sqrt(torch.tensor(float(N),
                                                          device=dev))
        s = t[rows.to(dev)] * torch.sqrt(torch.tensor(N / m, device=dev))
        return Compressed(self.name, n, (s,), seed)

    def decode(self, comp: Compressed) -> torch.Tensor:
        d, rows, N, m = self._signs_rows(comp.n, comp.seed)
        dev = comp.data[0].device
        z = torch.zeros((N,), dtype=torch.float32, device=dev)
        z[rows.to(dev)] = comp.data[0] * torch.sqrt(torch.tensor(N / m,
                                                                 device=dev))
        shrink = m / float(N)
        full = d.to(dev) * fwht(z) / torch.sqrt(torch.tensor(float(N),
                                                            device=dev))
        return shrink * full[:comp.n]

    def wire_floats(self, n: int) -> int:
        return min(self.m, self._padded(n))


def _build_sign(cfg: CompressConfig, n: int) -> SignSketch:
    m = cfg.sketch_dim if cfg.sketch_dim is not None else max(
        1, int(n / cfg.ratio))
    return SignSketch(m, seed_base=cfg.seed)


def _build_srht(cfg: CompressConfig, n: int) -> SRHTSketch:
    m = cfg.sketch_dim if cfg.sketch_dim is not None else max(
        1, int(n / cfg.ratio))
    return SRHTSketch(m, seed_base=cfg.seed)


register_scheme("sign_sketch", _build_sign)
register_scheme("srht", _build_srht)
