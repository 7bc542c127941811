"""Compressor protocol for sub-O(n) gateway summaries (``repro.compress.base``).

Every scheme is an encoder/decoder pair over flat f32 vectors:

    comp  = compressor.encode(v, seed)      # what rides the wire
    v_hat = compressor.decode(comp)         # what the receiver reconstructs

  * **Linear sketches** (``linear = True``: sign random projection, SRHT,
    identity) are a matrix ``S (m, n)`` with ``E[SᵀS] = I`` — the scaling is
    folded into S, so sketch-space inner products are unbiased estimates of
    true ones and the cloud's P×P Gram stage runs on the payloads
    (:func:`payload_gram`).
  * **Selections** (top-k, low-rank) decode to the exact vector the receiver
    applies, so Gram blocks on decodes are exact for the applied updates.

``CompressConfig.build(n)`` resolves a scheme and a byte budget into a
compressor: ``ratio`` is the uplink reduction target for one n-vector, and
each scheme prices its own payload layout (top-k pays 2 words per kept
entry, rank-r pays r·(rows+cols), sketches pay m).  Every payload element
rides as a 4-byte word, whatever the tensor's dtype.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, replace as _dc_replace
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

WIRE_BYTES = 4.0      # f32 values and i32 indices both ride as 4-byte words


@dataclass
class Compressed:
    """One compressed vector as it rides the wire: ``data`` the payload
    tensors, ``n`` the original length, ``seed`` what the decoder needs to
    rebuild shared randomness (linear sketches regenerate S from it)."""
    scheme: str
    n: int
    data: Tuple[torch.Tensor, ...]
    seed: int = 0

    @property
    def nbytes(self) -> float:
        """Serialized wire size: every payload element is a 4-byte word."""
        return WIRE_BYTES * sum(int(d.numel()) for d in self.data)


class Compressor(abc.ABC):
    """One compression scheme (see the module docstring for the contract)."""

    name: str = "base"
    linear: bool = False        # True ⇒ encode is v ↦ S v with E[SᵀS] = I

    @abc.abstractmethod
    def encode(self, vec: torch.Tensor, seed: int = 0) -> Compressed:
        """Compress a flat f32 vector ``(n,)``."""

    @abc.abstractmethod
    def decode(self, comp: Compressed) -> torch.Tensor:
        """Reconstruct the full-width estimate ``(n,)`` of the encoded vector."""

    @abc.abstractmethod
    def wire_floats(self, n: int) -> int:
        """Payload size (4-byte words) for an ``n``-vector — equals
        ``encode(v).nbytes / 4`` for any ``v`` of that length."""

    def dot(self, a: Compressed, b: Compressed) -> torch.Tensor:
        """Estimate of ``⟨u, v⟩`` from two payloads: in sketch space for
        linear schemes (both must share one ``seed``), else the exact dot of
        the decodes."""
        if self.linear:
            if a.seed != b.seed:
                raise ValueError(f"sketch-space dot needs a shared sketch: "
                                 f"seeds {a.seed} != {b.seed}")
            return torch.dot(a.data[0], b.data[0])
        return torch.dot(self.decode(a), self.decode(b))


def payload_gram(compressor: Compressor, u_comps: Sequence[Compressed],
                 g_comps: Sequence[Compressed], weights: np.ndarray
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cloud's sketched cross-terms ``G₂[g,h] ≈ ⟨ū_g, ū_h⟩`` and
    ``c₂[g] ≈ ⟨ū_g, ĝ⟩`` with ``ĝ = Σ w_h ĝ_h``, without an n-vector when
    the scheme is linear.  Linear sketches price the encoded targets while
    the combine applies their shrunk decodes: every child shrinks by one
    factor s, which scales (G₂, c₂) by s², and the Σγ=1 solve is invariant
    under that joint rescale."""
    w = np.asarray(weights, np.float64)
    w = w / max(float(w.sum()), 1e-12)
    if compressor.linear:
        seeds = {c.seed for c in list(u_comps) + list(g_comps)}
        if len(seeds) != 1:
            raise ValueError(f"sketch-space Gram needs one shared sketch "
                             f"seed, got {sorted(seeds)}")
        S = torch.stack([c.data[0] for c in u_comps])          # (P, m)
        sg = sum(float(wi) * c.data[0] for wi, c in zip(w, g_comps))
    else:
        S = torch.stack([compressor.decode(c) for c in u_comps])   # (P, n)
        sg = sum(float(wi) * compressor.decode(c)
                 for wi, c in zip(w, g_comps))
    return S @ S.T, S @ sg


class IdentityCompressor(Compressor):
    """No-op scheme (S = I): the exactness anchor."""

    name = "identity"
    linear = True

    def encode(self, vec: torch.Tensor, seed: int = 0) -> Compressed:
        return Compressed("identity", int(vec.shape[0]), (vec.float(),), seed)

    def decode(self, comp: Compressed) -> torch.Tensor:
        return comp.data[0]

    def wire_floats(self, n: int) -> int:
        return n


_SCHEMES: Dict[str, Callable[["CompressConfig", int], Compressor]] = {}


def register_scheme(name: str, build: Callable[["CompressConfig", int],
                                               Compressor]) -> None:
    if name in _SCHEMES:
        raise KeyError(f"compression scheme '{name}' already registered")
    _SCHEMES[name] = build


def available_schemes() -> Tuple[str, ...]:
    return tuple(sorted(_SCHEMES))


register_scheme("identity", lambda cfg, n: IdentityCompressor())


@dataclass(frozen=True)
class CompressConfig:
    """Scheme + byte budget for summary compression (``HierConfig.compress``).

    ``ratio`` is the per-vector uplink reduction target: an n-float vector
    rides in ≤ n/ratio 4-byte words, and each scheme solves for its own
    parameter (sketch_dim = n/ratio; top-k pays value+index so k = n/2ratio;
    rank-r pays r·(rows+cols)).  Explicit ``sketch_dim`` / ``k`` / ``rank``
    override the budget-derived value.
    """
    scheme: str = "topk"           # identity | sign_sketch | srht | topk | lowrank
    ratio: float = 8.0
    sketch_dim: Optional[int] = None
    k: Optional[int] = None
    rank: Optional[int] = None
    u_frac: float = 0.5            # share of the per-summary budget spent on
                                   # ū vs ĝ; linear sketches need 0.5 (ū and
                                   # ĝ share S for the sketch-space c-term)
    error_feedback: bool = True
    device_uplink: bool = False    # also EF-compress device→gateway uploads
                                   # (update and gradient streams)
    seed: int = 0

    def __post_init__(self):
        if self.ratio < 1.0:
            raise ValueError(f"ratio must be >= 1, got {self.ratio}")
        for fname in ("sketch_dim", "k", "rank"):
            v = getattr(self, fname)
            if v is not None and v < 1:
                raise ValueError(f"{fname} must be >= 1, got {v}")
        if not (0.0 < self.u_frac < 1.0):
            raise ValueError(f"u_frac must be in (0, 1), got {self.u_frac}")
        if self.u_frac != 0.5 and self.scheme in ("identity", "sign_sketch",
                                                  "srht"):
            raise ValueError(f"u_frac={self.u_frac} needs a selection scheme "
                             "(topk|lowrank): linear sketches must sketch ū "
                             "and ĝ with the same S")

    def _resolve(self, n: int, ratio: float) -> Compressor:
        # imported here so base carries no scheme dependencies
        from . import lowrank, sketch, topk  # noqa: F401  (register schemes)
        if self.scheme not in _SCHEMES:
            raise KeyError(f"unknown compression scheme '{self.scheme}'; "
                           f"have {available_schemes()}")
        cfg = self if ratio == self.ratio else _dc_replace(self, ratio=ratio,
                                                           u_frac=0.5)
        return _SCHEMES[self.scheme](cfg, n)

    def build(self, n: int) -> Compressor:
        """The compressor for a single ``n``-float vector (budget: n/ratio
        wire words)."""
        return self._resolve(n, self.ratio)

    def build_pair(self, n: int) -> Tuple[Compressor, Compressor]:
        """The (ū, ĝ) compressor pair for one summary: the joint budget
        ``2n/ratio`` words split ``u_frac : 1−u_frac``, each clamped to full
        width (per-vector ratio ≥ 1)."""
        return (self._resolve(n, max(1.0, self.ratio / (2.0 * self.u_frac))),
                self._resolve(n, max(1.0, self.ratio
                                     / (2.0 * (1.0 - self.u_frac)))))
