"""Robust statistics on the contextual (G, c) slots (``repro.robust.gramstats``).

Every contextual solve — the flat registry, the fused tier stages, the
streamed engine's accumulated statistics — consumes the pair

    G = U Uᵀ   (K×K update Gram),    c_k = ⟨Δ_k, ĝ⟩,

and ĝ is itself a mean of per-client gradient reports, so c is a row-mean
of the cross matrix ``C = U Gᵀ`` (``C[k, j] = ⟨Δ_k, g_j⟩``).  A Byzantine
client damages both slots: a scaled or noised update inflates row and
column k of G and row k of C, and a corrupted gradient report poisons every
client's c_k through the mean over columns j.

:func:`robustify` defends both in K-dimensional statistics space, so it
composes with the streamed engine's ``C = D GMᵀ`` exactly as with the
fused dense path:

  * **clipping** — per-client scales ``s_k = min(1, τ/‖Δ_k‖)`` with
    ``τ = clip × median ‖Δ‖`` read off ``diag G``; ``G ← s sᵀ ⊙ G``,
    ``C ← diag(s) C``.  The caller combines with ``α_eff = s ⊙ α``.
  * **pooling** — c_k is re-estimated from row k of the clipped cross
    matrix by median-of-means over index buckets or a trimmed mean.

With defenses off (``clip=None, pool="mean"``) it is the exact identity
``(G, C @ w, 1)``.

Two choices keep the port equal to the reference on every device:

  * :func:`median` is the reference's ``jnp.median`` (the midpoint of the
    two middle order statistics for an even count), not ``torch.median``
    (the lower one).  It sorts, so it also serves ``coordinate_median`` at
    model width, where ``torch.quantile`` refuses inputs above 2²⁴
    elements.
  * The median-of-means bucket sums (``ids = arange(J) % B``, static) are
    a zero-padded reshape and ``sum``, not a scatter-add: ``index_add_``
    would add with float atomics on the card and lose the bitwise seeded
    determinism both hier engines hold.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

_EPS = 1e-12


@dataclass(frozen=True)
class RobustConfig:
    """Knobs of the robustified contextual statistics (and the krum
    baseline's f parameter).  Frozen and hashable, as the reference's."""
    clip: Optional[float] = 2.0   # τ = clip × median‖Δ‖; None disables
    pool: str = "mom"             # c-pooling over gradient columns:
                                  #   "mean" | "mom" | "trimmed"
    mom_buckets: int = 0          # 0 → auto: largest odd B <= J (a
                                  #   straight column median)
    trim_frac: float = 0.25       # per-side trim fraction for "trimmed"
    krum_f: Optional[int] = None  # krum: assumed #byzantine (None → ⌈0.2K⌉)

    def __post_init__(self):
        if self.pool not in ("mean", "mom", "trimmed"):
            raise ValueError(f"pool must be mean|mom|trimmed, got "
                             f"'{self.pool}'")
        if self.clip is not None and self.clip <= 0:
            raise ValueError(f"clip must be positive or None, got {self.clip}")
        if not (0.0 <= self.trim_frac < 0.5):
            raise ValueError(f"trim_frac must be in [0, 0.5), got "
                             f"{self.trim_frac}")
        if self.mom_buckets < 0:
            raise ValueError(f"mom_buckets must be >= 0, got "
                             f"{self.mom_buckets}")

    @property
    def enabled(self) -> bool:
        return self.clip is not None or self.pool != "mean"


def median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.median(x, axis=dim)``: sort, then the mean of the two middle
    entries when the count is even (``(lo + hi) * 0.5``, the reference's
    midpoint formula; for an odd count lo = hi)."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    return ((lo + hi) * 0.5).squeeze(dim)


def clip_scales(G: torch.Tensor, cfg: RobustConfig) -> torch.Tensor:
    """Per-client clip scales from ``diag G`` alone: ``s_k = min(1,
    τ/‖Δ_k‖)`` with ``τ = clip × median ‖Δ‖``; ones when clipping is off."""
    norms = torch.sqrt(torch.clamp(torch.diagonal(G), min=0.0))
    if cfg.clip is None:
        return torch.ones_like(norms)
    tau = cfg.clip * median(norms, 0)
    return torch.clamp(tau / torch.clamp(norms, min=_EPS), max=1.0)


def _bucket_means(C: torch.Tensor, B: int) -> torch.Tensor:
    """``(K, B)`` means of the columns j ≡ b (mod B): the columns padded
    with zeros to a multiple of B and summed over the reshaped rounds."""
    K, J = C.shape
    rounds = -(-J // B)
    padded = torch.nn.functional.pad(C, (0, rounds * B - J))
    sums = padded.view(K, rounds, B).sum(dim=1)
    cnts = torch.full((B,), float(J // B), dtype=C.dtype, device=C.device)
    cnts[:J % B] += 1.0
    return sums / cnts


def pool_cross(C: torch.Tensor, w: torch.Tensor,
               cfg: RobustConfig) -> torch.Tensor:
    """Robust row-pooling of the (K, J) cross matrix over gradient columns.

    ``"mean"`` is the plain estimate ``C @ w`` (w = the ĝ mixing weights);
    ``"trimmed"`` drops ``int(trim_frac · J)`` columns each side of each
    sorted row; ``"mom"`` is the median of bucket means over the buckets
    ``j % B`` (B = ``mom_buckets``, or the largest odd B <= J).  J < 3, or a
    trim that would leave no column, falls back to the mean."""
    J = C.shape[1]
    if cfg.pool == "mean" or J < 3:
        return C @ w
    if cfg.pool == "trimmed":
        t = int(cfg.trim_frac * J)
        if J - 2 * t < 1:
            return C @ w
        Cs = torch.sort(C, dim=1).values
        return Cs[:, t:J - t].mean(dim=1)
    B = cfg.mom_buckets if cfg.mom_buckets > 0 else (J if J % 2 else J - 1)
    return median(_bucket_means(C, min(B, J)), 1)


def robustify(G: torch.Tensor, C: torch.Tensor, w: torch.Tensor,
              cfg: RobustConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Robustified ``(G', c', s)`` for a contextual solve.

    ``C`` is either the (K, J) cross matrix (the pooling case) or an
    already-mixed (K,) c vector (only clipping applies); ``w`` are the ĝ
    mixing weights over columns.  The caller combines with
    ``α_eff = s ⊙ α``; with defenses off this is ``(G, C @ w, 1)``."""
    s = clip_scales(G, cfg)
    Gr = G * torch.outer(s, s)
    if C.dim() == 1:
        return Gr, s * C, s
    return Gr, pool_cross(s[:, None] * C, w, cfg), s
