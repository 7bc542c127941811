"""Optimal aggregation-weight solve (paper eq. 7-8), as ``repro.core.solve``.

Stationarity of the context-dependent bound gives the K×K system

    β (U Uᵀ) α = −U ∇f        ⇔       β G α = −c

solved with Tikhonov damping ``ridge·tr(G)/K`` (G is PSD; the damping keeps
the solve well-posed when updates are nearly collinear), or through a
pseudo-inverse.  ``expectation_scale`` is the §III-C expected-bound factor
(N−1)/(K−1); ``sum_to`` the mass-conserving KKT variant

    [ β(G + ρI)   1 ] [α]   [−c]
    [    1ᵀ       0 ] [λ] = [ s ].

K is a cohort or a tier's children (tens to a few hundred), so the solve
runs in ``torch.linalg`` on the tensors' device, with no kernel of its own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SolveConfig:
    beta: float = 10.0              # smoothness constant; paper sets β = 1/lr
    ridge: float = 1e-6             # Tikhonov damping, relative to mean diag
    method: str = "cholesky"        # "cholesky" | "pinv"
    expectation_scale: float = 1.0  # (N-1)/(K-1) for the §III-C variant
    clip_norm: Optional[float] = None  # optional safety clip on ‖α‖
    sum_to: Optional[float] = None  # mass-conserving Σα = s constraint
                                    # (overrides expectation_scale)

    def __post_init__(self):
        if self.sum_to is not None and self.clip_norm is not None:
            raise ValueError("clip_norm cannot be combined with sum_to: "
                             "rescaling α would silently break the Σα mass "
                             "constraint")


def solve_alpha(G: torch.Tensor, c: torch.Tensor,
                cfg: SolveConfig) -> torch.Tensor:
    """Return α* minimising the context-dependent bound."""
    K = G.shape[0]
    eye = torch.eye(K, dtype=G.dtype, device=G.device)
    scale = (torch.trace(G) / K).clamp(min=1e-30)
    if cfg.sum_to is not None:
        A = cfg.beta * (G + (cfg.ridge * scale) * eye)
        ones = torch.ones((K, 1), dtype=G.dtype, device=G.device)
        kkt = torch.cat([torch.cat([A, ones], dim=1),
                         torch.cat([ones.T, torch.zeros((1, 1), dtype=G.dtype,
                                                        device=G.device)],
                                   dim=1)], dim=0)
        rhs = torch.cat([-c, torch.full((1,), cfg.sum_to, dtype=G.dtype,
                                        device=G.device)])
        alpha = torch.linalg.solve(kkt, rhs)[:K]
    elif cfg.method == "pinv":
        alpha = -torch.linalg.pinv(G, rtol=1e-6) @ c / cfg.beta
        alpha = alpha * cfg.expectation_scale
    else:
        A = G + (cfg.ridge * scale) * eye
        alpha = -torch.linalg.solve(A, c) / cfg.beta
        alpha = alpha * cfg.expectation_scale
    if cfg.clip_norm is not None:
        norm = torch.linalg.vector_norm(alpha)
        alpha = alpha * torch.clamp(cfg.clip_norm / norm.clamp(min=1e-30),
                                    max=1.0)
    return alpha


def bound_value(G: torch.Tensor, c: torch.Tensor, alpha: torch.Tensor,
                beta) -> torch.Tensor:
    """g(α) = cᵀα + (β/2) αᵀGα — negative at α*."""
    return c @ alpha + 0.5 * beta * alpha @ G @ alpha


def theorem1_reduction(G: torch.Tensor, alpha: torch.Tensor,
                       beta) -> torch.Tensor:
    """Theorem 1 guaranteed loss reduction: (β/2) αᵀGα."""
    return 0.5 * beta * alpha @ G @ alpha
