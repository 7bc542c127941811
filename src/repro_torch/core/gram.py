"""Gram-matrix / cross-term helpers for contextual aggregation.

The contextual solve needs two reductions over the parameter axis:

    G = U Uᵀ ∈ R^{K×K}   and   c = U g ∈ R^{K}

The aggregators get them from ``repro_torch.kernels.ops.gram_and_cross``
(the Hopper kernel on the card); :func:`gram_and_cross` here is the dense
reference form, as in ``repro.core.gram``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def gram_and_cross(updates: torch.Tensor, grad: torch.Tensor,
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(G, c)`` from stacked updates ``U (K, n)`` and gradient ``g (n,)``."""
    u = updates.to(dtype)
    g = grad.to(dtype)
    return u @ u.T, u @ g


def gram_residual(G: torch.Tensor, c: torch.Tensor, alpha: torch.Tensor,
                  beta) -> torch.Tensor:
    """Paper eq. (10) residual: ``r_k = ⟨Δ_k, ∇f + β Σ α_j Δ_j⟩ = c + β G α``.
    Zero at the optimum — a numerical health metric."""
    return c + beta * (G @ alpha)
