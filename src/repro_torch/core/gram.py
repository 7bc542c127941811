"""Gram-matrix / cross-term helpers for contextual aggregation.

The contextual solve needs two reductions over the parameter axis:

    G = U Uᵀ ∈ R^{K×K}   and   c = U g ∈ R^{K}

The aggregators get them from ``repro_torch.kernels.ops.gram_and_cross``
(the Hopper kernel on the card); :func:`gram_and_cross` here is the dense
reference form, as in ``repro.core.gram``.  The block functions compose
(G, c) from per-group pieces — what a gateway tier computes in parts; the
fused block ``kernels.ops.gram_block_and_cross`` (the ``gram_block`` kernel)
fits them as ``block_fn``.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence, Tuple

import torch


def gram_and_cross(updates: torch.Tensor, grad: torch.Tensor,
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(G, c)`` from stacked updates ``U (K, n)`` and gradient ``g (n,)``."""
    u = updates.to(dtype)
    g = grad.to(dtype)
    return u @ u.T, u @ g


def gram_and_cross_chunked(updates: torch.Tensor, grad: torch.Tensor,
                           chunk: int = 1 << 16
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming ``(G, c)``: one pass over the parameter axis in ``chunk``
    columns, f32 accumulation, one chunk upcast at a time."""
    K, n = updates.shape
    G = torch.zeros((K, K), dtype=torch.float32, device=updates.device)
    c = torch.zeros((K,), dtype=torch.float32, device=updates.device)
    for start in range(0, n, chunk):
        u = updates[:, start:start + chunk].float()
        G = G + u @ u.T
        c = c + u @ grad[start:start + chunk].float()
    return G, c


def gram_block(ua: torch.Tensor, ub: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One off-diagonal Gram block ``G_ab = U_a U_bᵀ (K_a, K_b)``."""
    return ua.to(dtype) @ ub.to(dtype).T


def gram_block_chunked(ua: torch.Tensor, ub: torch.Tensor,
                       chunk: int = 1 << 16) -> torch.Tensor:
    """Streaming ``U_a U_bᵀ``: one pass over the shared parameter axis."""
    (Ka, n), (Kb, nb) = ua.shape, ub.shape
    if n != nb:
        raise ValueError(f"block operands disagree on n: {n} vs {nb}")
    out = torch.zeros((Ka, Kb), dtype=torch.float32, device=ua.device)
    for start in range(0, n, chunk):
        out = out + (ua[:, start:start + chunk].float()
                     @ ub[:, start:start + chunk].float().T)
    return out


def merge_gram_blocks(diag: Sequence[torch.Tensor],
                      cross: Mapping[Tuple[int, int], torch.Tensor],
                      cross_terms: Sequence[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reassemble full-fleet ``(G, c)`` from per-group pieces:
    ``diag[g] = U_g U_gᵀ``, ``cross[(g, h)] = U_g U_hᵀ`` for g < h (its
    transpose fills (h, g)), ``cross_terms[g] = U_g ∇f``.  Group order fixes
    the row order of the result."""
    P = len(diag)
    if len(cross_terms) != P:
        raise ValueError(f"{P} diagonal blocks but {len(cross_terms)} "
                         "cross-term segments")
    rows = []
    for g in range(P):
        row = [diag[g] if g == h else cross[(g, h)] if g < h
               else cross[(h, g)].T for h in range(P)]
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows, dim=0), torch.cat(list(cross_terms))


def blockwise_gram_and_cross(
        groups: Sequence[torch.Tensor], grad: torch.Tensor,
        block_fn: Optional[Callable] = None,
        diag_fn: Optional[Callable] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full ``(G, c)`` from per-group update matrices by block composition.
    ``diag_fn(U_g, g) -> (G_gg, c_g)`` defaults to :func:`gram_and_cross`,
    ``block_fn(U_g, U_h) -> G_gh`` to :func:`gram_block`."""
    diag_fn = diag_fn or gram_and_cross
    block_fn = block_fn or gram_block
    diag, cross_terms, cross = [], [], {}
    for g, ug in enumerate(groups):
        Gg, cg = diag_fn(ug, grad)
        diag.append(Gg)
        cross_terms.append(cg)
        for h in range(g + 1, len(groups)):
            cross[(g, h)] = block_fn(ug, groups[h])
    return merge_gram_blocks(diag, cross, cross_terms)


def gram_residual(G: torch.Tensor, c: torch.Tensor, alpha: torch.Tensor,
                  beta) -> torch.Tensor:
    """Paper eq. (10) residual: ``r_k = ⟨Δ_k, ∇f + β Σ α_j Δ_j⟩ = c + β G α``.
    Zero at the optimum — a numerical health metric."""
    return c + beta * (G @ alpha)
