"""Robust aggregation strategies for the flat registry
(``repro.robust.aggregators``).

Registered in ``core.aggregation`` under the common signature:

  * ``contextual_clipped`` — the paper's contextual solve on clipped Gram
    statistics (``RobustConfig(pool="mean")``: norm clipping only).
  * ``contextual_mom``     — clipping + median-of-means pooling of the
    c cross-terms (the full :mod:`.gramstats` defense).
  * ``krum``               — (multi-)Krum selection from the Gram matrix:
    ``‖Δ_i − Δ_j‖² = G_ii + G_jj − 2 G_ij``.
  * ``coordinate_median``  — coordinate-wise median of the stacked updates.

The contextual variants set ``grad_stack = True``: the round builder passes
the stacked per-client gradient reports as ``grad_tree``, so the (K, J)
cross matrix the pooling defends exists.

Kernels: G (and c) come from ``kernels.ops.gram_and_cross``, the cross
matrix ``C = U Gmᵀ`` from ``kernels.ops.gram_block_and_cross`` (the
``gram_block`` kernel on the card), krum's G from the ``gram`` kernel, and
every combine goes through the ``combine`` kernel (``_combine``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.aggregation import (AggregatorConfig, _combine,
                                _stacked_to_matrix, register_aggregator)
from ..core.gram import gram_residual
from ..core.solve import bound_value, solve_alpha, theorem1_reduction
from ..kernels.ops import gram_and_cross, gram_block_and_cross
from .gramstats import RobustConfig, median, robustify

_CLIP_ONLY = RobustConfig(clip=2.0, pool="mean")
_CLIP_MOM = RobustConfig(clip=2.0, pool="mom")


def _robust_cfg(cfg: AggregatorConfig, default: RobustConfig) -> RobustConfig:
    rob = getattr(cfg, "robust", None)
    return rob if isinstance(rob, RobustConfig) else default


def cross_stats(U: torch.Tensor, Gm: torch.Tensor, w: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(G, C)`` of a robust contextual solve: ``G = U Uᵀ`` from ``gram``
    and the (K, J) cross matrix ``C = U Gmᵀ`` from ``gram_block`` (both
    kernels also take ĝ = w Gm, whose c they return unused).  U and Gm
    contiguous f32; the fused engine's robust stages share it."""
    ghat = w @ Gm
    G, _ = gram_and_cross(U, ghat)
    C, _ = gram_block_and_cross(U, Gm, ghat)
    return G, C


def _contextual_robust(params, stacked_updates, grad_tree,
                       cfg: AggregatorConfig, rob: RobustConfig):
    U = _stacked_to_matrix(stacked_updates, cfg.gram_scope)
    Gm = _stacked_to_matrix(grad_tree, cfg.gram_scope)
    w = torch.full((Gm.shape[0],), 1.0 / Gm.shape[0], dtype=torch.float32,
                   device=U.device)
    G, C = cross_stats(U, Gm, w)
    Gr, cr, s = robustify(G, C, w, rob)
    alpha = solve_alpha(Gr, cr, cfg.solve)
    eff = s * alpha                           # combine uses the clipped rows
    new = _combine(params, stacked_updates, eff,
                   U if cfg.gram_scope is None else None)
    beta = cfg.solve.beta
    info = {
        "alpha": eff,
        "clip_scale": s,
        "bound": bound_value(Gr, cr, alpha, beta),
        "theorem1_reduction": theorem1_reduction(Gr, alpha, beta),
        "stationarity_residual": torch.linalg.vector_norm(
            gram_residual(Gr, cr, alpha, beta)),
        "gram_diag": torch.diagonal(Gr),
    }
    return new, info


def aggregate_contextual_clipped(params, stacked_updates, grad_tree, cfg):
    return _contextual_robust(params, stacked_updates, grad_tree, cfg,
                              _robust_cfg(cfg, _CLIP_ONLY))


def aggregate_contextual_mom(params, stacked_updates, grad_tree, cfg):
    return _contextual_robust(params, stacked_updates, grad_tree, cfg,
                              _robust_cfg(cfg, _CLIP_MOM))


aggregate_contextual_clipped.grad_stack = True
aggregate_contextual_mom.grad_stack = True


def aggregate_krum(params, stacked_updates, grad_tree, cfg):
    """Multi-Krum from G only: score_i = Σ of the K−f−2 smallest squared
    distances to other updates; average the K−f lowest-scoring clients
    (a stable sort, so ties keep ``jnp.argsort``'s order)."""
    rob = _robust_cfg(cfg, RobustConfig())
    U = _stacked_to_matrix(stacked_updates, cfg.gram_scope)
    K = U.shape[0]
    f = rob.krum_f if rob.krum_f is not None else max(1, -(-K // 5))
    f = min(f, max(K - 3, 0))
    nb = max(1, K - f - 2)
    m_sel = max(1, K - f)
    G, _ = gram_and_cross(U, torch.zeros_like(U[0]))
    d = torch.diagonal(G)
    D2 = torch.clamp(d[:, None] + d[None, :] - 2.0 * G, min=0.0)
    # the self-distance is exactly 0 and always the row minimum, so the
    # nb nearest *other* neighbours are sort positions 1..nb
    scores = torch.sort(D2, dim=1).values[:, 1:nb + 1].sum(dim=1)
    sel = torch.argsort(scores, stable=True)[:m_sel]
    alpha = torch.zeros((K,), dtype=torch.float32, device=U.device)
    alpha[sel] = 1.0 / m_sel
    new = _combine(params, stacked_updates, alpha,
                   U if cfg.gram_scope is None else None)
    return new, {"alpha": alpha, "krum_scores": scores, "krum_f": f}


def aggregate_coordinate_median(params, stacked_updates, grad_tree, cfg):
    """Coordinate-wise median of the stacked updates (applied full-width:
    a median is not a weighted row sum, so gram_scope does not apply),
    added through the combine with weight 1."""
    U = _stacked_to_matrix(stacked_updates, None)
    med = median(U, 0)
    one = torch.ones((1,), dtype=torch.float32, device=U.device)
    new = _combine(params, None, one, med[None])
    K = U.shape[0]
    return new, {"alpha": torch.full((K,), 1.0 / K, dtype=torch.float32,
                                     device=U.device)}


register_aggregator("contextual_clipped", aggregate_contextual_clipped)
register_aggregator("contextual_mom", aggregate_contextual_mom)
register_aggregator("krum", aggregate_krum)
register_aggregator("coordinate_median", aggregate_coordinate_median)
