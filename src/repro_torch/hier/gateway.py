"""Tier-local contextual aggregation producing composable Gram summaries
(``repro.hier.gateway``).

A gateway holding K_g member updates runs the paper's contextual solve on
its own cohort — ``G_g = U_g U_gᵀ``, ``c_g = U_g ĝ_g``, stationary ``α_g`` —
and emits a :class:`GatewaySummary` ``(G_g, c_g, α_g, ū_g = Σ_k α_gk Δ_k,
ĝ_g, count)``.  A parent tier treats the children's ū as its member updates
and runs the same solve one level up, with Σγ = 1 (:func:`merge_summaries`).

These tree-level functions are the reference the tests hold the runtime's
engine (``repro_torch.hier.fused``) against; the Gram reductions go through
``kernels.ops.gram_and_cross`` (the ``gram`` kernel on the card).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.aggregation import _stacked_to_matrix
from ..core.flatten import (scope_vector, stacked_weighted_sum, tree_leaves,
                            tree_map)
from ..core.gram import gram_residual
from ..core.solve import (SolveConfig, bound_value, solve_alpha,
                          theorem1_reduction)
from ..kernels.ops import gram_and_cross

Tree = Any


@dataclass
class GatewaySummary:
    """What one aggregation node ships to its parent (see
    ``comm.summary_bytes``)."""
    node_id: int
    num_updates: int               # devices under this summary (all tiers below)
    member_ids: np.ndarray         # immediate children that contributed
    G: torch.Tensor                # (K_g, K_g) tier-local Gram block
    c: torch.Tensor                # (K_g,) tier-local cross term
    alpha: torch.Tensor            # (K_g,) tier-local solve weights
    u_bar: Tree                    # Σ_k α_k Δ_k (a tree, or a flat vector
                                   # in the engine)
    grad_est: Tree                 # this subtree's ∇f estimate
    info: Dict[str, torch.Tensor]


@dataclass
class CompressedSummary:
    """A :class:`GatewaySummary` as it rides a compressed uplink: ``summary``
    holds the decoded ū_g / ĝ_g, which every downstream solve uses, and
    ``comp_u`` / ``comp_g`` the payloads that crossed the wire."""
    summary: GatewaySummary
    comp_u: Any                    # repro_torch.compress.Compressed
    comp_g: Any


def _stack_trees(trees: Sequence[Tree]) -> Tree:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def weighted_mean_trees(trees: Sequence[Tree], weights: np.ndarray) -> Tree:
    """Count-weighted mean of trees — how subtree gradient estimates compose
    up the tree."""
    w = np.asarray(weights, np.float64)
    w = w / max(float(w.sum()), 1e-12)
    return tree_map(lambda *xs: sum(float(wi) * x for wi, x in zip(w, xs)),
                    *trees)


def solve_diagnostics(G: torch.Tensor, c: torch.Tensor, alpha: torch.Tensor,
                      beta) -> Dict[str, torch.Tensor]:
    """The contextual-solve info keys every tier reports."""
    return {
        "bound": bound_value(G, c, alpha, beta),
        "theorem1_reduction": theorem1_reduction(G, alpha, beta),
        "stationarity_residual": torch.linalg.vector_norm(
            gram_residual(G, c, alpha, beta)),
    }


def tier_contextual(stacked_updates: Tree, grad_tree: Tree,
                    solve_cfg: SolveConfig, gram_scope: Optional[str] = None
                    ) -> Tuple[Tree, torch.Tensor, torch.Tensor, torch.Tensor,
                               Dict[str, torch.Tensor]]:
    """One tier's contextual solve: ``(ū, α, G, c, info)`` from stacked
    member updates and the tier's gradient estimate."""
    U = _stacked_to_matrix(stacked_updates, gram_scope)
    g = scope_vector(grad_tree, gram_scope)
    G, c = gram_and_cross(U.contiguous(), g.contiguous())
    alpha = solve_alpha(G, c, solve_cfg)
    u_bar = stacked_weighted_sum(stacked_updates, alpha)
    return u_bar, alpha, G, c, solve_diagnostics(G, c, alpha, solve_cfg.beta)


def tier_mean(stacked_updates: Tree, counts: np.ndarray
              ) -> Tuple[Tree, torch.Tensor]:
    """Count-weighted mean — the hier-FedAvg tier rule (composes to exactly
    flat FedAvg over all participants)."""
    dev = tree_leaves(stacked_updates)[0].device
    w = torch.as_tensor(np.asarray(counts), dtype=torch.float32, device=dev)
    w = w / w.sum().clamp(min=1e-12)
    return stacked_weighted_sum(stacked_updates, w), w


def summarize_updates(node_id: int, member_ids: Sequence[int],
                      updates: Sequence[Tree], grads: Sequence[Tree],
                      counts: Sequence[int], solve_cfg: SolveConfig,
                      mode: str = "contextual",
                      gram_scope: Optional[str] = None,
                      solve_grad: Optional[Tree] = None,
                      pool_size: Optional[int] = None) -> GatewaySummary:
    """Aggregate one node's member updates into its upstream summary.

    ``updates[i]`` is member i's update (a raw device Δ at tier 1, a child's
    ū above), ``grads[i]`` its subtree gradient estimate, ``counts[i]`` the
    devices it speaks for.  ``mode``: "contextual" or "mean".
    ``solve_grad`` replaces the subtree's own ĝ in the c-term (the global
    pre-pass).  ``pool_size`` applies the §III-C expected-bound scale
    (N−1)/(K−1) to a fan-in-sampled contextual cohort."""
    if not updates:
        raise ValueError(f"node {node_id}: cannot summarize zero updates")
    counts = np.asarray(counts, np.int64)
    stacked = _stack_trees(updates)
    grad_est = weighted_mean_trees(grads, counts)
    if pool_size is not None and pool_size < len(updates):
        raise ValueError(f"node {node_id}: pool_size {pool_size} smaller "
                         f"than the cohort ({len(updates)})")
    if mode == "contextual" and pool_size is not None:
        scale = (pool_size - 1) / max(len(updates) - 1, 1)
        solve_cfg = replace(
            solve_cfg, expectation_scale=solve_cfg.expectation_scale * scale)
    if mode == "contextual":
        u_bar, alpha, G, c, info = tier_contextual(
            stacked, grad_est if solve_grad is None else solve_grad,
            solve_cfg, gram_scope)
    elif mode == "mean":
        u_bar, alpha = tier_mean(stacked, counts)
        U = _stacked_to_matrix(stacked, gram_scope)
        G, c = gram_and_cross(U.contiguous(),
                              scope_vector(grad_est, gram_scope).contiguous())
        info = {"bound": bound_value(G, c, alpha, solve_cfg.beta)}
    else:
        raise KeyError(f"unknown tier mode '{mode}' (contextual|mean)")
    return GatewaySummary(
        node_id=node_id, num_updates=int(counts.sum()),
        member_ids=np.asarray(list(member_ids), np.int64),
        G=G, c=c, alpha=alpha, u_bar=u_bar, grad_est=grad_est, info=info)


def merge_summaries(node_id: int, children: Sequence[GatewaySummary],
                    solve_cfg: SolveConfig, mode: str = "contextual",
                    gram_scope: Optional[str] = None,
                    solve_grad: Optional[Tree] = None) -> GatewaySummary:
    """Compose child summaries one tier up: the children's ū become this
    node's members, under the mass-conserving Σγ = 1 solve."""
    return summarize_updates(
        node_id, [s.node_id for s in children],
        [s.u_bar for s in children], [s.grad_est for s in children],
        [s.num_updates for s in children],
        replace(solve_cfg, sum_to=1.0), mode, gram_scope, solve_grad)
