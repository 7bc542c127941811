"""Server-side model aggregation strategies (``repro.core.aggregation``).

All strategies share one signature and act on *stacked* update trees (every
leaf has a leading K axis — the round's participating devices):

    new_params, info = aggregate(name)(params, stacked_updates, grad_tree, cfg)

Implemented: ``fedavg`` (uniform), ``fedprox`` (FedAvg server side),
``weighted`` (p_k weights via ``cfg.client_weights``), ``folb``
(inner-product weighting), ``contextual`` (the paper's optimal
context-dependent bound, Alg. 2) and ``contextual_expected`` (§III-C).

Every strategy applies its weights the same way: the parameters and the
full stacked update are flattened to ``w (n,)`` and ``U (K, n)`` and go
through ``kernels.ops.weighted_combine`` (w + Σ α_k U_k), then back to a
tree.  The contextual strategies take (G, c) from
``kernels.ops.gram_and_cross``.  So on the card every round launches the
``combine`` kernel and every contextual round the ``gram`` kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..kernels.ops import gram_and_cross, weighted_combine
from .flatten import (scope_vector, select_scope, tree_leaves,
                      tree_to_vector, vector_to_tree)
from .gram import gram_residual
from .solve import SolveConfig, bound_value, solve_alpha, theorem1_reduction

Tree = Any
Info = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AggregatorConfig:
    name: str = "contextual"
    solve: SolveConfig = field(default_factory=SolveConfig)
    # §III-B "Note on efficiency": α from a scoped slice ("last_layer"),
    # applied to the full update
    gram_scope: Optional[str] = None
    # client weights p_k = |D_k|/|D| for the weighted baseline
    client_weights: Optional[Any] = None
    # per-update staleness discounts s_k ∈ (0, 1] of an async runtime
    staleness: Optional[torch.Tensor] = None
    # precomputed (G, c) for the contextual solve (the combine still applies
    # the stacked updates)
    gram_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    # robustness knobs of robust aggregators (typed opaquely)
    robust: Optional[Any] = None


def _stacked_to_matrix(stacked: Tree, scope: Optional[str]) -> torch.Tensor:
    """Flatten stacked updates (leading K axis per leaf) to U (K, n_scope) f32."""
    leaves = [l for l in tree_leaves(select_scope(stacked, scope))
              if l.numel() > 0]
    K = leaves[0].shape[0]
    return torch.cat([l.reshape(K, -1).float() for l in leaves], dim=1)


def _num_clients(stacked: Tree) -> int:
    return tree_leaves(stacked)[0].shape[0]


def _combine(params: Tree, stacked: Tree, alpha: torch.Tensor,
             U_full: Optional[torch.Tensor] = None) -> Tree:
    """params + Σ α_k Δ_k through the flat combine kernel."""
    if U_full is None:
        U_full = _stacked_to_matrix(stacked, None)
    new_vec = weighted_combine(tree_to_vector(params), U_full,
                               alpha.float().contiguous())
    return vector_to_tree(new_vec, params)


def aggregate_fedavg(params: Tree, stacked_updates: Tree,
                     grad_tree: Optional[Tree], cfg: AggregatorConfig
                     ) -> Tuple[Tree, Info]:
    K = _num_clients(stacked_updates)
    dev = tree_leaves(params)[0].device
    if cfg.client_weights is not None:
        cw = torch.as_tensor(cfg.client_weights, dtype=torch.float32,
                             device=dev)
        w = cw / cw.sum()
    else:
        w = torch.full((K,), 1.0 / K, dtype=torch.float32, device=dev)
    return _combine(params, stacked_updates, w), {"alpha": w}


def aggregate_folb(params: Tree, stacked_updates: Tree, grad_tree: Tree,
                   cfg: AggregatorConfig) -> Tuple[Tree, Info]:
    """FOLB: weight each update by the (normalised) inner product between
    its implied local gradient and the global-gradient estimate; updates
    that oppose ∇f receive negative weight."""
    U = _stacked_to_matrix(stacked_updates, cfg.gram_scope)
    g = scope_vector(grad_tree, cfg.gram_scope)
    s = -(U @ g)                      # Δ_k ≈ −lr·∇F_k ⇒ alignment ⟨−Δ_k, g⟩
    alpha = s / s.abs().sum().clamp(min=1e-12)
    U_full = U if cfg.gram_scope is None else None
    return (_combine(params, stacked_updates, alpha, U_full),
            {"alpha": alpha, "alignment": s})


def aggregate_contextual(params: Tree, stacked_updates: Tree, grad_tree: Tree,
                         cfg: AggregatorConfig) -> Tuple[Tree, Info]:
    """Paper Algorithm 2 via the K×K normal equations."""
    U_full = None
    if cfg.gram_override is not None:
        G, c = cfg.gram_override
    else:
        U = _stacked_to_matrix(stacked_updates, cfg.gram_scope)
        g = scope_vector(grad_tree, cfg.gram_scope)
        G, c = gram_and_cross(U, g)
        if cfg.gram_scope is None:
            U_full = U
    alpha = solve_alpha(G, c, cfg.solve)
    new = _combine(params, stacked_updates, alpha, U_full)
    beta = cfg.solve.beta
    info = {
        "alpha": alpha,
        "bound": bound_value(G, c, alpha, beta),
        "theorem1_reduction": theorem1_reduction(G, alpha, beta),
        "stationarity_residual": torch.linalg.vector_norm(
            gram_residual(G, c, alpha, beta)),
        "gram_diag": torch.diagonal(G),
    }
    return new, info


def aggregate_contextual_expected(params: Tree, stacked_updates: Tree,
                                  grad_tree: Tree, cfg: AggregatorConfig,
                                  pool_size: Optional[int] = None
                                  ) -> Tuple[Tree, Info]:
    """§III-C: the contextual solve scaled by (N−1)/(K−1); ``pool_size`` is
    N (or the sampled pool N')."""
    K = _num_clients(stacked_updates)
    N = pool_size if pool_size is not None else K
    scale = (N - 1) / max(K - 1, 1)
    cfg2 = replace(cfg, name="contextual",
                   solve=replace(cfg.solve, expectation_scale=scale))
    return aggregate_contextual(params, stacked_updates, grad_tree, cfg2)


_REGISTRY: Dict[str, Callable] = {
    "fedavg": aggregate_fedavg,
    "fedprox": aggregate_fedavg,     # FedProx differs client-side only
    "weighted": aggregate_fedavg,    # weights via cfg.client_weights
    "folb": aggregate_folb,
    "contextual": aggregate_contextual,
    "contextual_expected": aggregate_contextual_expected,
}


def register_aggregator(name: str, fn: Callable, *,
                        overwrite: bool = False) -> None:
    """Register an aggregation strategy under ``name``."""
    if name in _REGISTRY and not overwrite:
        raise KeyError(f"aggregator '{name}' already registered")
    _REGISTRY[name] = fn


def aggregate(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"unknown aggregator '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_aggregators() -> Sequence[str]:
    return tuple(sorted(_REGISTRY))
