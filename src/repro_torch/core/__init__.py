"""Core contextual-aggregation library of the port (``repro.core``).

  * flatten     — tree/vector conversion (jax.tree_util leaf order) and
                  last-layer scoping
  * gram        — dense (G, c) reference and the stationarity residual
  * solve       — optimal α (context-dependent and expected bounds)
  * aggregation — strategy registry (fedavg/fedprox/weighted/folb/contextual/…)
"""
from .aggregation import (AggregatorConfig, aggregate, aggregate_contextual,
                          aggregate_contextual_expected, aggregate_fedavg,
                          aggregate_folb, available_aggregators,
                          register_aggregator)
from .flatten import (scope_vector, select_scope, stacked_weighted_sum,
                      tree_add, tree_leaves, tree_map, tree_size,
                      tree_to_vector, tree_unflatten, vector_to_tree)
from .gram import gram_and_cross, gram_residual
from .solve import SolveConfig, bound_value, solve_alpha, theorem1_reduction

__all__ = [
    "AggregatorConfig", "aggregate", "aggregate_contextual",
    "aggregate_contextual_expected", "aggregate_fedavg", "aggregate_folb",
    "available_aggregators", "register_aggregator",
    "scope_vector", "select_scope", "stacked_weighted_sum", "tree_add",
    "tree_leaves", "tree_map", "tree_size", "tree_to_vector",
    "tree_unflatten", "vector_to_tree", "gram_and_cross", "gram_residual",
    "SolveConfig", "bound_value", "solve_alpha", "theorem1_reduction",
]
