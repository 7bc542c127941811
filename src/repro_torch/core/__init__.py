"""Core contextual-aggregation library of the port (``repro.core``).

  * flatten     — tree/vector conversion (jax.tree_util leaf order),
                  last-layer scoping, and the streamed engine's leaf-slab
                  view (``ChunkedFlatView``, ``mix_rows``)
  * gram        — dense and chunked (G, c), Gram blocks and their merge,
                  and the stationarity residual
  * solve       — optimal α (context-dependent and expected bounds)
  * aggregation — strategy registry (fedavg/fedprox/weighted/folb/contextual/…)
"""
from .aggregation import (AggregatorConfig, aggregate, aggregate_contextual,
                          aggregate_contextual_expected, aggregate_fedavg,
                          aggregate_folb, available_aggregators,
                          register_aggregator)
from .flatten import (ChunkedFlatView, LeafSlab, mix_rows, scope_vector,
                      select_scope, stacked_weighted_sum, tree_add,
                      tree_leaves, tree_map, tree_size, tree_to_vector,
                      tree_unflatten, vector_to_tree)
from .gram import (blockwise_gram_and_cross, gram_and_cross,
                   gram_and_cross_chunked, gram_block, gram_block_chunked,
                   gram_residual, merge_gram_blocks)
from .solve import (SolveConfig, bound_value, solve_alpha, solve_alpha_simple,
                    theorem1_reduction)

__all__ = [
    "AggregatorConfig", "aggregate", "aggregate_contextual",
    "aggregate_contextual_expected", "aggregate_fedavg", "aggregate_folb",
    "available_aggregators", "register_aggregator",
    "ChunkedFlatView", "LeafSlab", "mix_rows",
    "scope_vector", "select_scope", "stacked_weighted_sum", "tree_add",
    "tree_leaves", "tree_map", "tree_size", "tree_to_vector",
    "tree_unflatten", "vector_to_tree",
    "blockwise_gram_and_cross", "gram_and_cross", "gram_and_cross_chunked",
    "gram_block", "gram_block_chunked", "gram_residual", "merge_gram_blocks",
    "SolveConfig", "bound_value", "solve_alpha", "solve_alpha_simple",
    "theorem1_reduction",
]
