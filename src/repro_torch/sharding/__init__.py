"""Sharding rules of the port (``repro.sharding``)."""
from .specs import (FSDP_THRESHOLD, NamedSharding, PartitionSpec,
                    batch_pspec, cache_block, cache_pspecs,
                    dim_axes, dropped_axes, fleet_mesh, local_bytes,
                    local_shard, named, param_pspecs, place_batch,
                    place_cache, place_params, shard_cohort_fn, shard_shape,
                    spec_for_leaf, stream_column_shardings,
                    stream_round_shardings)

__all__ = ["FSDP_THRESHOLD", "NamedSharding", "PartitionSpec", "batch_pspec",
           "cache_block", "cache_pspecs", "dim_axes",
           "dropped_axes", "fleet_mesh", "local_bytes",
           "local_shard", "named", "param_pspecs", "place_batch",
           "place_cache", "place_params",
           "shard_cohort_fn", "shard_shape", "spec_for_leaf",
           "stream_column_shardings", "stream_round_shardings"]
