"""Sharding rules of the port (``repro.sharding``)."""
from .specs import (FSDP_THRESHOLD, NamedSharding, PartitionSpec,
                    batch_pspec, cache_pspecs, fleet_mesh, named,
                    param_pspecs, shard_cohort_fn, spec_for_leaf,
                    stream_column_shardings, stream_round_shardings)

__all__ = ["FSDP_THRESHOLD", "NamedSharding", "PartitionSpec", "batch_pspec",
           "cache_pspecs", "fleet_mesh", "named", "param_pspecs",
           "shard_cohort_fn", "spec_for_leaf", "stream_column_shardings",
           "stream_round_shardings"]
