"""Hierarchical contextual aggregation over multi-tier edge topologies
(``repro.hier``), in PyTorch.

  * topology    — device→gateway→regional→cloud trees over ``edge.Fleet``
                  profiles (star, two-tier, geo-partitioned)
  * gateway     — tier-local contextual solves emitting composable
                  (G_g, c_g, α_g, ū_g, ĝ_g) summaries (the reference
                  functions)
  * hier_server — ``HierConfig``, the cloud stage and the four hier
                  aggregators registered in ``core.aggregation``
  * comm        — per-tier byte/latency ledger
  * fused       — the round engine over dense (P, n) round matrices, with
                  every Gram reduction through the ``gram`` kernel
  * streamed    — the big-model round engine: (P, P) statistics from the
                  ``stream_stats`` kernel per leaf slab, P-space tier
                  stages, and the apply through the ``combine`` kernel

The entry point is :func:`repro_torch.fl.run_hier_simulation`.
"""
from .comm import (CommLedger, TierTraffic, compressed_summary_bytes,
                   model_size, summary_bytes, update_bytes)
from .fused import FusedRoundContext, HierRoundEngine
from .gateway import (CompressedSummary, GatewaySummary, merge_summaries,
                      summarize_updates, tier_contextual, tier_mean)
from .hier_server import (HierConfig, aggregate_hier_contextual,
                          aggregate_hier_contextual_sketch,
                          aggregate_hier_fedavg, blockdiag_diagnostics,
                          cloud_aggregate)
from .streamed import (RowMix, StreamedRoundContext, StreamedRoundEngine,
                       dense_round_bytes)
from .topology import (Link, StackedTopology, TopoNode, Topology,
                       geo_partitioned_topology, get_topology, stacked_two_tier,
                       star_topology, two_tier_topology)

__all__ = [
    "CommLedger", "TierTraffic", "compressed_summary_bytes", "model_size",
    "summary_bytes", "update_bytes",
    "FusedRoundContext", "HierRoundEngine",
    "CompressedSummary", "GatewaySummary", "merge_summaries",
    "summarize_updates", "tier_contextual", "tier_mean",
    "HierConfig", "aggregate_hier_contextual",
    "aggregate_hier_contextual_sketch", "aggregate_hier_fedavg",
    "blockdiag_diagnostics", "cloud_aggregate",
    "RowMix", "StreamedRoundContext", "StreamedRoundEngine",
    "dense_round_bytes",
    "Link", "StackedTopology", "TopoNode", "Topology",
    "geo_partitioned_topology", "get_topology", "stacked_two_tier",
    "star_topology", "two_tier_topology",
]
