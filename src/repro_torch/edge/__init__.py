"""Edge runtime of the port (``repro.edge``): event-driven device simulation
and staleness-aware contextual aggregation.

  * profiles     — per-device compute/network/dropout profiles + canonical
                   fleets (uniform / bimodal phone+gateway / long-tail)
  * events       — deterministic heap-of-events virtual-time scheduler with
                   the v1 (sequential) and v2 (counter-based) RNG streams
  * async_server — buffered async aggregation (contextual_async / fedbuff /
                   fedasync, registered in ``core.aggregation``)
  * wallclock    — rounds-to-accuracy → virtual-time-to-accuracy conversion

The entry point is :func:`run_async_simulation` (from
``repro_torch.fl.simulation``, re-exported here), which drives these against
the same datasets and metrics as the synchronous path.
"""
from .async_server import (AsyncBuffer, AsyncConfig, BufferedUpdate,
                           aggregate_contextual_async, aggregate_fedbuff,
                           staleness_weight)
from .events import (BatchDispatch, Event, EventKind, EventScheduler,
                     SchedulerStats)
from .profiles import (ArrayFleet, DeviceProfile, Fleet, array_bimodal_fleet,
                       array_longtail_fleet, array_uniform_fleet,
                       as_array_fleet, bimodal_fleet, fleet_arrays,
                       get_array_fleet, get_fleet, longtail_fleet,
                       uniform_fleet)
from .wallclock import (WallclockCurve, model_flops_per_step,
                        model_payload_bytes, sync_round_durations,
                        sync_wallclock_curve)
from ..fl.simulation import AsyncSimulationResult, run_async_simulation

__all__ = [
    "AsyncBuffer", "AsyncConfig", "BufferedUpdate",
    "aggregate_contextual_async", "aggregate_fedbuff", "staleness_weight",
    "BatchDispatch", "Event", "EventKind", "EventScheduler", "SchedulerStats",
    "ArrayFleet", "DeviceProfile", "Fleet", "array_bimodal_fleet",
    "array_longtail_fleet", "array_uniform_fleet", "as_array_fleet",
    "bimodal_fleet", "fleet_arrays", "get_array_fleet", "get_fleet",
    "longtail_fleet", "uniform_fleet", "WallclockCurve", "model_flops_per_step",
    "model_payload_bytes", "sync_round_durations", "sync_wallclock_curve",
    "AsyncSimulationResult", "run_async_simulation",
]
