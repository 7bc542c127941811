"""Edge runtime pieces of the port (``repro.edge``): device profiles and
fleets, the deterministic event scheduler, and virtual wall-clock
accounting.  ``async_server`` and ``run_async_simulation`` belong to a later
slice.

  * profiles  — per-device compute/network/dropout profiles + canonical
                fleets (uniform / bimodal phone+gateway / long-tail)
  * events    — deterministic heap-of-events virtual-time scheduler with the
                v1 (sequential) and v2 (counter-based) RNG streams
  * wallclock — rounds-to-accuracy → virtual-time-to-accuracy conversion
"""
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

__all__ = [
    "BatchDispatch", "Event", "EventKind", "EventScheduler", "SchedulerStats",
    "ArrayFleet", "DeviceProfile", "Fleet", "array_bimodal_fleet",
    "array_longtail_fleet", "array_uniform_fleet", "as_array_fleet",
    "bimodal_fleet", "fleet_arrays", "get_array_fleet", "get_fleet",
    "longtail_fleet", "uniform_fleet", "WallclockCurve", "model_flops_per_step",
    "model_payload_bytes", "sync_round_durations", "sync_wallclock_curve",
]
