"""Per-tier traffic accounting for hierarchical aggregation.

The whole point of the hierarchy is the uplink: a gateway that forwards its
K_g raw updates costs the backhaul ``K_g·n`` floats per round, while a
contextual summary costs ``2n + K_g² + 2K_g`` (combined update ū_g, local
gradient estimate ĝ_g, Gram block G_g, cross term c_g, tier weights α_g) —
for n ≫ K² that is
a ~K_g/2× reduction *per gateway*, i.e. fleet-wide cloud-uplink shrinks from
O(K·n) to O(P·n).  :class:`CommLedger` records every transfer by tier so
examples/benchmarks can report the measured ratio instead of the formula.

Byte conventions follow ``repro.edge.wallclock``: float32 on the wire, the
model payload is ``4·|w|`` bytes, and a device upload is the update only (the
first-step gradient rides along inside the same payload in the K₂=0 scheme,
exactly as the PR-1 async accounting assumes).

This module is a copy of ``repro.hier.comm`` (numpy and the port's own
modules only), kept so the port never imports the JAX package; its
output is bit-identical (``tests/test_torch_edge.py``,
``tests/test_torch_hier.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..core.flatten import tree_size
from ..obs import Tracker, record_span

FLOAT_BYTES = 4.0


def update_bytes(n: int) -> float:
    """One raw update (or one model broadcast): n float32."""
    return FLOAT_BYTES * n


def summary_bytes(k: int, n: int, include_grad: bool = False) -> float:
    """One gateway summary: ū_g (n) + G_g (k²) + c_g (k) + α_g (k) + counts;
    with ``include_grad`` the subtree gradient estimate ĝ_g (n) rides inside
    the summary instead of travelling in the gradient pre-pass (the per-round
    uplink total is identical either way — 2n + k² + 2k — the pre-pass only
    reorders it so the solve can use the *global* ĝ)."""
    return FLOAT_BYTES * ((2 if include_grad else 1) * n + k * k + 2 * k + 2)


def compressed_summary_bytes(payload_bytes: float) -> float:
    """One *compressed* gateway summary (``repro.compress``): the ū_g / ĝ_g
    payloads ride at their serialized sketch/top-k/low-rank size instead of
    2n floats, plus the device count and node id.  The K_g² Gram block, the
    cross term and the tier weights α_g all stay at the gateway — the parent
    solve needs only (ū, ĝ, counts); everything else ever only backed
    cloud-side diagnostics.  ``payload_bytes`` is the summed
    ``Compressed.nbytes`` of the two payloads — the ledger records true
    serialized sizes, not a formula (tested)."""
    return payload_bytes + FLOAT_BYTES * 2


def model_size(params) -> int:
    return tree_size(params)


@dataclass
class TierTraffic:
    """Aggregate traffic crossing into one tier (child → parent direction is
    ``up``; parent → child is ``down``)."""
    bytes_up: float = 0.0
    bytes_down: float = 0.0
    transfers_up: int = 0
    transfers_down: int = 0
    link_seconds: float = 0.0      # summed transfer durations (not wall-clock)


class CommLedger:
    """Accumulates per-tier traffic over a simulation.

    Tier t records transfers whose *receiver* sits on tier t — so the cloud
    tier's ``bytes_up`` is exactly the cloud-uplink volume the acceptance
    criterion bounds.

    With a ``tracker`` (``repro.obs``), every transfer is ALSO streamed the
    moment it is recorded — one event per record call with the tier,
    direction, bytes, link seconds and (when a ``clock`` callable is given,
    normally the event scheduler's ``lambda: scheduler.now``) the virtual
    timestamp — so long runs expose their traffic live instead of only in
    the end-of-run :meth:`report`.  Timed transfers additionally emit a
    virtual-time ``link/up``/``link/down`` span (``repro.obs.spans``) so
    link occupancy shows on the Perfetto virtual track.  A noop/absent
    tracker costs one attribute check per record.
    """

    def __init__(self, depth: int, tracker: Optional[Tracker] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.depth = depth
        self.tiers: Dict[int, TierTraffic] = {
            t: TierTraffic() for t in range(depth + 1)}
        self._tracker = tracker
        self._clock = clock

    def _stream(self, tier: int, direction: str, nbytes: float,
                seconds: float, count: int = 1) -> None:
        event = {"tier": tier, "dir": direction, "bytes": nbytes,
                 "link_seconds": seconds}
        if count != 1:
            event["count"] = count
        if self._clock is not None:
            now = self._clock()
            event["t_virtual"] = now
            if seconds > 0:
                # the transfer's whole virtual interval is known at record
                # time: emit it as one span so link occupancy lands on the
                # virtual track next to the round/stage spans
                record_span(f"link/{direction}", t0_virtual=now,
                            dur_virtual_s=seconds, tier=tier, bytes=nbytes)
        self._tracker.log(event)

    def record_up(self, tier: int, nbytes: float, seconds: float = 0.0,
                  count: int = 1) -> None:
        """Record ``count`` identical transfers in one call (the fleet-scale
        cohort path accounts a whole tier's device traffic at once; totals
        equal ``count`` single-record calls, streamed as one event carrying
        the summed bytes)."""
        if count == 0:
            return
        tt = self.tiers[tier]
        tt.bytes_up += nbytes * count
        tt.transfers_up += count
        tt.link_seconds += seconds * count
        if self._tracker is not None and self._tracker.active:
            self._stream(tier, "up", nbytes * count, seconds * count, count)

    def record_down(self, tier: int, nbytes: float, seconds: float = 0.0,
                    count: int = 1) -> None:
        if count == 0:
            return
        tt = self.tiers[tier]
        tt.bytes_down += nbytes * count
        tt.transfers_down += count
        tt.link_seconds += seconds * count
        if self._tracker is not None and self._tracker.active:
            self._stream(tier, "down", nbytes * count, seconds * count, count)

    @property
    def cloud_uplink_bytes(self) -> float:
        return self.tiers[self.depth].bytes_up

    def total_bytes(self) -> float:
        return sum(t.bytes_up + t.bytes_down for t in self.tiers.values())

    def savings_vs(self, flat_cloud_uplink_bytes: float) -> Optional[float]:
        """How many × fewer cloud-uplink bytes than a flat run that moved
        ``flat_cloud_uplink_bytes``; None until something was recorded."""
        if self.cloud_uplink_bytes <= 0:
            return None
        return flat_cloud_uplink_bytes / self.cloud_uplink_bytes

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            f"tier_{t}": {
                "bytes_up": tt.bytes_up, "bytes_down": tt.bytes_down,
                "transfers_up": tt.transfers_up,
                "transfers_down": tt.transfers_down,
                "link_seconds": round(tt.link_seconds, 6),
            } for t, tt in sorted(self.tiers.items())
        }
