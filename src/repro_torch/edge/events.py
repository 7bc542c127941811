"""Deterministic event-driven scheduler for the async edge runtime.

The scheduler owns a virtual clock and a binary heap of pending events.  It
knows nothing about models or aggregation — it turns *dispatches* (server
hands a device a training task at virtual time t) into timed *arrivals*
(the update reaches the server) or *dropouts* (the device dies mid-task),
using each device's :class:`~repro.edge.profiles.DeviceProfile`.

Determinism contract (tested by ``tests/test_edge_runtime.py``):

  * all randomness (duration jitter, dropout coin flips, epoch draws) comes
    from one ``np.random.RandomState(seed)``, consumed in dispatch order;
  * heap ties at equal virtual time break on a monotone sequence number, so
    event order is a pure function of (fleet, seed, dispatch sequence);
  * every dispatch produces exactly one terminal event (ARRIVAL xor DROPOUT):
    updates are never lost or duplicated, only late.

RNG streams.  The legacy ``rng_stream="v1"`` contract above draws a
*variable* number of scalars per dispatch (the jitter normal only when the
profile has jitter, the death fraction only on dropout) from one Mersenne
Twister — bit-faithful vectorization of that stream is impossible, so
:meth:`EventScheduler.dispatch_batch` under v1 replays the per-task scalar
draws in dispatch order (same trace as N ``dispatch()`` calls, still one
heapify).  ``rng_stream="v2"`` is the *documented fleet-scale stream*: every
task's draws are a pure counter-based hash of ``(seed, task seq)`` (murmur3
finalizer, the PR-4 ``rng_sketch`` idiom), so a whole cohort's durations and
dropout coins vectorize into one numpy pass and per-device ``dispatch()``
produces bit-identical traces to ``dispatch_batch`` (both tested).  v1 and
v2 are different (equally valid) random universes; pick per run, never mix.

This module is a copy of ``repro.edge.events`` (numpy and the port's own
modules only), kept so the port never imports the JAX package; its
output is bit-identical (``tests/test_torch_edge.py``,
``tests/test_torch_hier.py``).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional

import numpy as np

from ..obs import spans
from .profiles import Fleet, fleet_arrays


# -- counter-based draws (rng_stream="v2") ----------------------------------
# murmur3 finalizer over (seed, task seq, field): the same integer mixing the
# rng_sketch kernels use, evaluated in numpy so a million-task cohort is one
# vectorized pass and a scalar dispatch is the B=1 special case of it.

def _mix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32, copy=True)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def _stream_uniform(seed: int, seqs: np.ndarray, fieldno: int) -> np.ndarray:
    """One U(0,1) per task seq for one draw field (0/1: jitter Box-Muller
    pair, 2: dropout coin, 3: death fraction).  (h+0.5)·2⁻³² keeps the
    uniforms strictly inside (0, 1) so log() below is always finite."""
    salt = np.uint32((0x9E3779B9 * (fieldno + 1) + seed) & 0xFFFFFFFF)
    h = _mix32(_mix32(np.asarray(seqs, np.uint32)) ^ salt)
    return (h.astype(np.float64) + 0.5) * 2.0 ** -32


class EventKind(IntEnum):
    DISPATCH = 0   # recorded in the trace when the server hands out a task
    ARRIVAL = 1    # the device's update reaches the server
    DROPOUT = 2    # the device died mid-task; its work is lost


@dataclass(frozen=True)
class Event:
    time: float
    seq: int                 # monotone tie-breaker; also a unique task id
    kind: EventKind
    device_id: int
    # metadata the runtime attached at dispatch (step budget, model version …)
    num_steps: int = 0
    version: int = 0


@dataclass
class SchedulerStats:
    dispatched: int = 0            # device tasks handed out
    arrived: int = 0               # device updates that reached their parent
    dropped: int = 0               # device tasks lost mid-flight
    transfers: int = 0             # backhaul link events scheduled
    transfers_done: int = 0        # backhaul link events delivered


@dataclass(frozen=True)
class BatchDispatch:
    """Vectorized view of one :meth:`EventScheduler.dispatch_batch` cohort:
    parallel per-task arrays in dispatch order.  With ``enqueue=False`` no
    per-task :class:`Event` objects exist at all — the caller consumes these
    arrays (terminal times and outcomes are fully determined at dispatch)
    and settles the cohort with :meth:`EventScheduler.complete_batch`."""
    device_ids: np.ndarray       # (B,) int64
    seqs: np.ndarray             # (B,) int64 — the cohort's task ids
    num_steps: np.ndarray        # (B,) int32
    start: np.ndarray            # (B,) float64 dispatch times
    t_end: np.ndarray            # (B,) float64 terminal times
    dropped: np.ndarray          # (B,) bool — True: DROPOUT, else ARRIVAL
    version: int = 0

    @property
    def size(self) -> int:
        return len(self.device_ids)


class EventScheduler:
    """Heap-of-events virtual-time simulator over a device fleet."""

    def __init__(self, fleet: Fleet, seed: int, flops_per_step: float,
                 payload_bytes: float, churn=None, rng_stream: str = "v1"):
        if rng_stream not in ("v1", "v2"):
            raise ValueError(f"unknown rng_stream '{rng_stream}' (v1|v2)")
        self.fleet = fleet
        self.rng = np.random.RandomState(seed)
        self.rng_stream = rng_stream
        self.flops_per_step = float(flops_per_step)
        self.payload_bytes = float(payload_bytes)
        # optional churn schedule (repro.robust.churn duck interface:
        # ``offline(device_id, t) -> bool``): a task dispatched while its
        # device sits inside an active wave terminates as a DROPOUT
        self.churn = churn
        self.now = 0.0
        self.stats = SchedulerStats()
        self.trace: List[Event] = []      # full event log (tests, debugging)
        self._heap: List[Event] = []
        self._next_seq = 0
        self._seed = int(seed)
        self._profile_arrays = None       # lazy (flops, up, down, drop, jit)
        self._batch_inflight = 0          # non-enqueued cohort tasks pending
        self._transfer_seqs: set = set()  # pending link events (not devices)
        # open span handles per in-flight event (repro.obs.spans): a
        # dispatch/schedule opens a FLAT span at the event's virtual start,
        # pop closes it at the terminal virtual time.  Empty (and free)
        # under the default noop tracker — spans.begin returns None there.
        self._spans: Dict[int, object] = {}

    def _take_seq(self) -> int:
        s = self._next_seq
        self._next_seq += 1
        return s

    def _fleet_arrays(self):
        if self._profile_arrays is None:
            self._profile_arrays = fleet_arrays(self.fleet)
        return self._profile_arrays

    def _v2_outcomes(self, device_ids: np.ndarray, seqs: np.ndarray,
                     num_steps: np.ndarray):
        """Vectorized per-task (duration, drops, death fraction) under the
        counter-based v2 stream — the scalar ``dispatch`` path calls this
        with B=1, so batch and per-device dispatch agree bit-for-bit."""
        fl, up, dn, do, ji = self._fleet_arrays()
        ids = np.asarray(device_ids, np.int64)
        t = np.asarray(num_steps, np.float64) * self.flops_per_step / fl[ids]
        sigma = ji[ids]
        if np.any(sigma > 0.0):
            u0 = _stream_uniform(self._seed, seqs, 0)
            u1 = _stream_uniform(self._seed, seqs, 1)
            z = np.sqrt(-2.0 * np.log(u0)) * np.cos(2.0 * np.pi * u1)
            t = np.where(sigma > 0.0, t * np.exp(sigma * z), t)
        duration = t + self.payload_bytes / dn[ids] + self.payload_bytes / up[ids]
        drops = _stream_uniform(self._seed, seqs, 2) < do[ids]
        death = 0.05 + 0.9 * _stream_uniform(self._seed, seqs, 3)
        return duration, drops, death

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, device_id: int, num_steps: int, version: int,
                 at: Optional[float] = None) -> Event:
        """Hand ``device_id`` a task of ``num_steps`` local steps at the
        current virtual time (or at ``at`` ≥ now — the hierarchical runtime
        delays dispatch until the model broadcast reaches the device's
        gateway); schedules its terminal ARRIVAL/DROPOUT event."""
        start = self.now if at is None else at
        if start < self.now - 1e-12:
            raise ValueError(f"cannot dispatch in the past: at={at} < "
                             f"now={self.now}")
        seq = self._take_seq()
        disp = Event(start, seq, EventKind.DISPATCH, device_id,
                     num_steps=num_steps, version=version)
        self.trace.append(disp)
        self.stats.dispatched += 1

        if self.rng_stream == "v2":
            dur, drp, death = self._v2_outcomes(
                np.asarray([device_id]), np.asarray([seq]),
                np.asarray([num_steps]))
            duration, drops = float(dur[0]), bool(drp[0])
            if self.churn is not None and self.churn.offline(device_id, start):
                drops = True
            if drops:
                duration *= float(death[0])
        else:
            prof = self.fleet[device_id]
            duration = prof.task_time(num_steps * self.flops_per_step,
                                      self.payload_bytes, self.rng)
            drops = self.rng.random_sample() < prof.dropout
            # churn overrides the outcome AFTER the profile coin is consumed,
            # so the RNG stream (and with it every non-churned event) is
            # identical to the churn-free run — the determinism contract
            # above holds per (fleet, seed, churn schedule)
            if self.churn is not None and self.churn.offline(device_id, start):
                drops = True
            if drops:
                # die uniformly somewhere inside the task
                duration *= float(self.rng.uniform(0.05, 0.95))
        kind = EventKind.DROPOUT if drops else EventKind.ARRIVAL
        evt = Event(start + duration, seq, kind, device_id,
                    num_steps=num_steps, version=version)
        heapq.heappush(self._heap, (evt.time, evt.seq, evt))
        h = spans.begin("sched/task", t_virtual=start, device=device_id,
                        num_steps=num_steps, version=version)
        if h is not None:
            self._spans[seq] = h
        return evt

    def dispatch_batch(self, device_ids, num_steps, version: int = 0,
                       at=None, enqueue: bool = True) -> BatchDispatch:
        """Dispatch a whole cohort at once: one vectorized draw of durations
        and dropout coins (under ``rng_stream="v2"``; the v1 compat path
        replays the legacy per-task scalar draws in dispatch order, so its
        trace is bit-identical to N ``dispatch()`` calls) and one heapify
        instead of per-device heap pushes.

        ``at`` is an optional per-task (or scalar) dispatch time ≥ now.  With
        ``enqueue=False`` no per-task :class:`Event` objects are created at
        all — the fleet-scale cohort path consumes the returned arrays
        directly (every terminal time/outcome is already determined here) and
        must settle the cohort once via :meth:`complete_batch`; the trace
        records nothing for such cohorts (a million Event objects is exactly
        the O(fleet) cost this path removes)."""
        ids = np.atleast_1d(np.asarray(device_ids, np.int64))
        B = ids.size
        ns = np.broadcast_to(np.asarray(num_steps, np.int32), (B,))
        if at is None:
            start = np.full(B, self.now)
        else:
            start = np.broadcast_to(np.asarray(at, np.float64), (B,)).copy()
            if B and start.min() < self.now - 1e-12:
                raise ValueError(f"cannot dispatch in the past: "
                                 f"min(at)={start.min()} < now={self.now}")
        seq0 = self._next_seq
        self._next_seq += B
        seqs = np.arange(seq0, seq0 + B, dtype=np.int64)

        if self.rng_stream == "v2":
            duration, drops, death = self._v2_outcomes(ids, seqs, ns)
            drops = drops.copy()
            if self.churn is not None:
                if hasattr(self.churn, "offline_mask"):
                    drops |= self.churn.offline_mask(ids, start)
                else:
                    drops |= np.fromiter(
                        (self.churn.offline(int(d), float(s))
                         for d, s in zip(ids, start)), bool, count=B)
            duration = np.where(drops, duration * death, duration)
        else:
            duration = np.empty(B)
            drops = np.empty(B, bool)
            for i in range(B):
                prof = self.fleet[int(ids[i])]
                duration[i] = prof.task_time(
                    int(ns[i]) * self.flops_per_step, self.payload_bytes,
                    self.rng)
                d = self.rng.random_sample() < prof.dropout
                if self.churn is not None and self.churn.offline(
                        int(ids[i]), float(start[i])):
                    d = True
                if d:
                    duration[i] *= float(self.rng.uniform(0.05, 0.95))
                drops[i] = d

        t_end = start + duration
        self.stats.dispatched += B
        batch = BatchDispatch(ids, seqs, ns, start, t_end, drops,
                              version=version)
        if enqueue:
            kinds = np.where(drops, int(EventKind.DROPOUT),
                             int(EventKind.ARRIVAL))
            events = []
            for i in range(B):
                seq = int(seqs[i])
                self.trace.append(Event(float(start[i]), seq,
                                        EventKind.DISPATCH, int(ids[i]),
                                        num_steps=int(ns[i]), version=version))
                evt = Event(float(t_end[i]), seq, EventKind(int(kinds[i])),
                            int(ids[i]), num_steps=int(ns[i]), version=version)
                events.append((evt.time, evt.seq, evt))
                h = spans.begin("sched/task", t_virtual=float(start[i]),
                                device=int(ids[i]), num_steps=int(ns[i]),
                                version=version)
                if h is not None:
                    self._spans[seq] = h
            self._heap.extend(events)
            heapq.heapify(self._heap)
        else:
            self._batch_inflight += B
        return batch

    def advance_to(self, t: float) -> None:
        """Move the virtual clock forward to ``t`` (cohort-mode device phase:
        the caller walks gateway completions in time order without popping
        per-device events)."""
        if t < self.now - 1e-9:
            raise ValueError(f"cannot advance backwards: t={t} < "
                             f"now={self.now}")
        self.now = max(self.now, t)

    def complete_batch(self, batch: BatchDispatch) -> None:
        """Settle a non-enqueued cohort's terminal outcomes in the stats
        (totals identical to popping every per-device event).  Does not touch
        the clock — the caller interleaves :meth:`advance_to` with its own
        per-gateway completion handling."""
        n_drop = int(np.count_nonzero(batch.dropped))
        self.stats.arrived += batch.size - n_drop
        self.stats.dropped += n_drop
        self._batch_inflight -= batch.size
        if self._batch_inflight < 0:
            raise RuntimeError("complete_batch called for an enqueued or "
                               "already-settled cohort")

    def schedule(self, delay: float, node_id: int,
                 kind: EventKind = EventKind.ARRIVAL,
                 num_steps: int = 0, version: int = 0) -> Event:
        """Schedule an arbitrary terminal event ``delay`` after now — the
        hierarchical runtime's multi-hop link transfers (gateway summary →
        regional → cloud).  ``node_id`` may exceed the fleet size: interior
        tree nodes are not devices and consume no fleet profile or RNG draws,
        so scheduling keeps the device event stream deterministic.  Counted
        in ``stats.transfers``/``transfers_done`` — never in the device-task
        dispatched/arrived/dropped counters."""
        if delay < 0:
            raise ValueError(f"delay must be >= 0, got {delay}")
        seq = self._take_seq()
        self.stats.transfers += 1
        self._transfer_seqs.add(seq)
        evt = Event(self.now + delay, seq, kind, node_id,
                    num_steps=num_steps, version=version)
        heapq.heappush(self._heap, (evt.time, evt.seq, evt))
        h = spans.begin("sched/transfer", t_virtual=self.now, node=node_id,
                        version=version)
        if h is not None:
            self._spans[seq] = h
        return evt

    # -- event loop --------------------------------------------------------
    def pending(self) -> int:
        return len(self._heap)

    def pop(self) -> Optional[Event]:
        """Advance the clock to the next terminal event and return it."""
        if not self._heap:
            return None
        _, _, evt = heapq.heappop(self._heap)
        self.now = evt.time
        self.trace.append(evt)
        if evt.seq in self._transfer_seqs:
            self._transfer_seqs.discard(evt.seq)
            self.stats.transfers_done += 1
            outcome = "delivered"
        elif evt.kind == EventKind.ARRIVAL:
            self.stats.arrived += 1
            outcome = "arrival"
        else:
            self.stats.dropped += 1
            outcome = "dropout"
        h = self._spans.pop(evt.seq, None)
        if h is not None:
            spans.end(h, t_virtual=evt.time, outcome=outcome)
        return evt

    # -- invariants (cheap enough to assert in tests) ----------------------
    def conservation_ok(self) -> bool:
        """Every dispatch/transfer is in-flight xor terminal — nothing
        lost/duplicated."""
        return (self.stats.dispatched + self.stats.transfers
                == self.stats.arrived + self.stats.dropped
                + self.stats.transfers_done + self.pending()
                + self._batch_inflight)

    def trace_signature(self) -> List[tuple]:
        """Hashable rendering of the full trace for determinism tests."""
        return [(round(e.time, 9), e.seq, int(e.kind), e.device_id,
                 e.num_steps, e.version) for e in self.trace]
