"""Churn waves: time-scheduled mass-dropout and rejoin on the event runtime
(a copy of ``repro.robust.churn``, which uses numpy only).

A :class:`ChurnWave` takes a seeded ``fraction`` of the fleet offline for a
virtual-time window ``[start, end)`` — a regional outage, an OS-update
wave, a diurnal coverage dip.  A :class:`ChurnSchedule` stacks waves and is
plugged into :class:`~repro_torch.edge.events.EventScheduler` (the
``churn=`` constructor argument): any task *dispatched* while its device is
inside an active wave terminates as a DROPOUT.  Availability collapses when
a wave starts and recovers the moment it ends — no persistent state, so
rejoining devices pick up normally on their next dispatch.

Determinism: wave membership is a pure seeded draw
(``np.random.RandomState(wave.seed)``, bit-identical to the reference's);
the scheduler consumes its dropout-coin / duration draws exactly as in the
churn-free run and only *overrides the outcome*, so the full event trace
remains a pure function of (fleet, churn schedule, seed) — the property
the seeded-determinism tests pin on both hier engines.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import FrozenSet, Tuple

import numpy as np


@dataclass(frozen=True)
class ChurnWave:
    start: float                 # virtual seconds, inclusive
    end: float                   # virtual seconds, exclusive
    fraction: float              # of the fleet taken offline
    seed: int = 0                # membership draw

    def __post_init__(self):
        if self.end <= self.start:
            raise ValueError(f"wave end must exceed start, got "
                             f"[{self.start}, {self.end})")
        if not (0.0 < self.fraction <= 1.0):
            raise ValueError(f"wave fraction must be in (0, 1], got "
                             f"{self.fraction}")

    def active(self, t: float) -> bool:
        return self.start <= t < self.end


@lru_cache(maxsize=256)
def _wave_members(wave: ChurnWave, num_devices: int) -> FrozenSet[int]:
    m = int(round(wave.fraction * num_devices))
    if m >= num_devices:
        return frozenset(range(num_devices))
    rng = np.random.RandomState(wave.seed)
    return frozenset(int(i) for i in rng.choice(num_devices, m, replace=False))


@lru_cache(maxsize=256)
def _wave_member_mask(wave: ChurnWave, num_devices: int) -> np.ndarray:
    """Boolean lookup of :func:`_wave_members` (vectorized membership)."""
    mask = np.zeros(num_devices, bool)
    mask[list(_wave_members(wave, num_devices))] = True
    return mask


@dataclass(frozen=True)
class ChurnSchedule:
    """Hashable stack of waves over a fleet of ``num_devices``.  The duck
    interface the scheduler consumes is just :meth:`offline`."""
    num_devices: int
    waves: Tuple[ChurnWave, ...] = field(default_factory=tuple)

    def offline(self, device_id: int, t: float) -> bool:
        return any(w.active(t) and device_id in _wave_members(
            w, self.num_devices) for w in self.waves)

    def offline_mask(self, device_ids: np.ndarray,
                     times: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`offline` over parallel (device, dispatch-time)
        arrays — the batch-dispatch path asks one question per cohort instead
        of one per device.  Same membership draws, same answer element-wise
        (tested against the scalar path)."""
        ids = np.asarray(device_ids, np.int64)
        ts = np.asarray(times, np.float64)
        out = np.zeros(ids.shape, bool)
        for w in self.waves:
            active = (ts >= w.start) & (ts < w.end)
            if not active.any():
                continue
            out |= active & _wave_member_mask(w, self.num_devices)[ids]
        return out

    def members(self, wave_idx: int) -> FrozenSet[int]:
        return _wave_members(self.waves[wave_idx], self.num_devices)


def churn_schedule(profile: str, num_devices: int, t_end: float,
                   seed: int = 0) -> ChurnSchedule:
    """Canonical profiles, parameterized by the run's expected virtual span
    ``t_end`` (callers typically measure a clean run first):

      * ``"none"``     — empty schedule,
      * ``"wave"``     — 50% of the fleet offline over the middle fifth,
      * ``"blackout"`` — 90% offline over a short early window (the
        availability-collapse-and-recover stress),
      * ``"rolling"``  — two staggered 40% waves with disjoint seeds.
    """
    if t_end <= 0:
        raise ValueError(f"t_end must be positive, got {t_end}")
    if profile == "none":
        return ChurnSchedule(num_devices, ())
    if profile == "wave":
        return ChurnSchedule(num_devices, (
            ChurnWave(0.4 * t_end, 0.6 * t_end, 0.5, seed),))
    if profile == "blackout":
        return ChurnSchedule(num_devices, (
            ChurnWave(0.2 * t_end, 0.35 * t_end, 0.9, seed),))
    if profile == "rolling":
        return ChurnSchedule(num_devices, (
            ChurnWave(0.25 * t_end, 0.5 * t_end, 0.4, seed),
            ChurnWave(0.45 * t_end, 0.7 * t_end, 0.4, seed + 1)))
    raise KeyError(f"unknown churn profile '{profile}' "
                   "(none|wave|blackout|rolling)")
