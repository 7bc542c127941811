"""Per-device compute/network profiles and canonical edge fleets.

A :class:`DeviceProfile` captures the three axes of edge heterogeneity the
paper's experiments abstract away (it draws epochs ~ U[min,max] inside a
synchronous round):

  * compute   — effective FLOP/s of the device,
  * network   — uplink/downlink bandwidth in bytes/s,
  * reliability — a per-task dropout probability (device dies / goes out of
    coverage / user kills the app before the update is uploaded).

``task_time`` turns a local-training workload (steps × FLOPs/step, model
payload) into a virtual duration, with optional lognormal jitter drawn from a
caller-provided RNG so the whole simulation stays deterministic under a seed.

Canonical fleets (cf. Wang et al., adaptive FL at the edge):

  * :func:`uniform_fleet`  — homogeneous devices (sanity baseline),
  * :func:`bimodal_fleet`  — phones + gateways: a slow cohort ``slowdown``×
    slower than the fast one, with its own dropout rate,
  * :func:`longtail_fleet` — Pareto-distributed compute, the "one straggler
    dominates the round" regime.

This module is a copy of ``repro.edge.profiles`` (numpy and the port's own
modules only), kept so the port never imports the JAX package; its
output is bit-identical (``tests/test_torch_edge.py``,
``tests/test_torch_hier.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class DeviceProfile:
    device_id: int
    flops: float                 # effective FLOP/s
    up_bw: float                 # uplink bytes/s
    down_bw: float               # downlink bytes/s
    dropout: float = 0.0         # per-task dropout probability in [0, 1)
    jitter: float = 0.0          # lognormal sigma on the compute time

    def __post_init__(self):
        if not (0.0 <= self.dropout < 1.0):
            raise ValueError(
                f"device {self.device_id}: dropout must be in [0, 1), got "
                f"{self.dropout} (1.0 would never complete a task)")

    def compute_time(self, flops_required: float) -> float:
        return flops_required / self.flops

    def comm_time(self, payload_bytes: float) -> float:
        """Model download + update upload for one task."""
        return payload_bytes / self.down_bw + payload_bytes / self.up_bw

    def task_time(self, flops_required: float, payload_bytes: float,
                  rng: Optional[np.random.RandomState] = None) -> float:
        """Virtual duration of one dispatch→arrival task on this device."""
        t = self.compute_time(flops_required)
        if rng is not None and self.jitter > 0.0:
            t *= float(np.exp(rng.normal(0.0, self.jitter)))
        return t + self.comm_time(payload_bytes)


@dataclass(frozen=True)
class Fleet:
    name: str
    profiles: Tuple[DeviceProfile, ...]
    # device ids under adversarial control (repro.robust: seeded assignment
    # via assign_adversaries); empty for honest fleets.  Lives on the fleet
    # so sync/async/hier runs over the same fleet see the same adversaries.
    malicious: Tuple[int, ...] = ()

    def __post_init__(self):
        bad = [i for i in self.malicious
               if not (0 <= i < len(self.profiles))]
        if bad:
            raise ValueError(f"malicious ids out of range for "
                             f"{len(self.profiles)} devices: {bad}")

    @property
    def num_devices(self) -> int:
        return len(self.profiles)

    def is_malicious(self, device_id: int) -> bool:
        return device_id in self.malicious

    def __getitem__(self, device_id: int) -> DeviceProfile:
        return self.profiles[device_id]

    def __iter__(self) -> Iterator[DeviceProfile]:
        return iter(self.profiles)

    def describe(self) -> str:
        f = np.array([p.flops for p in self.profiles])
        d = np.array([p.dropout for p in self.profiles])
        return (f"{self.name}: N={self.num_devices} "
                f"flops[min/med/max]={f.min():.2e}/{np.median(f):.2e}/"
                f"{f.max():.2e} mean_dropout={d.mean():.3f}")


# Reference magnitudes: a mid-range phone sustains ~1 GFLOP/s of useful
# training throughput on ~10 Mbit/s uplink; gateways are ~an order faster.
PHONE_FLOPS = 1e9
PHONE_BW = 1.25e6


@dataclass(frozen=True, eq=False)
class ArrayFleet:
    """Array-backed fleet: one numpy vector per profile field instead of one
    frozen :class:`DeviceProfile` object per device.

    At 10⁵–10⁶ devices the tuple-of-dataclasses representation costs hundreds
    of MB and seconds of host time before a single round runs; this class
    keeps the whole fleet in five float64 vectors and exposes the same duck
    interface the runtimes consume (``num_devices``, ``__getitem__`` →
    a :class:`DeviceProfile` built on demand, ``malicious``, ``describe``).
    The vectorized scheduler path (``EventScheduler.dispatch_batch``) reads
    the arrays directly via :func:`fleet_arrays`."""
    name: str
    flops: np.ndarray
    up_bw: np.ndarray
    down_bw: np.ndarray
    dropout: np.ndarray
    jitter: np.ndarray
    malicious: Tuple[int, ...] = ()

    def __post_init__(self):
        n = len(self.flops)
        for f in ("flops", "up_bw", "down_bw", "dropout", "jitter"):
            arr = np.asarray(getattr(self, f), np.float64)
            if arr.shape != (n,):
                raise ValueError(f"{f} must be shape ({n},), got {arr.shape}")
            object.__setattr__(self, f, arr)
        if np.any((self.dropout < 0.0) | (self.dropout >= 1.0)):
            raise ValueError("dropout must be in [0, 1) for every device")
        bad = [i for i in self.malicious if not (0 <= i < n)]
        if bad:
            raise ValueError(f"malicious ids out of range for {n} devices: "
                             f"{bad}")

    @property
    def num_devices(self) -> int:
        return len(self.flops)

    def is_malicious(self, device_id: int) -> bool:
        return device_id in self.malicious

    def __getitem__(self, device_id: int) -> DeviceProfile:
        i = int(device_id)
        return DeviceProfile(i, float(self.flops[i]), float(self.up_bw[i]),
                             float(self.down_bw[i]), float(self.dropout[i]),
                             float(self.jitter[i]))

    def __iter__(self) -> Iterator[DeviceProfile]:
        return (self[i] for i in range(self.num_devices))

    def describe(self) -> str:
        f = self.flops
        return (f"{self.name}: N={self.num_devices} "
                f"flops[min/med/max]={f.min():.2e}/{np.median(f):.2e}/"
                f"{f.max():.2e} mean_dropout={self.dropout.mean():.3f}")


def fleet_arrays(fleet) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    """Per-device (flops, up_bw, down_bw, dropout, jitter) float64 vectors
    for any fleet — a view for :class:`ArrayFleet`, an O(N) one-time build
    for a tuple-of-profiles :class:`Fleet`."""
    if isinstance(fleet, ArrayFleet):
        return (fleet.flops, fleet.up_bw, fleet.down_bw, fleet.dropout,
                fleet.jitter)
    return tuple(np.asarray([getattr(p, f) for p in fleet], np.float64)
                 for f in ("flops", "up_bw", "down_bw", "dropout", "jitter"))


def as_array_fleet(fleet: Fleet) -> ArrayFleet:
    """Convert a tuple-of-profiles fleet to the array representation (same
    per-device values, same malicious set)."""
    if isinstance(fleet, ArrayFleet):
        return fleet
    fl, up, dn, do, ji = fleet_arrays(fleet)
    return ArrayFleet(fleet.name, fl, up, dn, do, ji,
                      malicious=tuple(fleet.malicious))


def array_uniform_fleet(num_devices: int, flops: float = PHONE_FLOPS,
                        bandwidth: float = PHONE_BW, dropout: float = 0.0,
                        jitter: float = 0.05) -> ArrayFleet:
    """:func:`uniform_fleet` without the per-device objects — identical
    per-device values at any fleet size."""
    full = np.full(num_devices, 1.0)
    return ArrayFleet("uniform", full * flops, full * bandwidth,
                      full * bandwidth, full * dropout, full * jitter)


def array_bimodal_fleet(num_devices: int, slow_frac: float = 0.5,
                        slowdown: float = 10.0,
                        fast_flops: float = 10 * PHONE_FLOPS,
                        bandwidth: float = PHONE_BW,
                        dropout_slow: float = 0.1, dropout_fast: float = 0.0,
                        jitter: float = 0.1, seed: int = 0) -> ArrayFleet:
    """:func:`bimodal_fleet` vectorized: the same seeded slow-cohort draw,
    so the array fleet matches the object fleet device-for-device."""
    rng = np.random.RandomState(seed)
    slow_ids = rng.choice(num_devices, int(round(slow_frac * num_devices)),
                          replace=False)
    slow = np.zeros(num_devices, bool)
    slow[slow_ids] = True
    flops = np.where(slow, fast_flops / slowdown, fast_flops)
    bw = np.where(slow, bandwidth / 2, bandwidth)
    dropout = np.where(slow, dropout_slow, dropout_fast)
    return ArrayFleet(f"bimodal(x{slowdown:g})", flops, bw, bw.copy(),
                      dropout, np.full(num_devices, jitter))


def array_longtail_fleet(num_devices: int, shape: float = 1.5,
                         median_flops: float = PHONE_FLOPS,
                         bandwidth: float = PHONE_BW, dropout: float = 0.05,
                         jitter: float = 0.1, seed: int = 0) -> ArrayFleet:
    """:func:`longtail_fleet` vectorized (same seeded Pareto slowdowns)."""
    rng = np.random.RandomState(seed)
    slowdowns = 1.0 + rng.pareto(shape, size=num_devices)
    slowdowns /= np.median(slowdowns)
    flops = median_flops / np.maximum(slowdowns, 1e-3)
    full = np.full(num_devices, 1.0)
    return ArrayFleet("longtail", flops, full * bandwidth, full * bandwidth,
                      full * dropout, full * jitter)


def get_array_fleet(name: str, num_devices: int, **kw) -> ArrayFleet:
    builders = {"uniform": array_uniform_fleet, "bimodal": array_bimodal_fleet,
                "longtail": array_longtail_fleet}
    if name not in builders:
        raise KeyError(f"unknown fleet '{name}'; have {sorted(builders)}")
    return builders[name](num_devices, **kw)


def uniform_fleet(num_devices: int, flops: float = PHONE_FLOPS,
                  bandwidth: float = PHONE_BW, dropout: float = 0.0,
                  jitter: float = 0.05) -> Fleet:
    """Homogeneous fleet — async should roughly tie sync here."""
    return Fleet("uniform", tuple(
        DeviceProfile(i, flops, bandwidth, bandwidth, dropout, jitter)
        for i in range(num_devices)))


def bimodal_fleet(num_devices: int, slow_frac: float = 0.5,
                  slowdown: float = 10.0, fast_flops: float = 10 * PHONE_FLOPS,
                  bandwidth: float = PHONE_BW, dropout_slow: float = 0.1,
                  dropout_fast: float = 0.0, jitter: float = 0.1,
                  seed: int = 0) -> Fleet:
    """Phones + gateways: a ``slow_frac`` cohort is ``slowdown``× slower and
    flakier.  Which devices are slow is a seeded draw so fleets are
    reproducible but not index-correlated with data heterogeneity."""
    rng = np.random.RandomState(seed)
    slow_ids = set(rng.choice(num_devices, int(round(slow_frac * num_devices)),
                              replace=False).tolist())
    profiles = []
    for i in range(num_devices):
        if i in slow_ids:
            profiles.append(DeviceProfile(i, fast_flops / slowdown,
                                          bandwidth / 2, bandwidth / 2,
                                          dropout_slow, jitter))
        else:
            profiles.append(DeviceProfile(i, fast_flops, bandwidth, bandwidth,
                                          dropout_fast, jitter))
    return Fleet(f"bimodal(x{slowdown:g})", tuple(profiles))


def longtail_fleet(num_devices: int, shape: float = 1.5,
                   median_flops: float = PHONE_FLOPS,
                   bandwidth: float = PHONE_BW, dropout: float = 0.05,
                   jitter: float = 0.1, seed: int = 0) -> Fleet:
    """Pareto(shape)-distributed slowdowns: most devices are fine, a heavy
    tail is arbitrarily slow (the regime where synchronous rounds collapse)."""
    rng = np.random.RandomState(seed)
    slowdowns = 1.0 + rng.pareto(shape, size=num_devices)
    slowdowns /= np.median(slowdowns)  # median device = median_flops
    return Fleet("longtail", tuple(
        DeviceProfile(i, median_flops / max(s, 1e-3), bandwidth, bandwidth,
                      dropout, jitter)
        for i, s in enumerate(slowdowns)))


def get_fleet(name: str, num_devices: int, **kw) -> Fleet:
    builders = {"uniform": uniform_fleet, "bimodal": bimodal_fleet,
                "longtail": longtail_fleet}
    if name not in builders:
        raise KeyError(f"unknown fleet '{name}'; have {sorted(builders)}")
    return builders[name](num_devices, **kw)
