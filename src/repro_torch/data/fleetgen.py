"""Per-device data shards generated from device ids (``repro.data.fleetgen``).

A :class:`VirtualFleetDataset` never holds the ``(N, m, dim)`` array a
:class:`~repro_torch.data.federated.FederatedDataset` stores — at 10⁶
devices that array alone is tens of GB.  Each device's shard is a pure
function of ``(seed, device_id)``, generated on the card inside the cohort
pass of ``run_hier_simulation`` for just the round's participants.  The
recipe is the reference's Synthetic(α,β) family: per-device softmax-linear
teachers ``W_k, b_k ~ N(u_k, 1)`` with ``u_k ~ N(0, α)``, inputs
``x ~ N(v_k, Σ)`` with ``Σ_jj = (j+1)^{-1.2}`` and ``v_k ~ N(B_k, 1)``,
``B_k ~ N(0, β)``, labels the argmax of the teacher's logits.

The reference draws the six normals of a device with ``jax.random``, which
torch cannot reproduce, so the recipe is split in two layers:

* :func:`shard_from_normals` — the pure transform from the six standard
  normals to ``(x, y)``, line for line the reference's (the tests feed it
  the reference's own normals);
* :func:`fleet_normals` — the port's normal source: counter-based, keyed by
  ``(seed, device_id, field, element)`` through the murmur3 finalizer
  (``kernels.ref.mix32``, the mixing of the v2 scheduler stream), so a
  device's normals never depend on which other ids are drawn beside it.

Determinism: every step is elementwise with a fixed order — the teacher's
logits are accumulated over ``dim`` one column at a time instead of by a
batched matmul, whose algorithm (and rounding) changes with the batch
count, and the transcendentals of Box–Muller run in f64 before the one
rounding to f32 — so on one device ``materialize_arrays(ids)`` equals the
shard generated in the cohort pass bit for bit, whatever the chunking and
the order of the ids.  The test set comes from the held-out ids
``[N, N + test_devices)``, so no training shard leaks into eval.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.ref import mix32
from .federated import FederatedDataset

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
# the six normal fields of a device, in the reference's split order
FIELD_U, FIELD_W, FIELD_B, FIELD_BB, FIELD_V, FIELD_X = range(6)


def _as_ids(device_ids, device: torch.device) -> torch.Tensor:
    if isinstance(device_ids, torch.Tensor):
        return device_ids.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(device_ids, np.int64), device=device)


def fleet_normals(seed: int, device_ids: torch.Tensor, field: int,
                  count: int) -> torch.Tensor:
    """``(B, count)`` f32 standard normals of field ``field`` for each id of
    ``device_ids`` (int64, on the device they are drawn on).

    Element ``e`` is one half of the Box–Muller pair ``e // 2``: the pair's
    two uniforms are ``(h + 0.5)·2⁻³²`` for the hashes ``h`` of counters
    ``2p`` and ``2p + 1``, strictly inside (0, 1) as the scheduler's
    ``_stream_uniform`` keeps them; even elements take ``r·cos θ``, odd
    ones ``r·sin θ``.  Each hash is
    ``mix32(mix32(key ⊕ ctr·φ) ⊕ salt)`` with ``key = mix32(id ⊕
    mix32(seed))`` and a per-field salt, so it is a function of
    ``(seed, id, field, element)`` alone."""
    ids = device_ids.to(torch.int64)
    dev = ids.device
    key = mix32((ids & _M32) ^ int(mix32(torch.tensor(int(seed) & _M32))))
    salt = (0x85EBCA6B * (field + 1)) & _M32
    pairs = -(-count // 2)
    ctr = torch.arange(2 * pairs, dtype=torch.int64, device=dev)
    h = mix32(mix32(key[:, None] ^ ((ctr * _GOLDEN) & _M32)[None, :]) ^ salt)
    u = (h.to(torch.float64) + 0.5) * 2.0 ** -32
    u1, u2 = u[:, 0::2], u[:, 1::2]
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u2
    z = torch.stack((r * torch.cos(theta), r * torch.sin(theta)), dim=-1)
    return z.reshape(ids.shape[0], 2 * pairs)[:, :count].to(torch.float32)


def sigma_vector(dim: int) -> np.ndarray:
    """``sqrt((j+1)^{-1.2})``, j < dim, in f32 (the reference's Σ)."""
    return np.sqrt(np.arange(1, dim + 1, dtype=np.float32)
                   ** np.float32(-1.2)).astype(np.float32)


def shard_from_normals(z_u: torch.Tensor, z_w: torch.Tensor,
                       z_b: torch.Tensor, z_B: torch.Tensor,
                       z_v: torch.Tensor, z_x: torch.Tensor,
                       sigma: torch.Tensor, alpha: float, beta: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x (B, m, dim) f32, y (B, m) int64)`` from a batch of the six
    normals — ``z_u (B,)``, ``z_w (B, dim, C)``, ``z_b (B, C)``,
    ``z_B (B,)``, ``z_v (B, dim)``, ``z_x (B, m, dim)`` — following
    ``repro/data/fleetgen.py:68-74``.  The logits ``x W + b`` are summed
    over ``dim`` one column at a time (elementwise, a fixed order), so a
    device's labels do not depend on the batch it is in."""
    uk = alpha * z_u
    W = uk[:, None, None] + z_w
    b = uk[:, None] + z_b
    Bk = beta * z_B
    v = Bk[:, None] + z_v
    x = v[:, None, :] + sigma * z_x
    logits = x[:, :, 0:1] * W[:, None, 0, :]
    for j in range(1, x.shape[2]):
        logits = logits + x[:, :, j:j + 1] * W[:, None, j, :]
    logits = logits + b[:, None, :]
    return x, torch.argmax(logits, dim=2)


@dataclass(frozen=True, eq=False)
class VirtualFleetDataset:
    """A fleet whose shards are generated from device ids on demand.
    Identity-hashed (``eq=False``), as the reference's."""
    num_devices: int
    samples_per_device: int = 16
    dim: int = 16
    num_classes: int = 4
    alpha: float = 1.0
    beta: float = 1.0
    seed: int = 0
    test_devices: int = 64

    # run_hier_simulation dispatches on this instead of isinstance
    virtual: bool = True

    def __post_init__(self):
        if self.num_devices < 1 or self.samples_per_device < 1:
            raise ValueError("need at least one device and one sample")
        if self.test_devices < 1:
            raise ValueError("need at least one held-out test device")

    def shard_fn(self, device: DeviceLike = "cuda") -> Callable[
            [torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """``ids -> (x (B, m, dim) f32, y (B, m) int64, mask (B, m) f32)``
        on ``device`` (ids as a tensor or an array of int64)."""
        dev = resolve_device(device)
        m, dim, C = self.samples_per_device, self.dim, self.num_classes
        alpha, beta, seed = float(self.alpha), float(self.beta), self.seed
        sigma = torch.as_tensor(sigma_vector(dim), device=dev)

        def shard(device_ids):
            ids = _as_ids(device_ids, dev)
            B = ids.shape[0]
            z = [fleet_normals(seed, ids, f, n) for f, n in (
                (FIELD_U, 1), (FIELD_W, dim * C), (FIELD_B, C),
                (FIELD_BB, 1), (FIELD_V, dim), (FIELD_X, m * dim))]
            x, y = shard_from_normals(
                z[0][:, 0], z[1].view(B, dim, C), z[2], z[3][:, 0], z[4],
                z[5].view(B, m, dim), sigma, alpha, beta)
            return x, y, torch.ones((B, m), dtype=torch.float32, device=dev)

        return shard

    def materialize_arrays(self, device_ids, device: DeviceLike = "cuda"
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host copies of the given devices' shards, generated on
        ``device`` — the same bits the cohort pass generates there."""
        x, y, mask = self.shard_fn(device)(device_ids)
        return x.cpu().numpy(), y.cpu().numpy(), mask.cpu().numpy()

    def test_set(self, device: DeviceLike = "cuda"
                 ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.arange(self.num_devices,
                        self.num_devices + self.test_devices, dtype=np.int64)
        x, y, _ = self.materialize_arrays(ids, device)
        return x.reshape(-1, self.dim), y.reshape(-1).astype(np.int32)

    @property
    def test_x(self) -> np.ndarray:
        return self.test_set()[0]

    @property
    def test_y(self) -> np.ndarray:
        return self.test_set()[1]

    def materialize(self, device_ids: Optional[np.ndarray] = None,
                    device: DeviceLike = "cuda") -> FederatedDataset:
        """A :class:`FederatedDataset` holding (a subset of) the fleet, its
        shards generated on ``device`` — the bridge between the virtual and
        materialized paths.  Not for 10⁶ devices; that is the point."""
        if device_ids is None:
            device_ids = np.arange(self.num_devices, dtype=np.int64)
        x, y, mask = self.materialize_arrays(device_ids, device)
        tx, ty = self.test_set(device)
        return FederatedDataset(x, y, mask, tx, ty, self.num_classes)


def eval_device_ids(num_devices: int, cap: int) -> np.ndarray:
    """Deterministic evenly-strided device subsample for fleet-scale eval:
    every device when the fleet fits the cap, every stride-th otherwise."""
    if num_devices <= cap:
        return np.arange(num_devices, dtype=np.int64)
    stride = -(-num_devices // cap)          # ceil
    return np.arange(num_devices, dtype=np.int64)[::stride][:cap]
