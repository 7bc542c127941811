"""Versioned, double-buffered model publication bus (train → serve hop).

The aggregation loop (``run_hier_simulation``'s per-round ``publish_fn``
hook, or any driver) pushes each round's aggregated params here; the decode
engine adopts the newest version at its next scan-chunk boundary.  Nothing
drains: in-flight requests keep decoding on the version they started their
current chunk with, and the next chunk runs entirely on the new tree — a
request can span versions, but a single forward pass never sees a mixed
tree.

Double buffering is what makes the snapshot tear-free without a reader
lock: :meth:`publish` stages the incoming tree into the standby buffer and
then flips one reference (``_live``) — a Python attribute store, atomic
under the GIL — so a concurrent :meth:`snapshot` returns either the old
:class:`Published` or the new one, never a half-written mix.  The writer
lock only serializes concurrent *publishers*.

A copy of ``repro.serve.bus``: it holds whatever tree it is given (here
dicts of tensors) and never copies or moves it.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

from ..obs import spans

Pytree = Any


@dataclass(frozen=True)
class Published:
    """One immutable published model: the tree plus its provenance."""
    version: int
    params: Pytree
    train_loss: Optional[float] = None
    t_publish_wall: float = 0.0
    t_publish_virtual: Optional[float] = None
    round: Optional[int] = None


class ModelBus:
    """Single-writer-friendly versioned params bus with atomic snapshots."""

    def __init__(self, params: Pytree, *, train_loss: Optional[float] = None):
        first = Published(version=0, params=params, train_loss=train_loss,
                         t_publish_wall=time.perf_counter(),
                         t_publish_virtual=spans.virtual_now())
        self._buffers: list = [first, None]
        self._live: int = 0
        self._lock = threading.Lock()
        self._published = 1           # total publish count (incl. seed tree)

    def publish(self, params: Pytree, *, train_loss: Optional[float] = None,
                t_virtual: Optional[float] = None,
                round: Optional[int] = None) -> int:
        """Stage ``params`` into the standby buffer and flip it live.
        Returns the new version number (monotone)."""
        with self._lock:
            cur = self._buffers[self._live]
            standby = 1 - self._live
            pub = Published(
                version=cur.version + 1, params=params, train_loss=train_loss,
                t_publish_wall=time.perf_counter(),
                t_publish_virtual=(t_virtual if t_virtual is not None
                                   else spans.virtual_now()),
                round=round)
            self._buffers[standby] = pub
            self._live = standby      # atomic flip: readers see old xor new
            self._published += 1
        spans.record_span("model_publish",
                          t0_virtual=pub.t_publish_virtual or 0.0,
                          dur_virtual_s=0.0, version=pub.version,
                          train_loss=train_loss)
        return pub.version

    def snapshot(self) -> Published:
        """The newest published model — one attribute read, never torn."""
        return self._buffers[self._live]

    @property
    def version(self) -> int:
        return self.snapshot().version

    @property
    def num_published(self) -> int:
        return self._published
