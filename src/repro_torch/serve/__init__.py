"""Serving stack: continuous-batching decode with hot-swapped FL models.

Closes the train-to-serve loop: ``run_hier_simulation``'s ``publish_fn``
hook pushes each round's aggregated params onto a :class:`ModelBus`, a
:class:`DecodeEngine` adopts versions at scan-chunk boundaries without
draining in-flight requests, and :mod:`repro_torch.serve.offline` replays request
traces under the virtual clock for staleness-vs-quality accounting.

The port of ``repro.serve``: the engine's decode steps run the dense or
MoE transformer on the card, with its attention in the ``flash_decode`` kernel.
"""
from .bus import ModelBus, Published
from .engine import Completion, DecodeEngine, Request
from .offline import ScheduledModel, TraceRequest, replay, synthetic_trace

__all__ = [
    "Completion", "DecodeEngine", "ModelBus", "Published", "Request",
    "ScheduledModel", "TraceRequest", "replay", "synthetic_trace",
]
