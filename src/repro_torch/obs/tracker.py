"""Streaming telemetry trackers (idiom: levanter's ``levanter.tracker``).

Every runtime in this repo produces live signals — per-round losses, the
``CommLedger``'s per-tier bytes, round-engine wall-clocks, kernel-autotune
decisions — that used to be visible only in end-of-run result dataclasses.
A :class:`Tracker` is the streaming outlet for all of them:

  * ``log(metrics, step=...)``    — one timestamped event of flat metrics;
  * ``log_summary(metrics)``      — run-level facts (configs, final numbers,
    bench records); no step, ordered like everything else;
  * ``jot(**tags)``               — sticky key/value tags (run name, engine);
  * ``scope(prefix)``             — a view whose metric keys are prefixed
    ``"prefix/"`` (hierarchical: ``tracker.scope("gateway/3")``).

The active tracker is process-wide, like levanter's: library code calls
:func:`current_tracker` and logs unconditionally cheap events; callers opt
in with ``with use_tracker(JsonlTracker(path)): ...``.  The default is
:data:`NOOP` — a :class:`NoopTracker` whose ``active`` flag is False so hot
loops can skip building metric dicts entirely::

    tr = current_tracker()
    if tr.active:
        tr.log({"train_loss": loss}, step=t)

Implementations here: :class:`NoopTracker` (default, zero overhead),
:class:`InMemoryTracker` (tests/notebooks), :class:`CompositeTracker`
(fan-out).  The append-only file tracker lives in ``repro_torch.obs.jsonl``.
This module imports nothing from the rest of ``repro_torch``, so every
layer can log through it without cycles.  It is a copy of
``repro.obs.tracker`` (stdlib only), kept so the port never imports the
JAX package.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

Metrics = Dict[str, Any]


@dataclass(frozen=True)
class TrackedEvent:
    """One logged event, as :class:`InMemoryTracker` records it (the jsonl
    tracker serializes the same fields per line).  ``scope`` is the full
    ``a/b`` prefix path the event was logged under ("" at the root) — the
    jsonl tracker enforces step monotonicity per scope, since one trace
    typically interleaves several independent runs."""
    kind: str                     # "metrics" | "summary" | "tags" | "span"
    metrics: Metrics
    step: Optional[int] = None
    t_wall: float = 0.0
    scope: str = ""


class Tracker:
    """Base tracker: the four-method protocol plus scope plumbing.

    Subclasses implement :meth:`_record`; ``log``/``log_summary``/``jot``
    route through it with the event kind.  ``active`` is the hot-loop guard:
    when False (the noop), callers may skip metric construction.
    """

    active: bool = True

    # -- protocol -----------------------------------------------------------

    def log(self, metrics: Metrics, *, step: Optional[int] = None) -> None:
        self._record(TrackedEvent("metrics", dict(metrics), step,
                                  time.time()))

    def log_summary(self, metrics: Metrics) -> None:
        self._record(TrackedEvent("summary", dict(metrics), None,
                                  time.time()))

    def jot(self, **tags: Any) -> None:
        """Sticky tags (run name, engine, platform): one 'tags' event."""
        self._record(TrackedEvent("tags", dict(tags), None, time.time()))

    def log_span(self, metrics: Metrics) -> None:
        """One closed span (``repro_torch.obs.spans``): dual-clock interval plus
        tags, already flattened to JSON-ready fields.  Routed through
        ``_record`` like everything else, so every sink carries spans."""
        self._record(TrackedEvent("span", dict(metrics), None, time.time()))

    def scope(self, prefix: str) -> "Tracker":
        """A view of this tracker whose metric keys are prefixed
        ``"{prefix}/"`` — compose freely: ``tr.scope("hier").scope("gw3")``.
        """
        return _ScopedTracker(self, prefix)

    def finish(self) -> None:
        """Flush/close any underlying sink (no-op by default)."""

    # -- implementation hook ------------------------------------------------

    def _record(self, event: TrackedEvent) -> None:
        raise NotImplementedError


class NoopTracker(Tracker):
    """The default: swallows everything, advertises ``active = False`` so
    instrumented hot paths skip even building the metrics dict."""

    active = False

    def log(self, metrics: Metrics, *, step: Optional[int] = None) -> None:
        pass

    def log_summary(self, metrics: Metrics) -> None:
        pass

    def jot(self, **tags: Any) -> None:
        pass

    def log_span(self, metrics: Metrics) -> None:
        pass

    def scope(self, prefix: str) -> "Tracker":
        return self                 # no per-scope allocation on the noop

    def _record(self, event: TrackedEvent) -> None:
        pass


class _ScopedTracker(Tracker):
    """Key-prefixing view over another tracker (created by ``scope``)."""

    def __init__(self, inner: Tracker, prefix: str):
        self._inner = inner
        self._prefix = prefix.rstrip("/")

    @property
    def active(self) -> bool:       # type: ignore[override]
        return self._inner.active

    def _record(self, event: TrackedEvent) -> None:
        prefixed = {f"{self._prefix}/{k}": v
                    for k, v in event.metrics.items()}
        scope = (f"{self._prefix}/{event.scope}" if event.scope
                 else self._prefix)
        self._inner._record(TrackedEvent(event.kind, prefixed, event.step,
                                         event.t_wall, scope))


class InMemoryTracker(Tracker):
    """Records every event in order — the test/notebook tracker."""

    def __init__(self) -> None:
        self.events: List[TrackedEvent] = []

    def _record(self, event: TrackedEvent) -> None:
        self.events.append(event)

    # -- conveniences for assertions ---------------------------------------

    def metrics_events(self) -> List[TrackedEvent]:
        return [e for e in self.events if e.kind == "metrics"]

    def span_events(self) -> List[TrackedEvent]:
        return [e for e in self.events if e.kind == "span"]

    def series(self, key: str) -> List[Any]:
        """All values logged under ``key`` (any kind), in event order."""
        return [e.metrics[key] for e in self.events if key in e.metrics]


class CompositeTracker(Tracker):
    """Fans every event out to each child (e.g. jsonl file + in-memory)."""

    def __init__(self, trackers: Sequence[Tracker]):
        self.trackers = list(trackers)

    @property
    def active(self) -> bool:       # type: ignore[override]
        return any(t.active for t in self.trackers)

    def _record(self, event: TrackedEvent) -> None:
        for t in self.trackers:
            t._record(event)

    def finish(self) -> None:
        for t in self.trackers:
            t.finish()


NOOP = NoopTracker()

# The active tracker is thread-local so parallel test workers / background
# eval threads cannot interleave scopes; the default everywhere is NOOP.
_STATE = threading.local()


def current_tracker() -> Tracker:
    """The process-wide active tracker (``NOOP`` unless a ``use_tracker``
    context is open on this thread)."""
    return getattr(_STATE, "stack", None)[-1] if getattr(
        _STATE, "stack", None) else NOOP


@contextmanager
def use_tracker(tracker: Tracker, *, finish: bool = True) -> Iterator[Tracker]:
    """Install ``tracker`` as :func:`current_tracker` for the block; nested
    contexts stack.  ``finish=True`` closes the tracker's sink on exit."""
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    stack.append(tracker)
    try:
        yield tracker
    finally:
        stack.pop()
        if finish:
            tracker.finish()
