"""Span tracing over dual clocks — where time goes inside a round.

The tracker protocol streams *scalar* metrics (losses, bytes,
wall-clocks) but cannot say where a round's milliseconds went: gateway
stage vs cloud solve vs link transfer vs jit compile, in host wall time or
in the virtual edge clock.  A *span* is a named interval recorded on BOTH
clocks at once:

  * **wall** — host ``time.perf_counter()`` at open/close, always present;
  * **virtual** — the simulated edge time, present whenever a virtual
    clock is threaded in (:func:`use_virtual_clock` installs the event
    scheduler's ``lambda: scheduler.now`` for the block) or the caller
    stamps it explicitly (``t_virtual=`` on :func:`begin`/:func:`end`,
    :func:`record_span` for transfers whose duration is known up front).

Three entry points, all free on the noop path (one ``active`` check):

  * ``with span(name, **tags): ...`` — nested lifetimes.  Spans opened
    inside run as children: each carries a ``path`` like
    ``"round/event_loop/gateway"`` built from the thread-local span stack,
    which is what the Perfetto export nests on and ``trace_diff`` aligns
    on.  An exception inside the block still closes the span (tagged
    ``error=<ExcType>``), restores the nesting depth, and re-raises.
  * ``h = begin(name, **tags)`` / ``end(h, **tags)`` — explicit handles
    for the event scheduler's NON-nested lifetimes (a dispatched task and
    the next dispatch overlap arbitrarily).  Flat spans take their path
    from the stack at ``begin`` but never push onto it, so they cannot
    corrupt the nesting of context-managed spans; the export renders them
    as async (overlap-safe) track events.
  * ``record_span(name, t0_virtual=, dur_virtual_s=, **tags)`` — a span
    whose interval is already known (the ``CommLedger``'s link transfers:
    virtual duration computed from bytes/bandwidth at record time).

Every close emits ONE ``kind="span"`` event through the active tracker's
``log_span`` — the jsonl / in-memory / composite sinks of ``repro_torch.obs``
carry spans with no changes, and one ``.jsonl`` trace interleaves spans
with the metric stream.  Reserved metric keys: ``name``, ``path``,
``depth``, ``flat``, ``t0_wall``, ``dur_wall_s``, ``t0_virtual``,
``dur_virtual_s``; everything else in the event is a caller tag (Perfetto
``args``).  Like ``repro_torch.obs.tracker`` this module imports nothing from
the rest of ``repro_torch``; it is a copy of ``repro.obs.spans``.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

from .tracker import TrackedEvent, Tracker, current_tracker

# span-event keys that are structure, not caller tags
RESERVED_KEYS = ("name", "path", "depth", "flat", "t0_wall", "dur_wall_s",
                 "t0_virtual", "dur_virtual_s")

_STATE = threading.local()      # .stack: List[SpanHandle], .vclock: stack


def _stack() -> List["SpanHandle"]:
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    return stack


# ---------------------------------------------------------------------------
# virtual clock threading
# ---------------------------------------------------------------------------

def virtual_now() -> Optional[float]:
    """Current virtual time, or None when no virtual clock is installed."""
    clocks = getattr(_STATE, "vclock", None)
    return clocks[-1]() if clocks else None


@contextmanager
def use_virtual_clock(clock: Callable[[], float]) -> Iterator[None]:
    """Install ``clock`` (e.g. ``lambda: scheduler.now``) as the virtual
    timestamp source for spans opened in the block; contexts stack."""
    clocks = getattr(_STATE, "vclock", None)
    if clocks is None:
        clocks = _STATE.vclock = []
    clocks.append(clock)
    try:
        yield
    finally:
        clocks.pop()


@contextmanager
def use_barrier(fn: Callable[[], None]) -> Iterator[None]:
    """Call ``fn`` (e.g. ``torch.cuda.synchronize``) as each nested span of
    depth 0 or 1 (a round and its phases) opens and closes, for the block:
    their wall durations then hold the device work issued inside them, not
    just the time to issue it.  A port addition (the reference's jit calls
    block on their outputs); off unless installed."""
    prev = getattr(_STATE, "barrier", None)
    _STATE.barrier = fn
    try:
        yield
    finally:
        _STATE.barrier = prev


def _barrier(depth: int) -> None:
    barrier = getattr(_STATE, "barrier", None)
    if barrier is not None and depth <= 1:
        barrier()


# ---------------------------------------------------------------------------
# span lifecycle
# ---------------------------------------------------------------------------

@dataclass
class SpanHandle:
    """An open span: identity plus its open-time stamps.  The tracker is
    captured at open so a span closes into the sink it opened under even if
    the active tracker changes mid-flight."""
    name: str
    path: str
    depth: int
    t0_wall: float
    t0_virtual: Optional[float]
    tags: Dict[str, Any]
    tracker: Tracker
    flat: bool = False
    _extra: Dict[str, Any] = field(default_factory=dict)


def _emit(h: SpanHandle, t1_wall: float, t1_virtual: Optional[float]) -> None:
    metrics: Dict[str, Any] = {"name": h.name, "path": h.path,
                               "depth": h.depth,
                               "t0_wall": h.t0_wall,
                               "dur_wall_s": max(t1_wall - h.t0_wall, 0.0)}
    if h.flat:
        metrics["flat"] = True
    if h.t0_virtual is not None:
        metrics["t0_virtual"] = h.t0_virtual
        t1v = t1_virtual if t1_virtual is not None else h.t0_virtual
        metrics["dur_virtual_s"] = max(t1v - h.t0_virtual, 0.0)
    metrics.update(h.tags)
    metrics.update(h._extra)
    h.tracker.log_span(metrics)


def current_path() -> str:
    """The open nested-span path on this thread ("" at top level)."""
    stack = _stack()
    return stack[-1].path if stack else ""


@contextmanager
def span(name: str, *, t_virtual: Optional[float] = None,
         clock: Optional[Callable[[], float]] = None,
         **tags: Any) -> Iterator[Optional[SpanHandle]]:
    """Record a nested span around the block.  Yields the handle (or None
    on the noop path); callers may add tags via ``handle.tags[...] = ...``.
    ``clock`` is a per-span virtual clock (e.g. ``lambda: scheduler.now``)
    for call sites outside a :func:`use_virtual_clock` block.  Exceptions
    close the span with an ``error`` tag and re-raise."""
    tr = current_tracker()
    if not tr.active:
        yield None
        return
    stack = _stack()
    parent = stack[-1].path if stack else ""
    if t_virtual is None:
        t_virtual = clock() if clock is not None else virtual_now()
    _barrier(len(stack))
    h = SpanHandle(name=name,
                   path=f"{parent}/{name}" if parent else name,
                   depth=len(stack), t0_wall=time.perf_counter(),
                   t0_virtual=t_virtual,
                   tags=dict(tags), tracker=tr)
    stack.append(h)
    try:
        yield h
    except BaseException as exc:
        h.tags.setdefault("error", type(exc).__name__)
        raise
    finally:
        stack.pop()
        _barrier(h.depth)
        _emit(h, time.perf_counter(),
              clock() if clock is not None else virtual_now())


def begin(name: str, *, t_virtual: Optional[float] = None,
          **tags: Any) -> Optional[SpanHandle]:
    """Open a *flat* span (non-nested lifetime) and return its handle, or
    None when no tracker is active (``end(None)`` is a no-op, so hot call
    sites need no guard of their own)."""
    tr = current_tracker()
    if not tr.active:
        return None
    stack = _stack()
    parent = stack[-1].path if stack else ""
    return SpanHandle(name=name,
                      path=f"{parent}/{name}" if parent else name,
                      depth=len(stack), t0_wall=time.perf_counter(),
                      t0_virtual=(t_virtual if t_virtual is not None
                                  else virtual_now()),
                      tags=dict(tags), tracker=tr, flat=True)


def end(handle: Optional[SpanHandle], *, t_virtual: Optional[float] = None,
        **tags: Any) -> None:
    """Close a span opened with :func:`begin`; extra ``tags`` are merged
    into the emitted event (e.g. the terminal outcome of a task)."""
    if handle is None:
        return
    handle._extra.update(tags)
    t1v = t_virtual if t_virtual is not None else virtual_now()
    _emit(handle, time.perf_counter(), t1v)


def record_span(name: str, *, t0_virtual: float, dur_virtual_s: float,
                **tags: Any) -> None:
    """Emit a span whose virtual interval is already known (link
    transfers): zero wall duration, stamped at the current wall clock."""
    tr = current_tracker()
    if not tr.active:
        return
    stack = _stack()
    parent = stack[-1].path if stack else ""
    now = time.perf_counter()
    h = SpanHandle(name=name,
                   path=f"{parent}/{name}" if parent else name,
                   depth=len(stack), t0_wall=now, t0_virtual=t0_virtual,
                   tags=dict(tags), tracker=tr, flat=True)
    _emit(h, now, t0_virtual + max(dur_virtual_s, 0.0))


# ---------------------------------------------------------------------------
# reading spans back out of a trace
# ---------------------------------------------------------------------------

def span_fields(event: TrackedEvent) -> Dict[str, Any]:
    """A span event's metrics with any scope prefix stripped — spans are
    normally emitted unscoped (via :func:`current_tracker`), but a span
    logged through a ``tracker.scope(...)`` view arrives with prefixed
    keys; this normalizes both so exporters/diff tools see one layout."""
    m = event.metrics
    if event.scope:
        prefix = event.scope + "/"
        m = {(k[len(prefix):] if k.startswith(prefix) else k): v
             for k, v in m.items()}
    return m


def span_tags(fields: Dict[str, Any]) -> Dict[str, Any]:
    """The caller-tag subset of normalized span fields (Perfetto args)."""
    return {k: v for k, v in fields.items() if k not in RESERVED_KEYS}


# package-level aliases: ``spans.begin``/``spans.end`` read naturally with
# the module prefix, ``begin_span``/``end_span`` without it
begin_span = begin
end_span = end

