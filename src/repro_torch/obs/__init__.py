"""Streaming observability for the port: trackers and dual-clock spans.

Copies of ``repro.obs.{tracker,spans,jsonl}`` (stdlib + numpy), so the port
logs the same events and spans as the reference without importing it.
"""
from . import spans
from .jsonl import JsonlTracker, iter_trace, read_trace
from .spans import (begin_span, end_span, record_span, span, span_fields,
                    span_tags, use_virtual_clock, virtual_now)
from .tracker import (NOOP, CompositeTracker, InMemoryTracker, NoopTracker,
                      TrackedEvent, Tracker, current_tracker, use_tracker)

__all__ = [
    "NOOP", "CompositeTracker", "InMemoryTracker", "JsonlTracker",
    "NoopTracker", "TrackedEvent", "Tracker", "begin_span", "current_tracker",
    "end_span", "iter_trace", "read_trace", "record_span", "span",
    "span_fields", "span_tags", "spans", "use_tracker", "use_virtual_clock",
    "virtual_now",
]
