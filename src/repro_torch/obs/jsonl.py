"""Append-only jsonl event stream — the file-backed tracker.

One JSON object per line, in emission order::

    {"step": 12, "t_wall": 1754700000.123, "kind": "metrics",
     "scope": "hier/run0",
     "metrics": {"hier/run0/train_loss": 0.41, "hier/run0/t_virtual": 88.2}}

``step`` is monotone *per scope*: within one scope explicit steps may
repeat or grow but never go backwards (a regression raises — the stream is
the ground truth for event ordering), while independent scopes — e.g. the
several simulations a bench runs into one trace — each keep their own step
counter.  Events logged without a step inherit their scope's latest one.
``t_wall`` is the host wall-clock at emission, so a live run can be
tailed::

    tail -f BENCH_hier.jsonl | python -m json.tool --json-lines

:func:`iter_trace` parses a stream back into :class:`TrackedEvent`s one at
a time — a generator, so trace tools (``summarize_trace.py``,
``trace_diff.py``, the Perfetto export) never hold a long trace in memory;
:func:`read_trace` is the list-materializing shim for call sites that want
random access.  A copy of ``repro.obs.jsonl`` (stdlib + numpy).
"""
from __future__ import annotations

import json
from typing import IO, Dict, Iterator, List, Optional, Union

import numpy as np

from .tracker import TrackedEvent, Tracker


def _jsonable(obj):
    """numpy scalars/arrays → python; everything else must be JSON-ready."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(f"not JSON-serializable: {type(obj).__name__}")


class JsonlTracker(Tracker):
    """Streams every event to an append-only ``.jsonl`` file.

    ``path`` may be a filename (truncated unless ``append=True``) or an open
    text handle (left open on ``finish``).  ``flush_every`` batches flushes:
    the default 1 flushes per write — a live, tailable stream — while hot
    benches can raise it to amortize syscalls (``finish()`` always flushes
    whatever is pending, and ``use_tracker`` calls it even when the body
    raises, so no tail of the trace is lost either way).
    """

    def __init__(self, path: Union[str, IO[str]], *, append: bool = False,
                 flush_every: int = 1):
        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got {flush_every}")
        if hasattr(path, "write"):
            self._fh: IO[str] = path          # type: ignore[assignment]
            self._owns = False
        else:
            self._fh = open(path, "a" if append else "w")
            self._owns = True
        self._last_step: Dict[str, int] = {}
        self._flush_every = int(flush_every)
        self._pending = 0

    def _record(self, event: TrackedEvent) -> None:
        last = self._last_step.get(event.scope, 0)
        if event.step is not None:
            if event.step < last:
                raise ValueError(
                    f"non-monotonic step in scope '{event.scope}': "
                    f"{event.step} after {last}")
            last = self._last_step[event.scope] = event.step
        line = {"step": last, "t_wall": event.t_wall, "kind": event.kind,
                "scope": event.scope, "metrics": event.metrics}
        self._fh.write(json.dumps(line, default=_jsonable) + "\n")
        self._pending += 1
        if self._pending >= self._flush_every:
            self._fh.flush()
            self._pending = 0

    def finish(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._pending = 0
            if self._owns:
                self._fh.close()


def _iter_handle(fh: IO[str], kind: Optional[str]
                 ) -> Iterator[TrackedEvent]:
    for line in fh:
        if not line.strip():
            continue
        obj = json.loads(line)
        if kind is not None and obj["kind"] != kind:
            continue
        yield TrackedEvent(kind=obj["kind"], metrics=obj["metrics"],
                           step=obj["step"], t_wall=obj["t_wall"],
                           scope=obj.get("scope", ""))


def iter_trace(path: Union[str, IO[str]],
               kind: Optional[str] = None) -> Iterator[TrackedEvent]:
    """Parse a jsonl trace lazily, one :class:`TrackedEvent` at a time
    (optionally one ``kind`` only) — long traces never materialize."""
    if hasattr(path, "read"):
        yield from _iter_handle(path, kind)
    else:
        with open(path) as f:
            yield from _iter_handle(f, kind)


def read_trace(path: Union[str, IO[str]],
               kind: Optional[str] = None) -> List[TrackedEvent]:
    """List-materializing shim over :func:`iter_trace` for call sites that
    need random access or multiple passes."""
    return list(iter_trace(path, kind))
