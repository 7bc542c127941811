"""Chrome trace-event export: one ``.jsonl`` trace → Perfetto-viewable JSON.

Converts the ``kind="span"`` events of a streamed trace
(``repro_torch.obs.spans``) into the Chrome trace-event format that
Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` open directly,
with the two clocks as two *processes*:

  * pid 1 — **wall clock**: host ``perf_counter`` intervals, rebased so the
    trace starts at t=0.  Nested spans land on one thread track (their
    intervals nest by construction); *flat* spans (the event scheduler's
    overlapping task/transfer lifetimes, ``CommLedger`` link transfers) are
    emitted as async begin/end pairs, which Perfetto stacks without
    corrupting the nesting track.
  * pid 2 — **virtual clock**: the same spans positioned by their simulated
    edge-time interval (only spans that carried virtual stamps appear).
    Wall and virtual tracks scroll side by side, so "the cloud solve is 2%
    of virtual round time but 60% of wall time" is one glance.

Span tags ride in ``args`` (clickable in the UI).  Usage::

    python -m repro_torch.obs.perfetto BENCH_hier.jsonl -o trace.json

then drag ``trace.json`` into Perfetto.  ``export_chrome_trace`` is the
library entry point (streams the input; events list is the output size).
A copy of ``repro.obs.perfetto`` (stdlib only): both write the same JSON
for the same trace.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Union

from .jsonl import iter_trace
from .spans import span_fields, span_tags

WALL_PID = 1
VIRTUAL_PID = 2

_META = [
    {"ph": "M", "pid": WALL_PID, "name": "process_name",
     "args": {"name": "wall clock"}},
    {"ph": "M", "pid": WALL_PID, "name": "process_sort_index",
     "args": {"sort_index": 0}},
    {"ph": "M", "pid": VIRTUAL_PID, "name": "process_name",
     "args": {"name": "virtual clock (simulated edge time)"}},
    {"ph": "M", "pid": VIRTUAL_PID, "name": "process_sort_index",
     "args": {"sort_index": 1}},
]


def chrome_trace_events(path: Union[str, Any]) -> List[Dict[str, Any]]:
    """The ``traceEvents`` list for one jsonl trace (metadata included)."""
    spans: List[Dict[str, Any]] = []
    base_wall: Optional[float] = None
    for event in iter_trace(path, kind="span"):
        f = span_fields(event)
        if "t0_wall" not in f:
            continue                     # malformed span event: skip
        if base_wall is None or f["t0_wall"] < base_wall:
            base_wall = f["t0_wall"]
        spans.append(f)
    out: List[Dict[str, Any]] = list(_META)
    next_async_id = 1
    for f in spans:
        name = str(f.get("name", "span"))
        args = {"path": f.get("path", name), **span_tags(f)}
        ts = (f["t0_wall"] - base_wall) * 1e6          # µs since trace start
        dur = f.get("dur_wall_s", 0.0) * 1e6
        if f.get("flat"):
            # overlapping lifetime: async begin/end pair on the wall track
            aid = next_async_id
            next_async_id += 1
            out.append({"ph": "b", "cat": "flat", "id": aid, "name": name,
                        "pid": WALL_PID, "tid": 1, "ts": ts, "args": args})
            out.append({"ph": "e", "cat": "flat", "id": aid, "name": name,
                        "pid": WALL_PID, "tid": 1, "ts": ts + dur})
        else:
            out.append({"ph": "X", "cat": "span", "name": name,
                        "pid": WALL_PID, "tid": 0, "ts": ts, "dur": dur,
                        "args": args})
        if "t0_virtual" in f:
            vts = f["t0_virtual"] * 1e6                # virtual s → µs
            vdur = f.get("dur_virtual_s", 0.0) * 1e6
            if f.get("flat"):
                aid = next_async_id
                next_async_id += 1
                out.append({"ph": "b", "cat": "flat", "id": aid,
                            "name": name, "pid": VIRTUAL_PID, "tid": 1,
                            "ts": vts, "args": args})
                out.append({"ph": "e", "cat": "flat", "id": aid,
                            "name": name, "pid": VIRTUAL_PID, "tid": 1,
                            "ts": vts + vdur})
            else:
                out.append({"ph": "X", "cat": "span", "name": name,
                            "pid": VIRTUAL_PID, "tid": 0, "ts": vts,
                            "dur": vdur, "args": args})
    return out


def export_chrome_trace(trace_path: Union[str, Any], out_path: str) -> int:
    """Write the Chrome trace JSON for ``trace_path``; returns the number
    of source spans exported (0 means the trace carried no spans)."""
    events = chrome_trace_events(trace_path)
    # each source span contributes exactly one wall-track open ("X" or "b")
    n_spans = sum(1 for e in events
                  if e["ph"] in ("X", "b") and e["pid"] == WALL_PID)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return n_spans


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Export a repro_torch.obs jsonl trace to Chrome "
                    "trace-event JSON (open in https://ui.perfetto.dev)")
    ap.add_argument("trace", help="input .jsonl trace")
    ap.add_argument("-o", "--out", default="trace.json",
                    help="output Chrome trace JSON (default: trace.json)")
    args = ap.parse_args(argv)
    try:
        n = export_chrome_trace(args.trace, args.out)
    except FileNotFoundError:
        print(f"perfetto: trace not found: {args.trace}", file=sys.stderr)
        return 2
    except (json.JSONDecodeError, KeyError) as exc:
        print(f"perfetto: {args.trace}: truncated or invalid jsonl ({exc})",
              file=sys.stderr)
        return 2
    print(f"wrote {args.out} ({n} spans from {args.trace})", file=sys.stderr)
    if n == 0:
        print("perfetto: warning: trace carried no span events",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
