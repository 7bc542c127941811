"""The port's Perfetto exporter (``repro_torch.obs.perfetto``) on traces
written by the port's own ``JsonlTracker``: the assertions of
``tests/test_trace_tools.py``'s two Perfetto tests, and the port's and the
reference's exporters writing identical JSON for the same ``.jsonl`` file
(both are stdlib code over the same span fields)."""
import json

import pytest

from repro.obs.perfetto import export_chrome_trace as j_export
from repro.obs.perfetto import main as j_main
from repro_torch.obs import JsonlTracker, spans, use_tracker, use_virtual_clock
from repro_torch.obs.perfetto import (VIRTUAL_PID, WALL_PID,
                                      export_chrome_trace)
from repro_torch.obs.perfetto import main as perfetto_main


def _write_trace(path):
    """One tiny dual-clock trace through the port's span API: a round with
    a solve child, a flat scheduler task, a link transfer."""
    vt = [0.0]
    with use_tracker(JsonlTracker(str(path))) as tr:
        tr.jot(run="toy")
        with use_virtual_clock(lambda: vt[0]):
            with spans.span("round", round=0):
                h = spans.begin("sched/task", device=3)
                with spans.span("solve", K=4):
                    vt[0] += 5.0
                spans.end(h, outcome="arrival")
                spans.record_span("link/up", t0_virtual=vt[0],
                                  dur_virtual_s=0.5, tier=1, bytes=256.0)
        tr.log_summary({"_bench_meta": {"benchmark": "toy", "rounds": 1}})


def test_perfetto_export_dual_track_structure(tmp_path):
    trace = tmp_path / "BENCH_toy.jsonl"
    out = tmp_path / "trace.json"
    _write_trace(trace)
    n = export_chrome_trace(str(trace), str(out))
    assert n == 4                       # round, solve, sched/task, link/up
    evs = json.loads(out.read_text())["traceEvents"]
    names = {(e["pid"], e["args"]["name"]) for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert (WALL_PID, "wall clock") in names
    assert any(pid == VIRTUAL_PID for pid, _ in names)
    X = [e for e in evs if e["ph"] == "X"]
    assert {e["pid"] for e in X} == {WALL_PID, VIRTUAL_PID}
    assert {e["name"] for e in X if e["pid"] == WALL_PID} == \
        {"round", "solve"}
    b, e_ = [e for e in evs if e["ph"] == "b"], \
        [e for e in evs if e["ph"] == "e"]
    assert len(b) == len(e_) and {e["name"] for e in b} == \
        {"sched/task", "link/up"}
    assert {e["id"] for e in b} == {e["id"] for e in e_}
    assert min(e["ts"] for e in evs if e.get("pid") == WALL_PID
               and e["ph"] == "X") == pytest.approx(0.0, abs=1e-3)
    vround = [e for e in X if e["pid"] == VIRTUAL_PID
              and e["name"] == "round"]
    assert vround[0]["dur"] == pytest.approx(5.0 * 1e6)
    solve = [e for e in X if e["name"] == "solve"][0]
    assert solve["args"]["K"] == 4 and solve["args"]["path"] == "round/solve"


def test_perfetto_cli_error_and_empty_paths(tmp_path, capsys):
    assert perfetto_main([str(tmp_path / "nope.jsonl")]) == 2
    assert "not found" in capsys.readouterr().err
    empty = tmp_path / "nospans.jsonl"
    with use_tracker(JsonlTracker(str(empty))) as tr:
        tr.log({"x": 1}, step=0)
    out = tmp_path / "o.json"
    assert perfetto_main([str(empty), "-o", str(out)]) == 0
    assert "no span events" in capsys.readouterr().err
    assert json.loads(out.read_text())["traceEvents"]    # metadata only
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "span", "name": ')
    assert perfetto_main([str(bad), "-o", str(out)]) == \
        j_main([str(bad), "-o", str(out)]) == 2


def test_perfetto_port_and_reference_write_identical_json(tmp_path):
    trace = tmp_path / "t.jsonl"
    _write_trace(trace)
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    assert export_chrome_trace(str(trace), str(port)) == \
        j_export(str(trace), str(ref)) == 4
    assert port.read_bytes() == ref.read_bytes()
