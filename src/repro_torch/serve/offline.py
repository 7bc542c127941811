"""Offline serving-eval harness: replay a request trace under hot swaps
(a copy of ``repro.serve.offline``; ``synthetic_trace`` draws from numpy,
so its traces equal the reference's bit for bit).

maxtext-``offline_inference``-style driver: a synthetic request trace
(arrival times on the PR-1 virtual clock) is replayed against a
:class:`~repro_torch.serve.engine.DecodeEngine` while a model schedule — e.g. the
per-round aggregated params captured from ``run_hier_simulation``'s
``publish_fn`` hook — publishes versions onto the engine's
:class:`~repro_torch.serve.bus.ModelBus` at their round times.  The replay loop
IS the virtual clock (each engine step costs a fixed virtual quantum), and
``spans.use_virtual_clock`` threads it into every span and completion
stamp, so the report can bin request latency and loss by model staleness
deterministically — no wall-clock noise in CI-gated fields.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..obs import spans
from .bus import ModelBus
from .engine import Completion, DecodeEngine

Pytree = Any


@dataclass
class TraceRequest:
    """One trace entry: arrival on the virtual clock + the request body."""
    rid: int
    arrival_s: float
    prompt: List[int]
    max_new: int


@dataclass
class ScheduledModel:
    """One publication: the round's aggregated params at its virtual time."""
    t_publish_s: float
    params: Pytree
    train_loss: Optional[float] = None
    round: Optional[int] = None


def synthetic_trace(*, num_requests: int, vocab: int, seed: int = 0,
                    mean_interarrival_s: float = 0.5,
                    prompt_len: Sequence[int] = (4, 24),
                    max_new: Sequence[int] = (4, 16)) -> List[TraceRequest]:
    """Deterministic Poisson-ish request trace (numpy Generator, seeded)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out: List[TraceRequest] = []
    for rid in range(num_requests):
        t += float(rng.exponential(mean_interarrival_s))
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        new = int(rng.integers(max_new[0], max_new[1] + 1))
        prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
        out.append(TraceRequest(rid=rid, arrival_s=t,
                                prompt=[int(x) for x in prompt],
                                max_new=new))
    return out


def replay(engine: DecodeEngine, trace: Sequence[TraceRequest],
           schedule: Sequence[ScheduledModel] = (), *,
           step_cost_s: float = 0.05,
           max_steps: int = 100_000) -> Dict[str, Any]:
    """Replay ``trace`` against ``engine``, publishing ``schedule`` onto its
    bus as virtual time passes.  Returns the serving report (see keys
    below); completions carry virtual stamps for staleness accounting.
    """
    bus: ModelBus = engine.bus
    trace = sorted(trace, key=lambda r: r.arrival_s)
    schedule = sorted(schedule, key=lambda m: m.t_publish_s)
    clock = {"now": 0.0}
    next_req = 0
    next_pub = 0
    completions: List[Completion] = []
    version_info: Dict[int, ScheduledModel] = {}
    version_times: Dict[int, float] = {bus.version: 0.0}
    occupancy: List[float] = []
    steps = 0

    with spans.use_virtual_clock(lambda: clock["now"]):
        while steps < max_steps:
            now = clock["now"]
            while next_pub < len(schedule) and \
                    schedule[next_pub].t_publish_s <= now:
                m = schedule[next_pub]
                v = bus.publish(m.params, train_loss=m.train_loss,
                                t_virtual=m.t_publish_s, round=m.round)
                version_info[v] = m
                version_times[v] = m.t_publish_s
                next_pub += 1
            while next_req < len(trace) and \
                    trace[next_req].arrival_s <= now:
                r = trace[next_req]
                engine.submit(r.prompt, r.max_new, rid=r.rid)
                next_req += 1
            drained = engine.idle and next_req >= len(trace)
            if drained and next_pub >= len(schedule):
                break
            if drained:
                # nothing to serve until the next publication — jump there
                clock["now"] = schedule[next_pub].t_publish_s
                continue
            if engine.idle:
                # idle until the next arrival — advance straight to it
                clock["now"] = max(now, trace[next_req].arrival_s)
                continue
            completions.extend(engine.step())
            occupancy.append(len(engine._slots) / engine.num_slots)
            clock["now"] = clock["now"] + step_cost_s
            steps += 1

    return _report(engine, completions, version_info, version_times,
                   occupancy, steps, step_cost_s)


def _report(engine: DecodeEngine, completions: List[Completion],
            version_info: Dict[int, ScheduledModel],
            version_times: Dict[int, float], occupancy: List[float],
            steps: int, step_cost_s: float) -> Dict[str, Any]:
    lat = [c.t_finish_virtual - c.t_submit_virtual for c in completions
           if c.t_finish_virtual is not None
           and c.t_submit_virtual is not None]
    toks = sum(len(c.tokens) for c in completions)
    virt_total = steps * step_cost_s

    # staleness: how old (virtual) was the serving model at completion
    by_request = []
    for c in completions:
        t_pub = version_times.get(c.final_version)
        stale = (c.t_finish_virtual - t_pub
                 if t_pub is not None and c.t_finish_virtual is not None
                 else None)
        m = version_info.get(c.final_version)
        by_request.append({
            "rid": c.rid, "prompt_len": c.prompt_len,
            "new_tokens": len(c.tokens),
            "admit_version": c.admit_version,
            "final_version": c.final_version,
            "latency_virtual_s": (c.t_finish_virtual - c.t_submit_virtual
                                  if c.t_finish_virtual is not None
                                  and c.t_submit_virtual is not None
                                  else None),
            "staleness_virtual_s": stale,
            "model_train_loss": None if m is None else m.train_loss,
        })

    stales = [r["staleness_virtual_s"] for r in by_request
              if r["staleness_virtual_s"] is not None]
    losses = [r["model_train_loss"] for r in by_request
              if r["model_train_loss"] is not None]
    stats = engine.stats
    return {
        "num_completed": len(completions),
        "tokens_generated": toks,
        "virtual_time_s": virt_total,
        "tokens_per_virtual_s": toks / virt_total if virt_total else 0.0,
        "latency_virtual_mean_s": float(np.mean(lat)) if lat else 0.0,
        "latency_virtual_p95_s": (float(np.percentile(lat, 95))
                                  if lat else 0.0),
        "slot_occupancy_mean": (float(np.mean(occupancy))
                                if occupancy else 0.0),
        "staleness_virtual_mean_s": (float(np.mean(stales))
                                     if stales else 0.0),
        "staleness_virtual_max_s": (float(np.max(stales))
                                    if stales else 0.0),
        "served_loss_mean": float(np.mean(losses)) if losses else None,
        "num_swaps": int(stats["swaps"]),
        "decode_steps": int(stats["decode_steps"]),
        "prefill_chunks": int(stats["prefill_chunks"]),
        "by_request": by_request,
    }
