#!/usr/bin/env python3
"""Fleet-scale rounds of the port: 10³ → 10⁶ simulated devices a round on
the card (the twin of ``benchmarks/fleet_scale.py``).

Sweeps the fleet size of a two-tier stacked topology (``max(4, N // 500)``
gateways) under the cohort scheduler (one vectorized batch dispatch a
round, the v2 counter-based stream) and a ``VirtualFleetDataset`` whose
shards are generated on the card from device ids, ``COHORT_CHUNK`` at a
time.  Sizes, seeds, ``HierConfig`` and record fields are the reference
bench's; per size it reports devices per round, the final training loss,
the cloud-uplink and total bytes and the virtual end time (data-free
accounting: equal to ``BENCH_fleet.json``'s records), the warm round ms,
devices per second, the card's peak allocated memory over the run
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``;
the reference reports the host's peak RSS), the kernel launches, and the
round's spans — ``client_update`` (shard generation and local SGD),
``begin_round``, ``event_loop`` (with its ``gateway``, ``merge`` and
``cloud`` stages) and ``eval`` — with the device synchronised as each
top-level span opens and closes, so their times hold the device work.
A 64-device record runs the event path over ``materialize()``d shards
beside the cohort path over the virtual fleet: equal times and bytes,
losses equal to float tolerance.

    python3 benchmarks/torch_fleet_scale.py [--full] [--rounds 3] [--device cuda]

``--full`` adds the 10⁶-device record (``FULL_ROUNDS`` rounds).  Prints
one JSON line per record, then the card's ``nvidia-smi`` name and power
limit.  ``collect()`` is what ``chip_smoke.py``'s fleet phase calls.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

SEED = 42
QUICK_SIZES = (1_000, 10_000, 100_000)
FULL_SIZES = QUICK_SIZES + (1_000_000,)
FULL_ROUNDS = 2           # rounds of the 10⁶ record
DIM, CLASSES, SAMPLES = 16, 4, 16
# the generated shard buffer's cap: above this cohort size the cohort pass
# runs in chunks
COHORT_CHUNK = 131_072
SPANS = ("client_update", "begin_round", "event_loop", "gateway", "merge",
         "cloud", "eval", "round")


def _params(device):
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.logistic import init_logistic
    return init_logistic(ArchConfig(name="lr", family="logreg",
                                    input_dim=DIM, num_classes=CLASSES),
                         seed=0, device=device)


def _cfg():
    from repro_torch.hier import HierConfig
    return HierConfig(aggregator="hier_contextual", lr=0.1, mu=0.0,
                      batch_size=8, min_epochs=1, max_epochs=1)


def _dataset(n_dev: int):
    from repro_torch.data import VirtualFleetDataset
    return VirtualFleetDataset(num_devices=n_dev, samples_per_device=SAMPLES,
                               dim=DIM, num_classes=CLASSES, seed=3)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def span_split(tracker) -> List[Dict[str, float]]:
    """Per round, ``{span name: summed wall ms}`` of the ``SPANS`` spans
    (children close before their round, so a round's bucket ends at it)."""
    from repro_torch.obs.spans import span_fields
    rounds, bucket = [], {}
    for e in tracker.span_events():
        f = span_fields(e)
        if f["name"] not in SPANS:
            continue
        bucket[f["name"]] = bucket.get(f["name"], 0.0) + f["dur_wall_s"] * 1e3
        if f["name"] == "round":
            rounds.append(bucket)
            bucket = {}
    return rounds


def _warm(split: List[Dict[str, float]]) -> Dict[str, float]:
    """Each span's median over the warm rounds (all but the first), and
    ``eval`` from the last round, the one that evaluates."""
    warm = split[1:] or split
    out = {name: statistics.median(r.get(name, 0.0) for r in warm)
           for name in SPANS if name != "eval"}
    out["eval"] = split[-1].get("eval", 0.0)
    return out


def run_fleet(n_dev: int, rounds: int, params, device: str = "cuda",
              tracker=None, publish_fn=None):
    """One fleet run as the reference bench runs it; returns its result."""
    from repro_torch.edge import array_bimodal_fleet
    from repro_torch.fl import run_hier_simulation
    from repro_torch.hier import stacked_two_tier
    from repro_torch.models.logistic import logistic_apply, logistic_loss
    from repro_torch.obs import InMemoryTracker, spans, use_tracker
    tracker = tracker if tracker is not None else InMemoryTracker()
    with use_tracker(tracker), spans.use_barrier(lambda: _sync(device)):
        return run_hier_simulation(
            f"fleet_{n_dev}", logistic_loss, logistic_apply, params,
            _dataset(n_dev), _cfg(),
            stacked_two_tier(array_bimodal_fleet(n_dev), max(4, n_dev // 500)),
            num_rounds=rounds, selection_seed=SEED, eval_every=rounds,
            scheduler_mode="cohort", rng_stream="v2",
            cohort_chunk=COHORT_CHUNK if n_dev > COHORT_CHUNK else None,
            device=device, publish_fn=publish_fn)


def fleet_record(n_dev: int, rounds: int, params, device: str = "cuda"
                 ) -> dict:
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import InMemoryTracker
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tracker = InMemoryTracker()
    snaps = []
    r = run_fleet(n_dev, rounds, params, device, tracker=tracker,
                  publish_fn=lambda t, p: snaps.append(launch_counts()))
    counts = {k: v for k, v in launch_counts().items() if v}
    # each round's own launches, from the counts as its cloud stage lands
    by_round = [{k: v - (snaps[i - 1][k] if i else 0) for k, v in snap.items()
                 if v - (snaps[i - 1][k] if i else 0)}
                for i, snap in enumerate(snaps)]
    steady = r.engine.get("steady_wall_time_per_round_s") or 0.0
    split = span_split(tracker)
    return {
        "scenario": "fleet", "fleet_size": n_dev,
        "num_gateways": max(4, n_dev // 500), "rounds": rounds,
        "devices_per_round": r.dispatched // rounds,
        "final_train_loss": r.train_loss[-1],
        "cloud_uplink_bytes": r.cloud_uplink_bytes,
        "total_bytes": r.total_bytes,
        "t_virtual_end": r.times[-1],
        "arrived": r.arrived, "dropped": r.dropped, "comm": r.comm,
        "warm_round_wall_time_ms": steady * 1e3,
        "devices_per_s": (r.dispatched / rounds) / steady if steady else 0.0,
        "peak_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if on_card else None),
        "launches": counts, "launches_by_round": by_round,
        "spans_ms": _warm(split), "spans_ms_by_round": split,
        **r.engine,
    }


def equivalence_record(rounds: int, params, device: str = "cuda") -> dict:
    """The 64-device, 4-gateway scenario down both paths: the event
    scheduler over materialized shards, the cohort scheduler over the
    virtual fleet."""
    from repro_torch.edge import array_bimodal_fleet, bimodal_fleet
    from repro_torch.fl import run_hier_simulation
    from repro_torch.hier import stacked_two_tier, two_tier_topology
    from repro_torch.models.logistic import logistic_apply, logistic_loss
    n_dev, gws = 64, 4
    ds = _dataset(n_dev)
    kw = dict(num_rounds=rounds, selection_seed=SEED, eval_every=rounds,
              rng_stream="v2", device=device)
    ev = run_hier_simulation(
        "fleet_eq_event", logistic_loss, logistic_apply, params,
        ds.materialize(device=device), _cfg(),
        two_tier_topology(bimodal_fleet(n_dev), gws), scheduler_mode="event",
        **kw)
    co = run_hier_simulation(
        "fleet_eq_cohort", logistic_loss, logistic_apply, params, ds, _cfg(),
        stacked_two_tier(array_bimodal_fleet(n_dev), gws),
        scheduler_mode="cohort", **kw)
    gap = max(abs(a - b) for a, b in zip(ev.train_loss, co.train_loss))
    return {
        "scenario": "equivalence_64", "fleet_size": n_dev,
        "num_gateways": gws, "final_train_loss": co.train_loss[-1],
        "loss_gap_vs_event": gap,
        "cloud_uplink_bytes": co.cloud_uplink_bytes,
        "bytes_equal_event_path": co.cloud_uplink_bytes
        == ev.cloud_uplink_bytes and co.total_bytes == ev.total_bytes,
        "times_equal_event_path": co.times == ev.times,
        "counts_equal_event_path": (co.arrived, co.dropped)
        == (ev.arrived, ev.dropped),
    }


def collect(rounds: int = 3, quick: bool = True, device: str = "cuda",
            full_rounds: int = FULL_ROUNDS) -> Dict[str, object]:
    """The sweep as JSON-ready records: the equivalence record, then one
    record a size (the 10⁶ one unless ``quick``)."""
    params = _params(device)
    records = [equivalence_record(rounds, params, device)]
    for n_dev in QUICK_SIZES:
        records.append(fleet_record(n_dev, rounds, params, device))
    if not quick:
        records.append(fleet_record(FULL_SIZES[-1], full_rounds, params,
                                    device))
    return {"benchmark": "torch_fleet_scale", "rounds": rounds,
            "device": device, "records": records}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from repro_torch.device import resolve_device
    resolve_device(args.device)
    out = collect(args.rounds, quick=not args.full, device=args.device)
    for rec in out["records"]:
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "spans_ms_by_round"}), flush=True)
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
