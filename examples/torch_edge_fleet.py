"""Fleet-scale edge FL on the PyTorch/CUDA port: rounds over 10⁵ simulated
devices (the port of ``examples/edge_fleet.py``).

A bimodal fleet of 100 000 devices sits behind 200 gateways, and no
per-device Python object is built: the fleet is five numpy profile vectors
(``ArrayFleet``), the tree a ``StackedTopology`` whose gateways hold flat
device-id arrays, the scheduler batch-dispatches the whole cohort with one
vectorized draw of its counter-based v2 stream, and each device's shard is
generated on the card from its id (``VirtualFleetDataset``), so memory
stays O(cohort chunk) however large the fleet.  Each gateway's contextual
solve runs the ``gram`` kernel over its 500 members.  The demo prints the
devices per second and the per-tier byte ledger, then cross-checks a
64-device slice against the per-device event scheduler.

The shards come from the port's counter-based normals and the initial
parameters from ``init_logistic``, so losses differ from
``examples/edge_fleet.py``'s; bytes and virtual times are the same.

  python examples/torch_edge_fleet.py                 # on the card
  python examples/torch_edge_fleet.py --device cpu

EXAMPLE_SMOKE=1 runs 4 096 devices for 2 rounds.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.data import VirtualFleetDataset
from repro_torch.edge import array_bimodal_fleet, bimodal_fleet
from repro_torch.fl import run_hier_simulation
from repro_torch.hier import HierConfig, stacked_two_tier, two_tier_topology
from repro_torch.models.config import ArchConfig
from repro_torch.models.logistic import (init_logistic, logistic_apply,
                                         logistic_loss)

SMOKE = os.environ.get("EXAMPLE_SMOKE", "") == "1"
N_DEV = 4_096 if SMOKE else 100_000
N_GW = max(4, N_DEV // 500)
DIM, CLASSES, SEED = 16, 4, 42
ROUNDS = 2 if SMOKE else 3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device
    ds = VirtualFleetDataset(num_devices=N_DEV, samples_per_device=16,
                             dim=DIM, num_classes=CLASSES, seed=3)
    fleet = array_bimodal_fleet(N_DEV)
    topo = stacked_two_tier(fleet, N_GW)
    params = init_logistic(ArchConfig(name="lr", family="logreg",
                                      input_dim=DIM, num_classes=CLASSES),
                           seed=0, device=device)
    cfg = HierConfig(aggregator="hier_contextual", lr=0.1, mu=0.0,
                     batch_size=8, min_epochs=1, max_epochs=1)
    print(f"fleet — {fleet.describe()}")
    print(f"tree  — {topo.describe()}")

    t0 = time.time()
    r = run_hier_simulation(
        "fleet", logistic_loss, logistic_apply, params, ds, cfg, topo,
        num_rounds=ROUNDS, selection_seed=SEED, eval_every=ROUNDS,
        scheduler_mode="cohort", rng_stream="v2",
        cohort_chunk=131_072 if N_DEV > 131_072 else None, device=device)
    wall = time.time() - t0
    steady = r.engine.get("steady_wall_time_per_round_s") or wall / ROUNDS

    print(f"\n{N_DEV} devices x {ROUNDS} rounds in {wall:.1f}s wall "
          f"({N_DEV / steady:,.0f} devices/s warm, on {device})")
    print(f"final train loss {r.train_loss[-1]:.4f}, "
          f"virtual round time {r.times[-1] / ROUNDS * 1e3:.1f}ms")
    for tier, traffic in sorted(r.comm.items()):
        print(f"  {tier}: up {traffic['bytes_up'] / 1e6:9.2f}MB   "
              f"down {traffic['bytes_down'] / 1e6:9.2f}MB")

    # cross-check: a 64-device slice of the same problem through the
    # per-device event scheduler over materialized shards lands on the same
    # losses — the fleet path is an optimization, not a new algorithm
    ds64 = VirtualFleetDataset(num_devices=64, samples_per_device=16,
                               dim=DIM, num_classes=CLASSES, seed=3)
    kw = dict(num_rounds=ROUNDS, selection_seed=SEED, eval_every=ROUNDS,
              rng_stream="v2", device=device)
    ev = run_hier_simulation("ev", logistic_loss, logistic_apply, params,
                             ds64.materialize(device=device), cfg,
                             two_tier_topology(bimodal_fleet(64), 4),
                             scheduler_mode="event", **kw)
    co = run_hier_simulation("co", logistic_loss, logistic_apply, params,
                             ds64, cfg, stacked_two_tier(
                                 array_bimodal_fleet(64), 4),
                             scheduler_mode="cohort", **kw)
    gap = max(abs(a - b) for a, b in zip(ev.train_loss, co.train_loss))
    same_t = co.times == ev.times
    print(f"\n64-device cross-check: max loss gap {gap:.2e}, "
          f"virtual times identical: {same_t}")
    if gap < 1e-5 and same_t:
        print("ACCEPTANCE: cohort path matches per-device event path - PASS")
    else:
        print("WARNING: cohort/event mismatch - inspect the numbers above.")


if __name__ == "__main__":
    main()
