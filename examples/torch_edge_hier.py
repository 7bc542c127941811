"""Hierarchical edge FL on the PyTorch/CUDA port: gateway Gram summaries vs
flat uplink (the port of ``examples/edge_hier.py``).

A 64-device bimodal fleet sits behind 4 gateways.  Flat contextual
aggregation ships every raw update to the cloud — O(K·n) uplink per round.
The hierarchical runtime has each gateway run the paper's contextual solve
on its own cohort and forward only a composable summary (G_g, c_g, α_g,
ū_g, ĝ_g) — O(P·n) uplink — while the cloud solves the P×P stage over the
gateway combinations.  The demo shows the hierarchy tracks the flat
contextual loss (within 5%) while cutting cloud-uplink bytes ≥5×.

The initial parameters come from the port's ``init_logistic`` and the
mini-batch draws from a ``torch.Generator``, so the numbers differ from
``examples/edge_hier.py``'s (which draws from ``jax.random``); the bytes and
the expected margins are the same.

  python examples/torch_edge_hier.py                # on the card
  python examples/torch_edge_hier.py --device cpu

EXAMPLE_SMOKE=1 runs a tiny-step variant (CI keeps examples from rotting).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.data import FederatedDataset, make_synthetic
from repro_torch.edge import bimodal_fleet
from repro_torch.fl import run_hier_simulation
from repro_torch.hier import HierConfig, star_topology, two_tier_topology
from repro_torch.models.config import ArchConfig
from repro_torch.models.logistic import (init_logistic, logistic_apply,
                                         logistic_loss)

SMOKE = os.environ.get("EXAMPLE_SMOKE", "") == "1"
DIM, N_DEV, N_GW, SEED = 60, 64, 4, 42
ROUNDS, EVAL_EVERY = (5, 2) if SMOKE else (30, 2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    xs, ys = make_synthetic(1.0, 1.0, num_devices=N_DEV, samples_per_device=60,
                            dim=DIM, seed=2)
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, DIM)[:400], ys.reshape(-1)[:400], 10)
    params = init_logistic(ArchConfig(name="logreg", family="logreg",
                                      input_dim=DIM, num_classes=10), 0,
                           device=args.device)
    fleet = bimodal_fleet(N_DEV, slowdown=10.0, dropout_slow=0.05, seed=0)
    flat_topo = star_topology(fleet)
    hier_topo = two_tier_topology(fleet, N_GW)
    print(f"fleet — {fleet.describe()}")
    print(f"tree  — {hier_topo.describe()}")

    base = dict(lr=0.2, batch_size=10, min_epochs=1, max_epochs=10)
    runs = {
        "flat-contextual": (flat_topo, HierConfig(
            aggregator="hier_contextual", **base)),
        "hier-contextual": (hier_topo, HierConfig(
            aggregator="hier_contextual", **base)),
        "hier-fedavg": (hier_topo, HierConfig(
            aggregator="hier_fedavg", **base)),
        "hier-relay": (hier_topo, HierConfig(
            aggregator="hier_relay", **base)),
    }
    results = {}
    for name, (topo, cfg) in runs.items():
        results[name] = run_hier_simulation(
            name, logistic_loss, logistic_apply, params, ds, cfg, topo,
            num_rounds=ROUNDS, selection_seed=SEED, eval_every=EVAL_EVERY,
            device=args.device)

    header = ("method             final_loss  final_acc  cloud_uplink "
              " round_time")
    print(f"\n{header}\n{'-' * len(header)}")
    for name, r in results.items():
        print(f"{name:<18s} {r.train_loss[-1]:10.4f} {r.test_acc[-1]:10.3f} "
              f"{r.cloud_uplink_bytes / 1e6:9.2f}MB "
              f"{r.times[-1] / ROUNDS * 1e3:9.2f}ms")

    flat, hier = results["flat-contextual"], results["hier-contextual"]
    gap = abs(hier.train_loss[-1] - flat.train_loss[-1]) / flat.train_loss[-1]
    savings = flat.cloud_uplink_bytes / hier.cloud_uplink_bytes
    print(f"\nhier-contextual final loss is within {gap * 100:.1f}% of "
          f"flat-contextual\ncloud-uplink bytes: {savings:.1f}x fewer "
          f"({flat.cloud_uplink_bytes / 1e6:.2f}MB -> "
          f"{hier.cloud_uplink_bytes / 1e6:.2f}MB)")
    if gap <= 0.05 and savings >= 5.0:
        print("ACCEPTANCE: loss within 5% AND >=5x fewer cloud-uplink bytes "
              "- PASS")
    else:
        print("WARNING: acceptance criterion not met on this seed - inspect "
              "the table above.")
    print("\nEach gateway solved its own K_g x K_g contextual system and "
          "shipped\n(G_g, c_g, alpha_g, u_bar_g, g_hat_g); the cloud solved "
          "the PxP stage over\nthe gateway combinations - the Gram "
          "statistics compose exactly, so no\ninformation the solve needs "
          "ever left the gateway tier as raw updates.")


if __name__ == "__main__":
    main()
