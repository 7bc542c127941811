"""Compressed hierarchical FL on the PyTorch/CUDA port: sketched gateway
summaries + error feedback (the port of ``examples/edge_compressed.py``).

The uncompressed hierarchy already cut cloud uplink from O(K·n) to O(P·n)
by shipping one contextual summary per gateway — but ū_g and ĝ_g still
rode at full model width.  Here each gateway EF-compresses both vectors
(top-k with a 75/25 ū/ĝ byte split) before the backhaul hop: the cloud's
P×P contextual solve runs on the sketched cross-terms and applies exactly
the decoded updates, while per-gateway error-feedback residuals re-inject
everything the wire dropped.  The demo shows ≥4× *further* cloud-uplink
reduction over the uncompressed hierarchy at <3% final-loss gap — and a
linear-sketch variant (SRHT) whose Gram stage never touches an n-vector.

The initial parameters come from the port's ``init_logistic`` and the
mini-batch draws from a ``torch.Generator``, so the numbers differ from
``examples/edge_compressed.py``'s (which draws from ``jax.random``); the
bytes and the expected margins are the same.

  python examples/torch_edge_compressed.py                # on the card
  python examples/torch_edge_compressed.py --device cpu

EXAMPLE_SMOKE=1 runs a tiny-step variant (CI keeps examples from rotting).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.compress import CompressConfig
from repro_torch.data import FederatedDataset, make_synthetic
from repro_torch.edge import bimodal_fleet
from repro_torch.fl import run_hier_simulation
from repro_torch.hier import HierConfig, two_tier_topology
from repro_torch.models.config import ArchConfig
from repro_torch.models.logistic import (init_logistic, logistic_apply,
                                         logistic_loss)

SMOKE = os.environ.get("EXAMPLE_SMOKE", "") == "1"
DIM, N_DEV, N_GW, SEED = 60, 64, 4, 42
ROUNDS, EVAL_EVERY = (5, 2) if SMOKE else (20, 2)


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
    topo = two_tier_topology(fleet, N_GW)
    print(f"fleet — {fleet.describe()}")
    print(f"tree  — {topo.describe()}")

    base = dict(lr=0.2, batch_size=10, min_epochs=1, max_epochs=10)
    runs = {
        "hier": HierConfig(aggregator="hier_contextual", **base),
        "hier+topk": HierConfig(
            aggregator="hier_contextual_sketch",
            compress=CompressConfig(scheme="topk", ratio=3.4, u_frac=0.75),
            **base),
        "hier+srht": HierConfig(
            aggregator="hier_contextual_sketch",
            compress=CompressConfig(scheme="srht", ratio=4.0), **base),
        "hier+lowrank": HierConfig(
            aggregator="hier_contextual_sketch",
            compress=CompressConfig(scheme="lowrank", ratio=8.0,
                                    u_frac=0.75), **base),
    }
    results = {}
    for name, cfg in runs.items():
        results[name] = run_hier_simulation(
            name, logistic_loss, logistic_apply, params, ds, cfg, topo,
            num_rounds=ROUNDS, selection_seed=SEED, eval_every=EVAL_EVERY,
            device=args.device)

    header = ("method          final_loss  final_acc  cloud_uplink  "
              "vs_hier")
    print(f"\n{header}\n{'-' * len(header)}")
    hier = results["hier"]
    for name, r in results.items():
        print(f"{name:<15s} {r.train_loss[-1]:10.4f} {r.test_acc[-1]:10.3f} "
              f"{r.cloud_uplink_bytes / 1e6:10.3f}MB "
              f"{hier.cloud_uplink_bytes / r.cloud_uplink_bytes:6.1f}x")

    best = results["hier+topk"]
    gap = abs(best.train_loss[-1] - hier.train_loss[-1]) / hier.train_loss[-1]
    savings = hier.cloud_uplink_bytes / best.cloud_uplink_bytes
    print(f"\nhier+topk final loss is within {gap * 100:.1f}% of the "
          f"uncompressed hierarchy\ncloud-uplink bytes: {savings:.1f}x fewer "
          f"again ({hier.cloud_uplink_bytes / 1e6:.3f}MB -> "
          f"{best.cloud_uplink_bytes / 1e6:.3f}MB)")
    if gap < 0.03 and savings >= 4.0 and not SMOKE:
        print("ACCEPTANCE: loss within 3% AND >=4x fewer cloud-uplink bytes "
              "than the uncompressed hier - PASS")
    elif not SMOKE:
        print("WARNING: acceptance criterion not met on this seed - inspect "
              "the table above.")
    print("\nEach gateway kept its Gram block and alpha at home, EF-"
          "compressed (u_bar_g, g_hat_g)\nand shipped only the payload; the "
          "cloud solved the PxP stage on sketched\ncross-terms and applied "
          "the decoded combinations - what the wire dropped,\nper-gateway "
          "error feedback re-injected the next round.")


if __name__ == "__main__":
    main()
