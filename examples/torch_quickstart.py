"""Quickstart of the PyTorch/CUDA port: the paper in one page.

Runs 30 rounds of federated logistic regression on the heterogeneous
Synthetic(1,1) dataset with FedAvg and with the paper's contextual
aggregation through ``repro_torch``, printing loss/accuracy per round as
``examples/quickstart.py`` does.  On a card every round launches the
``combine`` kernel and every contextual round the ``gram`` kernel, and the
run also prints the median round time (the ``round`` span) beside the
card's name and power limit.

The initial parameters come from the port's own ``init_logistic`` with a
seeded ``torch.Generator``; this script imports no JAX, so they are not
the reference's ``jax.random`` draws, and its numbers differ from
``examples/quickstart.py``'s by that (and by the mini-batch draws).

  python examples/torch_quickstart.py                  # on the card
  python examples/torch_quickstart.py --device cpu --rounds 3
"""
import argparse
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.data import FederatedDataset, make_synthetic
from repro_torch.fl import ServerConfig, run_simulation
from repro_torch.models.config import ArchConfig
from repro_torch.models.logistic import (init_logistic, logistic_apply,
                                         logistic_loss)
from repro_torch.obs import InMemoryTracker, span_fields, use_tracker


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi printed nothing"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--rounds", type=int, default=30)
    args = ap.parse_args(argv)

    # Synthetic(alpha=1, beta=1): strongly heterogeneous clients (paper SIV-A1)
    xs, ys = make_synthetic(1.0, 1.0, num_devices=30, samples_per_device=60,
                            dim=60, seed=2)
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, 60)[:400], ys.reshape(-1)[:400], 10)
    model_cfg = ArchConfig(name="logreg", family="logreg", input_dim=60,
                           num_classes=10)
    params = init_logistic(model_cfg, 0, device=args.device)

    results, round_ms = {}, {}
    for agg in ("fedavg", "contextual"):
        cfg = ServerConfig(aggregator=agg, num_devices=30,
                           clients_per_round=10, lr=0.2, batch_size=10,
                           min_epochs=1, max_epochs=20)  # K=10, epochs~U[1,20]
        tracker = InMemoryTracker()
        with use_tracker(tracker):
            r = run_simulation(agg, logistic_loss, logistic_apply, params, ds,
                               cfg, num_rounds=args.rounds, selection_seed=42,
                               device=args.device)
        round_ms[agg] = [span_fields(e)["dur_wall_s"] * 1e3
                         for e in tracker.span_events()
                         if span_fields(e)["name"] == "round"]
        results[agg] = r
        print(f"\n=== {agg} ===")
        for i in range(0, len(r.train_loss), 5):
            print(f" round {i+1:3d}  loss={r.train_loss[i]:.4f} "
                  f"acc={r.test_acc[i]:.4f}")

    ra, rc = results["fedavg"], results["contextual"]
    print("\nsummary:")
    print(f"  fedavg      final loss={ra.train_loss[-1]:.4f} "
          f"acc={ra.test_acc[-1]:.4f} volatility={ra.loss_volatility():.4f}")
    print(f"  contextual  final loss={rc.train_loss[-1]:.4f} "
          f"acc={rc.test_acc[-1]:.4f} volatility={rc.loss_volatility():.4f}")
    print("\nTheorem 1 in action: contextual descends near-monotonically while"
          "\nFedAvg fluctuates under heterogeneity (paper Figs. 4-5).")
    if args.device != "cpu":
        card = _card()
        for agg, ms in round_ms.items():
            print(f"  {agg:10s} round time median {statistics.median(ms):.2f} "
                  f"ms (first {ms[0]:.2f} ms), host clock around each round "
                  f"({card})")


if __name__ == "__main__":
    main()
