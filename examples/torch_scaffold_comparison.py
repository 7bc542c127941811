"""SCAFFOLD vs SCAFFOLD(Contextual) on the PyTorch/CUDA port (the port of
``examples/scaffold_comparison.py``): the paper's plug-and-run claim on a
stateful baseline it criticises (§V).

Vanilla SCAFFOLD's control variates correct client drift, but the uniform
server average still oscillates under aggressive heterogeneous local
budgets; swapping in the contextual aggregation (one line at the server:
``gram`` and ``combine`` on the card) stabilises it.

The initial parameters come from the port's ``init_logistic`` and the
mini-batches from a ``torch.Generator``, so the numbers differ from
``examples/scaffold_comparison.py``'s (which draws from ``jax.random``).

  python examples/torch_scaffold_comparison.py                # on the card
  python examples/torch_scaffold_comparison.py --device cpu

EXAMPLE_SMOKE=1 runs 6 rounds.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.data import FederatedDataset, make_synthetic
from repro_torch.fl import ServerConfig, run_scaffold
from repro_torch.models.config import ArchConfig
from repro_torch.models.logistic import (init_logistic, logistic_apply,
                                         logistic_loss)

ROUNDS = 6 if os.environ.get("EXAMPLE_SMOKE", "") == "1" else 25


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device
    xs, ys = make_synthetic(1.0, 1.0, num_devices=30, samples_per_device=60,
                            dim=60, seed=2)
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, 60)[:400], ys.reshape(-1)[:400], 10)
    params = init_logistic(ArchConfig(name="lr", family="logreg",
                                      input_dim=60, num_classes=10),
                           seed=0, device=device)

    for agg, label in (("fedavg", "SCAFFOLD"),
                       ("contextual", "SCAFFOLD(Contextual)")):
        cfg = ServerConfig(aggregator=agg, num_devices=30,
                           clients_per_round=10, lr=0.2, batch_size=10,
                           min_epochs=1, max_epochs=20)
        r = run_scaffold(label, logistic_loss, logistic_apply, params, ds,
                         cfg, num_rounds=ROUNDS, selection_seed=42,
                         device=device)
        print(f"\n=== {label} ===")
        for i in range(0, len(r.train_loss), 5):
            print(f" round {i + 1:3d}  loss={r.train_loss[i]:.4f} "
                  f"acc={r.test_acc[i]:.4f}")
        print(f" final loss={r.train_loss[-1]:.4f} acc={r.test_acc[-1]:.4f} "
              f"volatility={r.loss_volatility():.4f}")


if __name__ == "__main__":
    main()
