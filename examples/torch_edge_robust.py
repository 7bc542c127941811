"""Adversarial edge FL on the PyTorch/CUDA port: robust contextual solves
under attack and churn (the port of ``examples/edge_robust.py``).

A 64-device fleet with 20% of its devices compromised runs Byzantine noise
replacement (each malicious client reports Gaussian updates AND gradients
at 25x its honest norm) while a churn wave knocks half the fleet offline
mid-run.  On identical seeds it compares:

  * plain contextual aggregation — the poisoned gradient columns corrupt
    the shared ĝ estimate and with it every honest client's c-term;
  * robust contextual (``contextual_mom``) — per-client update clipping
    plus median-of-means pooling on the (G, c) cross-term slots before the
    same solve (on a card: ``gram`` for G, ``gram_block`` for the cross
    matrix, ``combine`` for the step);
  * FedAvg — the undefended baseline, and krum / coordinate-median — the
    classical robust baselines.

The initial parameters come from the port's ``init_logistic`` and the
mini-batch and attack draws from ``torch.Generator``s, so the numbers
differ from ``examples/edge_robust.py``'s (which draws from ``jax.random``);
the expected margins are the same.

  python examples/torch_edge_robust.py                # on the card
  python examples/torch_edge_robust.py --device cpu

EXAMPLE_SMOKE=1 runs a few rounds only.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.data import FederatedDataset, make_synthetic
from repro_torch.edge import uniform_fleet
from repro_torch.fl import ServerConfig, run_hier_simulation, run_simulation
from repro_torch.hier import HierConfig, two_tier_topology
from repro_torch.models.config import ArchConfig
from repro_torch.models.logistic import (init_logistic, logistic_apply,
                                         logistic_loss)
from repro_torch.robust import (ByzantineGauss, RobustConfig,
                                assign_adversaries, churn_schedule)

SMOKE = os.environ.get("EXAMPLE_SMOKE", "") == "1"
DIM, N_DEV, N_GW, SEED = 20, 64, 4, 42
ROUNDS = 4 if SMOKE else 12
ATTACK = ByzantineGauss(scale=25.0)
ROBUST = RobustConfig(clip=2.0, pool="mom")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    xs, ys = make_synthetic(1.0, 1.0, num_devices=N_DEV,
                            samples_per_device=30, dim=DIM, seed=5)
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, DIM)[:400], ys.reshape(-1)[:400], 10)
    params = init_logistic(ArchConfig(name="logreg", family="logreg",
                                      input_dim=DIM, num_classes=10), 0,
                           device=args.device)
    fleet = assign_adversaries(uniform_fleet(N_DEV), 0.2, seed=3)
    print(f"fleet — {fleet.num_devices} devices, "
          f"{len(fleet.malicious)} compromised: {fleet.malicious}")
    print(f"attack — {ATTACK.name} at {ATTACK.scale:g}x the honest norm\n")

    methods = (("contextual", None), ("contextual_mom", ROBUST),
               ("fedavg", None), ("krum", RobustConfig()),
               ("coordinate_median", None))

    def flat(agg, rob, attack):
        cfg = ServerConfig(aggregator=agg, num_devices=N_DEV,
                           clients_per_round=16, lr=0.2, batch_size=10,
                           min_epochs=1, max_epochs=4, attack=attack,
                           malicious=fleet.malicious if attack else (),
                           robust=rob)
        tag = f"{agg}-{'byz' if attack else 'clean'}"
        return run_simulation(tag, logistic_loss, logistic_apply, params,
                              ds, cfg, num_rounds=ROUNDS,
                              selection_seed=SEED, eval_every=ROUNDS,
                              device=args.device)

    header = "method              clean_loss  attacked   inflation"
    print(f"{header}\n{'-' * len(header)}")
    inflations = {}
    for agg, rob in methods:
        clean = flat(agg, rob, None).train_loss[-1]
        atk = flat(agg, rob, ATTACK).train_loss[-1]
        inflations[agg] = atk / clean
        print(f"{agg:<18s} {clean:10.4f} {atk:10.4f} "
              f"{inflations[agg]:9.2f}x")

    # hierarchical: the same robust statistics inside every gateway/cloud
    # tier solve, with a churn wave taking 50% of the fleet offline
    hcfg = HierConfig(aggregator="hier_contextual", lr=0.2, batch_size=10,
                      min_epochs=1, max_epochs=4, robust=ROBUST)
    topo = two_tier_topology(fleet, N_GW)
    clean_h = run_hier_simulation("hier-clean", logistic_loss, logistic_apply,
                                  params, ds, hcfg, topo, num_rounds=ROUNDS,
                                  selection_seed=SEED, eval_every=ROUNDS,
                                  device=args.device)
    churn = churn_schedule("wave", N_DEV, clean_h.times[-1], seed=1)
    byz_h = run_hier_simulation("hier-byz-churn", logistic_loss,
                                logistic_apply, params, ds, hcfg, topo,
                                num_rounds=ROUNDS, selection_seed=SEED,
                                eval_every=ROUNDS, attack=ATTACK, churn=churn,
                                device=args.device)
    h_infl = byz_h.train_loss[-1] / clean_h.train_loss[-1]
    print(f"\nhier robust ({N_GW} gateways) under attack + 50% churn wave: "
          f"loss {clean_h.train_loss[-1]:.4f} -> {byz_h.train_loss[-1]:.4f} "
          f"({h_infl:.2f}x), {byz_h.dropped} tasks dropped")

    ok = (inflations["contextual_mom"] <= 1.15
          and inflations["contextual"] >= 1.2
          and inflations["fedavg"] >= 1.5)
    if ok and not SMOKE:
        print("\nACCEPTANCE: robust contextual within 15% of clean while "
              "plain contextual\nand FedAvg degrade - PASS")
    elif not SMOKE:
        print("\nWARNING: expected margins not met on this seed - inspect "
              "the table above.")
    print("\nThe poisoned gradient columns corrupt the shared g_hat estimate "
          "and with it\nevery honest client's c-term; clipping bounds each "
          "row's leverage and the\nmedian-of-means pool re-estimates c from "
          "the cross-term columns, so the\nsame contextual solve prices "
          "honest updates as if the attackers were absent.")


if __name__ == "__main__":
    main()
