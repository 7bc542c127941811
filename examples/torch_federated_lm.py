"""Federated training of a transformer LM with contextual aggregation on
the port's train step (the twin of ``examples/federated_lm.py``).

Each step splits the batch into cohorts (one on the host mesh of one card
or the CPU), takes local SGD, forms the Gram on the last-layer scope and
applies the α-weighted combine.  With ``--device cpu`` it trains the
reduced olmoe-1b-7b; on the card (the default) the ~100M-parameter MoE of
``--full-100m``.  Weights come from a seeded ``torch.Generator`` and the
batches are the reference's synthetic token stream; the script asserts that
the loss falls, as the reference's does.

  python examples/torch_federated_lm.py --device cpu --steps 30
  python examples/torch_federated_lm.py --full-100m           # on the card
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import make_batches
from repro_torch.models import get_model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--aggregator", default="contextual")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    base = get_config("olmoe-1b-7b")
    if args.full_100m:
        cfg = base.with_overrides(num_layers=6, d_model=768, num_heads=12,
                                  num_kv_heads=12, d_ff=512, vocab_size=32000,
                                  num_experts=8, experts_per_token=2,
                                  dtype="float32")
    else:
        cfg = base.reduced()
    bundle = get_model(cfg)
    print(f"model: {cfg.name} ~{cfg.param_count_estimate()/1e6:.0f}M params "
          f"(MoE {cfg.num_experts}e top-{cfg.experts_per_token}) on "
          f"{args.device}")

    mesh = make_host_mesh()
    shape = InputShape("lm", "train", args.seq, args.batch)
    step = build_train_step(cfg, mesh, shape, aggregator=args.aggregator,
                            lr=0.05, remat=False)
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    params = bundle.init(gen)
    losses = []
    t0 = time.time()
    for i, batch in enumerate(make_batches(cfg, bundle, args.batch, args.seq,
                                           args.steps, device=args.device)):
        params, metrics = step(params, batch)
        losses.append(float(metrics["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"({time.time()-t0:.1f}s)", flush=True)
    assert losses[-1] < losses[0], "training must reduce loss"
    print(f"done: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({args.steps} rounds, aggregator={args.aggregator})")


if __name__ == "__main__":
    main()
