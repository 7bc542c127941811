"""End-to-end FL-training driver (``repro.launch.train``).

Runs the train step (cohort-split batch → local steps → contextual or
fedavg aggregation, ``launch.steps.build_train_step``) on the host mesh:
every rank of an initialised process group, one rank (the card, or the CPU
with ``--device cpu``) without one.  Weights are random, from a seeded
``torch.Generator`` on the device; batches are the reference's synthetic
token stream, bit for bit.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --steps 3 --batch 8 --seq 128       # full width on the card

Without ``--reduced`` every layer is checkpointed (``remat="full"``), as
the reference's run.  On a mesh of ranks the step is placed
(``launch.steps.train_placement``): each rank holds its blocks of the
params (``sharding.place_params``) and takes its cohort's rows of each
batch, the ranks along ``model`` splitting the cohort's compute.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from ..configs import get_config
from ..data.synthetic import make_token_stream
from ..device import DeviceLike, resolve_device
from ..models.registry import get_model
from ..sharding import param_pspecs, place_batch, place_params
from .mesh import make_host_mesh, make_production_mesh
from .shapes import InputShape, meta_params
from .steps import build_train_step


def make_batches(cfg, bundle, batch: int, seq: int, steps: int, seed=0,
                 device: DeviceLike = "cpu") -> Iterator[Dict]:
    """Synthetic token batches (Zipf + Markov stream) for every family, the
    reference's draws bit for bit: int32 tokens, and ``image_embeds`` /
    ``frames`` from ``np.random.RandomState(step)`` in the model dtype."""
    dev = resolve_device(device)
    stream = make_token_stream(batch * seq * steps + 1, cfg.vocab_size, seed)
    for s in range(steps):
        tok = stream[s * batch * seq:(s + 1) * batch * seq].reshape(batch, seq)
        b = {"tokens": torch.from_numpy(np.ascontiguousarray(tok))}
        spec = bundle.batch_spec(batch, seq)
        for name in ("image_embeds", "frames"):
            if name in spec:
                shape, dt = spec[name]
                draw = np.random.RandomState(s).normal(0, 1, shape)
                b[name] = torch.from_numpy(draw.astype(np.float32)).to(dt)
        if "image_embeds" in spec:
            b["tokens"] = b["tokens"][:, :spec["tokens"][0][1]].contiguous()
        yield {k: v.to(dev) for k, v in b.items()}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--aggregator", default="contextual",
                    choices=["contextual", "fedavg"])
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (needs 256 ranks)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu'")
    return ap.parse_args(argv)


def run(args: argparse.Namespace,
        on_step: Optional[Callable] = None) -> Dict:
    """Train as ``main`` does, printing its lines; returns the final params,
    the per-step history (loss, α, and the step's ms: CUDA events on the
    card, the host clock on the CPU), the step function and the config.
    ``on_step(i, params, new_params, batch, metrics)``, if given, is called
    after each step, before the new params replace the old."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    bundle = get_model(cfg)
    mesh = (make_production_mesh() if args.production_mesh
            else make_host_mesh())
    shape = InputShape("custom", "train", args.seq, args.batch)
    step = build_train_step(cfg, mesh, shape, aggregator=args.aggregator,
                            lr=args.lr, local_steps=args.local_steps,
                            remat=not args.reduced)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = bundle.init(gen)
    placed = step.placement != "replicated"
    if placed:
        params = place_params(mesh, params, param_pspecs(
            cfg, meta_params(cfg), mesh, "tp"))
    print(f"arch={cfg.name} params={cfg.param_count_estimate()/1e6:.1f}M "
          f"mesh={dict(mesh.shape)} "
          + (f"placement={step.placement} " if placed else "")
          + f"aggregator={args.aggregator}", flush=True)
    history = []
    t_last = time.time()
    for i, batch in enumerate(make_batches(cfg, bundle, args.batch, args.seq,
                                           args.steps, device=dev)):
        if placed:
            batch = place_batch(mesh, batch)
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        new_params, metrics = step(params, batch)
        if dev.type == "cuda":
            ev[1].record()
            torch.cuda.synchronize(dev)
            ms = ev[0].elapsed_time(ev[1])
        else:
            ms = (time.perf_counter() - t0) * 1e3
        loss = float(metrics["loss"])
        alpha = metrics["alpha"].float().cpu().numpy()
        history.append({"loss": loss, "alpha": alpha, "ms": ms,
                        **{k: float(v) for k, v in metrics.items()
                           if k not in ("loss", "alpha")}})
        if on_step is not None:
            on_step(i, params, new_params, batch, metrics)
        params = new_params
        del new_params, metrics
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            dt = time.time() - t_last
            t_last = time.time()
            print(f"step {i:4d} loss={loss:.4f} "
                  f"alpha[mean={alpha.mean():+.4f} std={alpha.std():.4f}] "
                  f"dt={dt:.2f}s", flush=True)
    if args.checkpoint_dir:
        path = save_checkpoint(args.checkpoint_dir, args.steps, params,
                               meta={"arch": cfg.name,
                                     "aggregator": args.aggregator})
        print(f"checkpoint written: {path}", flush=True)
    return {"params": params, "history": history, "step": step, "cfg": cfg,
            "mesh": mesh}


def main(argv: Optional[List[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
