"""Serving driver: the continuous-batching decode engine over a ModelBus
(``repro.launch.serve``).

The dense family runs on :class:`repro_torch.serve.DecodeEngine` — one
persistent KV cache, requests admitted into free slots and retired at
chunk boundaries, every decode step's attention in the ``flash_decode``
kernel on the card.  Weights are random, from a seeded ``torch.Generator``
on the device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --device cpu

``--no-reduced`` serves the full architecture (qwen3-14b: 29.5 GB of bf16
weights, one H100); ``--device cpu`` asks for the CPU (the reduced
architecture is the size for that); ``--no-greedy`` samples.  The
reference's lockstep loop for the vlm/audio families raises until those
families are ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.registry import get_model
from ..serve import DecodeEngine, ModelBus

ENGINE_FAMILIES = ("dense", "moe")


def _engine_serve(cfg, bundle, args) -> None:
    dev = resolve_device(args.device)
    params = bundle.init(0, device=dev)
    bus = ModelBus(params)
    max_seq = args.prompt_len + args.new_tokens
    eng = DecodeEngine(cfg, bus, num_slots=args.slots, max_seq=max_seq,
                       scan_chunk=args.scan_chunk, greedy=args.greedy,
                       device=dev)
    rng = np.random.default_rng(1)
    for _ in range(args.requests):
        eng.submit([int(t) for t in rng.integers(0, cfg.vocab_size,
                                                 args.prompt_len)],
                   max_new=args.new_tokens)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    total = sum(len(c.tokens) for c in done)
    print(f"arch={cfg.name} device={dev} slots={args.slots} "
          f"requests={args.requests} prompt={args.prompt_len} "
          f"new={args.new_tokens} greedy={args.greedy} "
          f"window={cfg.sliding_window}")
    print(f"engine: {dt:.2f}s  {total} tokens  "
          f"({total / max(dt, 1e-9):.1f} tok/s)  "
          f"decode_steps={eng.stats['decode_steps']} "
          f"prefill_chunks={eng.stats['prefill_chunks']}")
    first = min(done, key=lambda c: c.rid)
    print("first sequence:", first.tokens[:16])


def _lockstep_serve(cfg, bundle, args) -> None:
    raise NotImplementedError(
        f"the lockstep serving loop for the {cfg.family!r} family waits for "
        "that family's port (reference: repro.launch.serve with "
        "repro.models.{rwkv,ssd,encdec,vlm}; ROADMAP queue 1)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--greedy", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--slots", type=int, default=4,
                    help="engine decode slots")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--scan-chunk", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    bundle = get_model(cfg)
    if cfg.family in ENGINE_FAMILIES:
        _engine_serve(cfg, bundle, args)
    else:
        _lockstep_serve(cfg, bundle, args)


if __name__ == "__main__":
    main()
