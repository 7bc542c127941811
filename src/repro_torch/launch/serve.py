"""Serving entry point (``repro.launch.serve``): the continuous-batching
decode engine over a ModelBus for the KV-cache families, the lockstep loop
for the others.

The dense and moe families run on :class:`repro_torch.serve.DecodeEngine`
— one persistent KV cache, requests admitted into free slots and retired
at chunk boundaries, every decode step's attention in the ``flash_decode``
kernel on the card.  The ssm (RWKV6, Mamba2), hybrid (Zamba2), vlm
(chameleon) and audio (whisper) families run the reference's lockstep
loop: one batched ``prefill``, then one greedy decode step per token for
every row (``--batch`` rows).  Its prompt is the reference's batch dict:
``tokens``, plus f32 ``frames`` (B, max_source_positions, d) for audio or
f32 ``image_embeds`` (B, num_image_tokens, d) for vlm, whose cache also
holds the image tokens.  Weights are random, from a seeded
``torch.Generator`` on the device, and so is the lockstep prompt.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chameleon-34b --no-reduced --prompt-len 200

``--no-reduced`` serves the full architecture (qwen3-14b: 29.5 GB of bf16
weights, deepseek-moe-16b 33.8 GB, olmoe-1b-7b 13.8 GB, rwkv6-1.6b 3.2 GB,
zamba2-1.2b 2.3 GB, whisper-large-v3 3.2 GB, chameleon-34b 68.7 GB; one
H100); ``--device cpu`` asks for the CPU (the reduced architecture is the
size for that); ``--no-greedy`` samples on the engine (the lockstep loop
is greedy, as the reference's).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.registry import get_model
from ..serve import DecodeEngine, ModelBus

ENGINE_FAMILIES = ("dense", "moe")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    _sync(dev)
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


def lockstep_max_seq(cfg, prompt_len: int, new_tokens: int) -> int:
    """Cache rows of the lockstep loop: the prompt, the new tokens and, for
    the vlm family, the image tokens ahead of them."""
    return prompt_len + new_tokens + (cfg.num_image_tokens
                                      if cfg.family == "vlm" else 0)


class LockstepRun(NamedTuple):
    tokens: torch.Tensor     # (B, new_tokens) int32, on the device
    logits: torch.Tensor     # (B, new_tokens, V): the logits each came from
    prefill_s: float
    decode_s: float


def lockstep(bundle, params, prompt: Dict[str, torch.Tensor],
             new_tokens: int, max_seq: int) -> LockstepRun:
    """The reference's lockstep loop: one batched prefill of the batch dict
    ``prompt`` (``tokens`` (B, S), plus ``frames`` or ``image_embeds``),
    then ``new_tokens - 1`` greedy decode steps for every row.  Nothing in
    the token loop waits on the device; the host clock is read after a
    synchronise at its two ends."""
    dev = prompt["tokens"].device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(params, prompt, max_seq)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    tok = logits.argmax(-1).to(torch.int32)
    toks, outs = [tok], [logits]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        logits, cache = bundle.decode(params, tok, cache)
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        outs.append(logits)
    _sync(dev)
    return LockstepRun(torch.stack(toks, 1), torch.stack(outs, 1), prefill_s,
                       time.perf_counter() - t0)


def lockstep_prompt(cfg, batch: int, prompt_len: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The reference's lockstep batch dict, from one generator seeded 0 on
    the device (``jax.random``'s draws cannot be replayed): ``tokens``
    (batch, prompt_len) int32, then for audio ``frames`` (batch,
    max_source_positions, d_model) and for vlm ``image_embeds`` (batch,
    num_image_tokens, d_model), both standard normals in f32 as
    ``jax.random.normal`` draws them (so bf16 whisper weights meet f32
    frames and the encoder runs in f32, as the reference's)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=gen, device=device,
                                   dtype=torch.int32)}
    extra = {"audio": ("frames", cfg.max_source_positions),
             "vlm": ("image_embeds", cfg.num_image_tokens)}.get(cfg.family)
    if extra is not None:
        name, rows = extra
        out[name] = torch.randn((batch, rows, cfg.d_model), generator=gen,
                                device=device, dtype=torch.float32)
    return out


def _lockstep_serve(cfg, bundle, args) -> None:
    dev = resolve_device(args.device)
    params = bundle.init(0, device=dev)
    prompt = lockstep_prompt(cfg, args.batch, args.prompt_len, dev)
    run = lockstep(bundle, params, prompt, args.new_tokens,
                   lockstep_max_seq(cfg, args.prompt_len, args.new_tokens))
    total = args.batch * (args.new_tokens - 1)
    print(f"arch={cfg.name} device={dev} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.new_tokens} "
          f"window={cfg.sliding_window}")
    print(f"prefill: {run.prefill_s:.2f}s  decode: {run.decode_s:.2f}s "
          f"({total / max(run.decode_s, 1e-9):.1f} tok/s)")
    print("first sequence:", run.tokens[0, :16].tolist())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--greedy", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--batch", type=int, default=4,
                    help="lockstep batch width (ssm/hybrid/vlm/audio)")
    ap.add_argument("--slots", type=int, default=4,
                    help="engine decode slots (dense/moe families)")
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
