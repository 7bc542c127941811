"""Serving example on the PyTorch/CUDA port: continuous-batching decode of a
reduced architecture (the port of ``examples/serve_decode.py``).

Requests of mixed lengths stream through a
:class:`repro_torch.serve.DecodeEngine` — one persistent KV cache written
in place, slots recycled at scan-chunk boundaries, every decode step's
attention in the ``flash_decode`` kernel on a card — and a mid-flight
model publish on the :class:`repro_torch.serve.ModelBus` shows
hot-swapping without draining in-flight requests.  Dense and MoE
architectures both serve (``--arch olmoe-1b-7b``, ``deepseek-moe-16b``).

  python examples/torch_serve_decode.py --arch qwen3-14b      # on the card
  python examples/torch_serve_decode.py --arch olmoe-1b-7b --device cpu

The weights come from a seeded ``torch.Generator``, so the tokens differ
from ``examples/serve_decode.py``'s (``jax.random``).  ``EXAMPLE_SMOKE=1``
shrinks the arch and request count.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.serve import DecodeEngine, ModelBus

SMOKE = os.environ.get("EXAMPLE_SMOKE") == "1"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--slots", type=int, default=2 if SMOKE else 4)
    ap.add_argument("--requests", type=int, default=3 if SMOKE else 8)
    ap.add_argument("--prompt-len", type=int, default=8 if SMOKE else 48)
    ap.add_argument("--new-tokens", type=int, default=4 if SMOKE else 24)
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    if SMOKE:
        cfg = cfg.reduced(num_layers=1, d_model=32, vocab_size=64,
                          dtype="float32")
    params = get_model(cfg).init(0, device=device)

    bus = ModelBus(params)
    max_seq = args.prompt_len + args.new_tokens
    eng = DecodeEngine(cfg, bus, num_slots=args.slots, max_seq=max_seq,
                       scan_chunk=4 if SMOKE else 8, device=device)
    rng = np.random.default_rng(1)
    for i in range(args.requests):
        # heavy tail: every other request generates the full budget,
        # the rest finish after a couple of tokens
        new = args.new_tokens if i % 2 == 0 else max(1, args.new_tokens // 8)
        eng.submit([int(t) for t in rng.integers(0, cfg.vocab_size,
                                                 args.prompt_len)],
                   max_new=new)

    t0 = time.time()
    done = list(eng.step())                      # admit + first chunk on v0
    v1 = bus.publish(tree_map(lambda a: a * 1.01, params))
    done += eng.run()                            # rest decodes on v1
    dt = time.time() - t0

    total = sum(len(c.tokens) for c in done)
    print(f"arch={args.arch} ({cfg.name}, {cfg.family}) device={device} "
          f"slots={args.slots} requests={args.requests} "
          f"prompt={args.prompt_len}")
    print(f"decoded {total} tokens across {len(done)} requests in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s)  "
          f"swaps={eng.stats['swaps']} published_version={v1}")
    for c in sorted(done, key=lambda c: c.rid)[:4]:
        print(f"  rid={c.rid} tokens={len(c.tokens)} "
              f"model v{c.admit_version}->v{c.final_version} "
              f"ids={c.tokens[:8]}")
    if len(done) != args.requests or not eng.idle:
        raise SystemExit("not every request completed")
    if not all(len(c.tokens) >= 1 for c in done):
        raise SystemExit("a request completed without tokens")


if __name__ == "__main__":
    main()
