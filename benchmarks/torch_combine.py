#!/usr/bin/env python3
"""Time the port's ``weighted_combine`` on one CUDA card at the paths' and
model shapes, for one tree's ``repro_torch``:

    python3 benchmarks/torch_combine.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two trees can be timed in turn on one card
(parent, change, change, parent), each in its own process.  For every shape
it prints one JSON line: the CUDA-event µs per call over back-to-back calls
(median and min-max of five rounds), the host µs to issue one call (nothing
waited for), the device µs per call from ``torch.profiler``, the byte bound
at 3.35 TB/s, and the body the call took where the tree's ``combine`` has
two.  The timing helpers are ``chip_smoke.py``'s.  The line before the last
is the card's ``nvidia-smi`` name and power limit.  Exits non-zero without a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (where the shape comes from, K, n, U dtype, w dtype or None for U's)
ROWS = [("sync path", 10, 7850, "float32", None),
        ("streamed apply", 100, 7840, "float32", None),
        ("bigmodel embedding slab", 16, 8192 * 1024, "bfloat16", "float32"),
        ("bigmodel MLP slab", 16, 1024 * 4096, "bfloat16", "float32"),
        ("model", 10, 1 << 24, "bfloat16", None),
        ("model", 64, 1 << 24, "bfloat16", None),
        ("model", 64, 1 << 24, "float32", None)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_combine: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels import combine, ops
    two_bodies = hasattr(combine, "body_launches")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ops.weighted_combine(torch.zeros(8, device="cuda"),
                         torch.zeros(1, 8, device="cuda"),
                         torch.zeros(1, device="cuda"))       # build, load
    for where, K, n, u_dt, w_dt in ROWS:
        dt, wdt = getattr(torch, u_dt), getattr(torch, w_dt or u_dt)
        U = torch.randn((K, n), generator=gen, device="cuda").to(dt)
        w = torch.randn((n,), generator=gen, device="cuda").to(wdt)
        a = torch.randn((K,), generator=gen, device="cuda") / K
        reps = cs.reps_for(U.numel() * U.element_size())
        call = lambda: ops.weighted_combine(w, U, a)  # noqa: E731
        spread = cs.time_ms_spread({"ms": call}, reps, cs.TOPK_REPEATS)["ms"]
        kernels = cs.device_kernel_means(call)
        rec = {"tree": args.label, "shape": where, "K": K, "n": n,
               "dtype": u_dt, "w_dtype": w_dt or u_dt,
               "us": spread["median"] * 1e3,
               "us_min": spread["min"] * 1e3, "us_max": spread["max"] * 1e3,
               "host_us": cs.host_ms(call, reps) * 1e3,
               "device_us": sum(ms for _, ms in kernels.values()) * 1e3,
               "device_kernels": list(kernels),
               "bound_us": cs.combine_bound(K, n, dt, w_dt and wdt)[
                   "bound_ms"] * 1e3}
        if two_bodies:
            combine.reset_body_launches()
            call()
            rec["body"] = [b for b, c in combine.body_launches().items()
                           if c][0]
        print(json.dumps(rec), flush=True)
        del U, w
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: " + smi.stderr.strip(), flush=True)
    print(json.dumps({"ok": True, "tree": args.label,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
