#!/usr/bin/env python3
"""``gram``'s realigning tensor-core body (``csrc/gram_realign.cu``) on the
card: the depth of its ring, and its neighbours' bits against another tree.
Needs one CUDA card and the CUDA toolkit; imports no JAX.

    python3 benchmarks/torch_gram_realign.py [--parent DIR]

  * The ring: the shipped build (a ring of 4, each tile realigned one ahead
    beside the mma of the one before, at MT = 5, 6; a ring of 3 with the
    pass between a tile's landing and its mma elsewhere) beside two
    variants of the source built here with ``nvcc`` into their own
    libraries under ``build/gram_realign/`` and called through ctypes on
    the same grid: the ring of 4 at every MT <= 6, and the ring of 3 at
    every MT.  bf16 U and g at n = 2^24 + 3 for K across MT = 1..6, with
    the aligned twin (``gram_mma.cu`` at n = 2^24); µs a call by CUDA
    events, the best of four rounds taken in turn (30 calls each).  Every
    variant's output is checked equal to the shipped one's bit for bit.
  * ``--parent DIR`` (a copy of another tree, e.g. ``git archive`` of the
    parent commit unpacked under ``build/``): the aligned ``gram`` body and
    ``sketch``'s two tensor-core bodies on seeded inputs, through this
    tree's package and DIR's, each in its own process, compared bit for
    bit.

The last line is one JSON object with those numbers and the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "gram_realign"
KS = (1, 10, 16, 31, 32, 47, 48, 63, 64, 79, 80, 95)
AHEAD = "return realign && MT >= 5 && MT <= 6;"
VARIANTS = {"ring4_mt_le_6": "return realign && MT <= 6;",
            "ring3": "return false;"}


def seeded_outputs(path: str) -> None:
    """The aligned gram body's and sketch's tensor-core bodies' outputs on
    seeded inputs, saved to ``path`` (run with one tree's ``src`` first on
    ``sys.path``)."""
    import torch
    from repro_torch.kernels import gram, sketch
    dev = torch.device("cuda")
    out = {}

    def rnd(seed, shape, skip=0):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        numel = 1
        for s in shape:
            numel *= s
        buf = torch.randn(numel + 8, generator=g, device=dev)
        return buf.to(torch.bfloat16)[skip:skip + numel].view(*shape)

    for K, n in ((1, 4104), (10, 1 << 20), (64, 1 << 20), (100, 1 << 20),
                 (127, 4104), (64, 1 << 24)):
        U, g = rnd(K * 7 + 1, (K, n)), rnd(K * 7 + 2, (n,))
        out[f"gram {gram._body(U, g)} K={K} n={n}"] = gram.gram_cuda(U, g)
    for K, m, n, s in ((8, 1024, 1 << 16, 0), (64, 256, 1 << 20, 0),
                       (8, 1024, (1 << 20) + 3, 0),
                       (64, 256, (1 << 20) + 3, 0), (9, 129, 4104, 3),
                       (1, 17, 1001, 5)):
        U = rnd(K * 11 + 1, (K, n), s)
        R = rnd(K * 11 + 2, (m, n), 3 * s % 8)
        out[f"sketch {sketch._body(U, R)} K={K} m={m} n={n} s={s}"] = (
            sketch.sketch_apply_cuda(U, R),)
    torch.save({k: tuple(t.cpu() for t in v) for k, v in out.items()}, path)


def parent_bits(parent: Path) -> dict:
    """``{case: bitwise equal}`` of :func:`seeded_outputs` through this tree
    and through ``parent``."""
    import torch
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for tree, name in ((ROOT, "tree"), (parent, "parent")):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--outputs", str(OUT / f"{name}.pt"),
             "--src", str(tree / "src")], env=dict(os.environ)))
    for p in procs:
        if p.wait() != 0:
            raise RuntimeError(f"outputs process failed: {p.args}")
    a = torch.load(OUT / "tree.pt")
    b = torch.load(OUT / "parent.pt")
    return {k: all(torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a}


def build_variant(name: str, ahead: str) -> ctypes.CDLL:
    """``gram_realign.cu`` alone with ``ahead_of`` returning ``ahead``."""
    from repro_torch.kernels import _build
    src = OUT / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    text = (src / "gram_mma.cuh").read_text()
    if AHEAD not in text:
        raise RuntimeError("gram_mma.cuh's ahead_of changed: edit AHEAD")
    (src / "gram_mma.cuh").write_text(text.replace(AHEAD, ahead))
    lib = src / "lib.so"
    done = subprocess.run([_build.find_nvcc(), *_build.CFLAGS, "-shared",
                           "-o", str(lib), str(src / "gram_realign.cu")],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{done.stdout}"
                           f"{done.stderr}")
    cdll = ctypes.CDLL(str(lib))
    cdll.gram_realign_launch.argtypes = _build._SIGNATURES[
        "gram_realign_launch"]
    return cdll


def ring_times() -> dict:
    import torch
    from repro_torch.kernels import _build, gram
    dev = torch.device("cuda")
    libs = {name: build_variant(name, ahead)
            for name, ahead in VARIANTS.items()}

    def variant(lib, U, g):
        K, n = U.shape
        per_sm, _ = gram.mma_launch_config(K, 0)
        blocks, cols = gram.grid(n, _build.sm_count(0), per_sm)
        part = torch.empty(blocks * gram.mma_rows(K) ** 2, device=dev)
        out = torch.empty(K * K + K, device=dev)
        rc = lib.gram_realign_launch(
            U.data_ptr(), g.data_ptr(), part.data_ptr(), part.numel(),
            out.data_ptr(), out[K * K:].data_ptr(), K, n, blocks, cols,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gram_realign_launch: CUDA error {rc}")
        return out[:K * K].view(K, K), out[K * K:]

    def event_us(fn, reps=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps * 1e3

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = {}
    for K in KS:
        n = (1 << 24) + 3
        U = torch.randn(K, n, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
        Ua = torch.randn(K, n - 3, generator=gen,
                         device=dev).to(torch.bfloat16)
        ga = torch.randn(n - 3, generator=gen, device=dev).to(torch.bfloat16)
        fns = {"shipped": lambda: gram.gram_cuda(U, g),
               **{name: (lambda lib=lib: variant(lib, U, g))
                  for name, lib in libs.items()},
               "twin_mma": lambda: gram.gram_cuda(Ua, ga)}
        want = fns["shipped"]()
        for name in libs:
            if not all(torch.equal(x, y) for x, y in zip(want, fns[name]())):
                raise RuntimeError(f"K={K}: {name} differs from the shipped "
                                   "build")
        runs = {name: [] for name in fns}
        for rnd in range(4):
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for name in order:
                runs[name].append(event_us(fns[name]))
        best = {name: min(r) for name, r in runs.items()}
        rows[K] = dict(best, mt=gram.mma_rows(K) // 16,
                       ring4_over_ring3=best["ring4_mt_le_6"] / best["ring3"],
                       shipped_over_twin=best["shipped"] / best["twin_mma"])
        print(f"K={K} MT={rows[K]['mt']} n=2^24+3, best of 4 rounds (us): "
              + ", ".join(f"{k} {v:.1f}" for k, v in best.items())
              + f"; ring4/ring3 {rows[K]['ring4_over_ring3']:.3f}, "
              f"shipped/twin {rows[K]['shipped_over_twin']:.3f}", flush=True)
        del U, g, Ua, ga
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--outputs")
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("torch_gram_realign: no CUDA device", file=sys.stderr)
        return 2
    if args.outputs:
        seeded_outputs(args.outputs)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    result = {"device": smi, "ring": ring_times()}
    if args.parent:
        result["parent_bitwise"] = parent_bits(args.parent.resolve())
        for case, same in result["parent_bitwise"].items():
            print(f"{case}: {'bitwise equal' if same else 'DIFFERS'} "
                  "through the two trees", flush=True)
    print(json.dumps(result))
    return 0 if all(result.get("parent_bitwise", {}).values()) else 1


if __name__ == "__main__":
    sys.exit(main())
