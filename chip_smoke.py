#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. setup   — the card's name and power limit, a fresh ``nvcc`` build of the
     kernels from ``src/repro_torch/kernels/csrc`` (build seconds, the
     ``ptxas -v`` registers per kernel, and the dynamic shared memory and
     resident blocks per SM each launch uses);
  2. kernels — ``gram`` and ``combine`` against their plain PyTorch versions
     on the card at the main path's shape, a ragged small set and model
     widths (f32 and bf16): max |err| within the stated tolerance, two
     ``gram`` calls bitwise equal, and CUDA-event times of the kernel, the
     plain version and a one-call PyTorch yardstick beside the bound;
  3. path    — ``run_simulation`` at paper-logreg width (784 → 10) on
     MNIST-like data over 100 devices, contextual then FedAvg, with the
     launch counters showing that every round went through the kernels and
     never through the plain versions; one round is also held against the
     same round on the CPU.

The last lines are one ``{"kernels": [...]}`` JSON object, the
``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device": ...}``.
Matmuls run in full f32 (TF32 off) so the plain ``gram`` is a fair reference.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
F32_CUDA_CORE_FLOPS = 67e12

# tolerances on max |kernel - plain| relative to max(1, max |plain|):
# f32 and bf16 inputs both accumulate in f32, so gram's two sides differ by
# summation order only (the reference's own kernel tests use 1e-4); combine's
# f32 output likewise (1e-5), its bf16 output by up to one bf16 rounding
# (the reference's tests use 3e-2)
TOL = {("gram", "float32"): 1e-4, ("gram", "bfloat16"): 1e-4,
       ("combine", "float32"): 1e-5, ("combine", "bfloat16"): 3e-2}

PATH_SHAPE = (10, 7850)        # K clients x paper-logreg parameters (784·10 + 10)
RAGGED = [(K, n) for K in (1, 3, 10) for n in (1, 130, 7850)]
MODEL = [(K, n) for K in (10, 64) for n in ((1 << 20) + 3, 1 << 24)]

PATH_ROUNDS = 8
PATH_CFG = dict(num_devices=100, clients_per_round=10, lr=0.05,
                batch_size=10, min_epochs=1, max_epochs=20)


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ timing

def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device ms per call over ``reps`` back-to-back calls (CUDA events,
    after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reps_for(nbytes: int) -> int:
    return 200 if nbytes < (1 << 24) else 20


# ----------------------------------------------------------------- kernels

def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def gram_bound(K: int, n: int, dt) -> dict:
    import torch
    size = torch.finfo(dt).bits // 8
    nbytes = (K + 1) * n * size + (K * K + K) * 4
    flops = 2 * n * (K * (K + 1) // 2 + K)   # upper triangle of G, and c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[_dtype_name(dt)] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "f32_cuda_core_ms": flops / F32_CUDA_CORE_FLOPS * 1e3}


def combine_bound(K: int, n: int, dt) -> dict:
    import torch
    size = torch.finfo(dt).bits // 8
    nbytes = K * n * size + 2 * n * size + K * 4
    flops = 2 * K * n + n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[_dtype_name(dt)] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _scale(t) -> float:
    return max(1.0, float(t.float().abs().max()))


def check_gram(K: int, n: int, dt, gen, timed: bool = True) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    U = torch.randn((K, n), generator=gen, device="cuda").to(dt)
    g = torch.randn((n,), generator=gen, device="cuda").to(dt)
    G, c = ops.gram_and_cross(U, g, backend="cuda")
    G2, c2 = ops.gram_and_cross(U, g, backend="cuda")
    Gr, cr = ref.gram_ref(U, g)
    torch.cuda.synchronize()
    need(G.shape == (K, K) and c.shape == (K,) and G.dtype == torch.float32,
         f"gram K={K} n={n}: output shapes {tuple(G.shape)}, {tuple(c.shape)}")
    bitwise = bool(torch.equal(G, G2) and torch.equal(c, c2))
    need(bitwise, f"gram K={K} n={n} {dt}: two calls differ bitwise")
    err = max(_max_err(G, Gr) / _scale(Gr), _max_err(c, cr) / _scale(cr))
    abs_err = max(_max_err(G, Gr), _max_err(c, cr))
    tol = TOL[("gram", _dtype_name(dt))]
    need(err <= tol, f"gram K={K} n={n} {dt}: relative err {err:.3e} > {tol}")
    rec = {"K": K, "n": n, "dtype": _dtype_name(dt), "max_abs_err": abs_err,
           "rel_err": err, "tolerance": tol, "bitwise_repeatable": bitwise}
    if timed:
        reps = reps_for(U.numel() * U.element_size())
        rec["ms"] = time_ms(lambda: ops.gram_and_cross(U, g, backend="cuda"), reps)
        rec["plain_ms"] = time_ms(lambda: ref.gram_ref(U, g), reps)
        rec["library_ms"] = time_ms(lambda: (U @ U.T, U @ g), reps)
        rec.update(gram_bound(K, n, dt))
    return rec


def check_combine(K: int, n: int, dt, gen, timed: bool = True) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    U = torch.randn((K, n), generator=gen, device="cuda").to(dt)
    w = torch.randn((n,), generator=gen, device="cuda").to(dt)
    a = torch.randn((K,), generator=gen, device="cuda") / K
    out = ops.weighted_combine(w, U, a, backend="cuda")
    outr = ref.combine_ref(w, U, a)
    torch.cuda.synchronize()
    need(out.shape == (n,) and out.dtype == w.dtype,
         f"combine K={K} n={n}: output {tuple(out.shape)} {out.dtype}")
    err = _max_err(out, outr) / _scale(outr)
    tol = TOL[("combine", _dtype_name(dt))]
    need(err <= tol, f"combine K={K} n={n} {dt}: relative err {err:.3e} > {tol}")
    rec = {"K": K, "n": n, "dtype": _dtype_name(dt),
           "max_abs_err": _max_err(out, outr), "rel_err": err, "tolerance": tol}
    if timed:
        reps = reps_for(U.numel() * U.element_size())
        a_lib = a.to(dt)
        rec["ms"] = time_ms(lambda: ops.weighted_combine(w, U, a, backend="cuda"), reps)
        rec["plain_ms"] = time_ms(lambda: ref.combine_ref(w, U, a), reps)
        rec["library_ms"] = time_ms(lambda: torch.addmv(w, U.T, a_lib), reps)
        rec.update(combine_bound(K, n, dt))
    return rec


def kernels_phase() -> dict:
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {"gram": [], "combine": []}
    f32, bf16 = torch.float32, torch.bfloat16
    K, n = PATH_SHAPE
    for name, check in (("gram", check_gram), ("combine", check_combine)):
        out[name].append(dict(check(K, n, f32, gen), set="path"))
        for Kr, nr in RAGGED:
            for dt in (f32, bf16):
                out[name].append(dict(check(Kr, nr, dt, gen, timed=False),
                                      set="ragged"))
        for Km, nm in MODEL:
            for dt in (f32, bf16):
                rec = dict(check(Km, nm, dt, gen), set="model")
                out[name].append(rec)
                torch.cuda.empty_cache()
        for rec in out[name]:
            if "ms" in rec:
                log(f"{name:8s} {rec['set']:6s} K={rec['K']:3d} n={rec['n']:9d} "
                    f"{rec['dtype']:9s} err={rec['max_abs_err']:.3e} "
                    f"kernel={rec['ms']*1e3:9.1f}us plain={rec['plain_ms']*1e3:9.1f}us "
                    f"library={rec['library_ms']*1e3:9.1f}us "
                    f"bound={rec['bound_ms']*1e3:8.1f}us ({rec['bound_by']})")
        ragged = [r for r in out[name] if r["set"] == "ragged"]
        log(f"{name:8s} ragged: {len(ragged)} shapes within tolerance, "
            f"worst rel err {max(r['rel_err'] for r in ragged):.3e}")
    return out


# -------------------------------------------------------------------- path

def path_data():
    from repro_torch.data import make_federated, make_mnist_like
    x, y = make_mnist_like(num_samples=6000, seed=0)
    return make_federated(x, y, num_devices=PATH_CFG["num_devices"],
                          num_classes=10, concentration=0.5, seed=0)


def round_vs_cpu(ds, params) -> float:
    """One contextual round on the card against the same round on the CPU
    (plain versions), with the same mini-batch indices; returns the max
    |Δ new params| relative to max |new params|."""
    import numpy as np
    import torch
    from repro_torch.core.flatten import tree_map, tree_to_vector
    from repro_torch.fl import (ServerConfig, build_round_fn, init_server,
                                sample_round)
    from repro_torch.fl.client import draw_batch_indices
    from repro_torch.models.logistic import logistic_loss
    cfg = ServerConfig(aggregator="contextual", **PATH_CFG)
    m = ds.samples_per_device
    max_steps = cfg.max_epochs * max(m // cfg.batch_size, 1)
    sel, grad_sel, num_steps = sample_round(np.random.RandomState(7), cfg,
                                            max(m // cfg.batch_size, 1))
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(7)
    mask = torch.as_tensor(ds.mask)[torch.as_tensor(sel, dtype=torch.long)]
    idx = draw_batch_indices(mask, max_steps, cfg.batch_size, cpu_gen)
    news = []
    for dev in ("cuda", "cpu"):
        data = (torch.as_tensor(ds.x, device=dev),
                torch.as_tensor(ds.y, dtype=torch.long, device=dev),
                torch.as_tensor(ds.mask, device=dev))
        state = init_server(tree_map(lambda p: p.to(dev), params))
        fn = build_round_fn(logistic_loss, cfg, m, device=dev)
        new_state, _ = fn(state, data, sel, grad_sel, num_steps,
                          batch_idx=idx.to(dev))
        news.append(tree_to_vector(new_state.params).cpu())
    return _max_err(news[0], news[1]) / _scale(news[1])


def path_phase() -> dict:
    """Drive the paper-logreg path; returns its launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fl import ServerConfig, run_simulation
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import get_model
    from repro_torch.models.logistic import logistic_apply, logistic_loss
    from repro_torch.obs import InMemoryTracker, use_tracker
    from repro_torch.obs.spans import span_fields

    cfg_model = get_config("paper-logreg")
    ds = path_data()
    params = get_model(cfg_model).init(0, device="cuda")
    n = sum(p.numel() for p in params.values())
    need(n == 7850, f"paper-logreg has {n} parameters, expected 7850")
    log(f"path: paper-logreg n={n}, {ds.num_devices} devices x "
        f"{ds.samples_per_device} samples, K={PATH_CFG['clients_per_round']}, "
        f"{PATH_ROUNDS} rounds per aggregator")

    runs, counts = {}, {}
    for agg in ("contextual", "fedavg"):
        cfg = ServerConfig(aggregator=agg, **PATH_CFG)
        tracker = InMemoryTracker()
        torch.cuda.synchronize()
        reset_launch_counts()
        with use_tracker(tracker):
            res = run_simulation(agg, logistic_loss, logistic_apply, params,
                                 ds, cfg, num_rounds=PATH_ROUNDS,
                                 selection_seed=42, device="cuda")
        torch.cuda.synchronize()
        counts[agg] = launch_counts()
        round_ms = [span_fields(e)["dur_wall_s"] * 1e3
                    for e in tracker.span_events()
                    if span_fields(e)["name"] == "round"]
        runs[agg] = res
        need(np.isfinite(res.train_loss).all(),
             f"{agg}: non-finite losses {res.train_loss}")
        log(f"path {agg:10s} loss {res.train_loss[0]:.4f} -> "
            f"{res.train_loss[-1]:.4f}  acc {res.test_acc[-1]:.4f}  "
            f"round ms median {statistics.median(round_ms):.2f} "
            f"(first {round_ms[0]:.2f}, all {[round(r, 2) for r in round_ms]})"
            f"  launches {counts[agg]}")

    ctx, avg = counts["contextual"], counts["fedavg"]
    need(runs["contextual"].train_loss[-1] < runs["contextual"].train_loss[0],
         f"contextual loss did not fall: {runs['contextual'].train_loss}")
    need(ctx["gram/cuda"] >= PATH_ROUNDS,
         f"gram/cuda launched {ctx['gram/cuda']} times in {PATH_ROUNDS} "
         "contextual rounds")
    for agg, cnt in counts.items():
        need(cnt["combine/cuda"] >= PATH_ROUNDS,
             f"combine/cuda launched {cnt['combine/cuda']} times in "
             f"{PATH_ROUNDS} {agg} rounds")
        need(cnt["gram/torch"] == 0 and cnt["combine/torch"] == 0,
             f"{agg}: plain versions ran on the path: {cnt}")

    rel = round_vs_cpu(ds, params)
    log(f"path: one contextual round, card vs CPU, max rel err of new "
        f"params {rel:.3e} (tolerance 1e-4)")
    need(rel <= 1e-4, f"card round disagrees with the CPU round: {rel:.3e}")
    return {k: ctx[k] + avg[k] for k in ctx}


# -------------------------------------------------------------------- main

def setup_phase() -> str:
    import torch
    from repro_torch.kernels import _build, gram
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    need(smi.returncode == 0 and smi.stdout.strip(),
         f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(smi_line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = _build.build(force=True)
    log(f"build: {len(_build.sources())} sources -> {lib.relative_to(ROOT)} "
        f"in {time.perf_counter() - t0:.2f} s")
    for line in _build.ptxas_log().splitlines():
        if ("Compiling entry function" in line or "registers" in line
                or line.startswith("==")):
            log("ptxas: " + line.strip())
    _build.load_library()
    for K in (PATH_SHAPE[0], 64):
        for dt in ("f32", "bf16"):
            per_sm, smem = gram.launch_config(K, dt == "bf16", dt == "bf16", 0)
            log(f"launch: gram partial K={K} {dt}: {smem} B dynamic shared "
                f"memory per block, {per_sm} blocks per SM; gram finish: 0 B; "
                f"combine: 4*K = {4 * K} B (alpha)")
    return smi_line


def kernel_entry(name: str, recs: list, launches: int) -> dict:
    src = {"gram": ("src/repro_torch/kernels/csrc/gram.cu",
                    "src/repro/kernels/gram.py:104"),
           "combine": ("src/repro_torch/kernels/csrc/combine.cu",
                       "src/repro/kernels/combine.py:30")}[name]
    path = next(r for r in recs if r["set"] == "path")
    return {"name": name, "route": "cuda", "source": src[0], "replaces": src[1],
            "launches": launches, "max_abs_err": path["max_abs_err"],
            "ms": path["ms"], "plain_ms": path["plain_ms"],
            "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
            "library_ms": path["library_ms"],
            "shape": {"K": path["K"], "n": path["n"], "dtype": path["dtype"]},
            "tolerance": path["tolerance"],
            "max_rel_err_all_shapes": max(r["rel_err"] for r in recs),
            "shapes": [r for r in recs if "ms" in r]}


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    try:
        smi_line = setup_phase()
        kern = kernels_phase()
        launches = path_phase()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    entries = [kernel_entry(name, kern[name], launches[f"{name}/cuda"])
               for name in ("gram", "combine")]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
