#!/usr/bin/env python3
"""What bounds ``gram``'s f32 tile body (``csrc/gram_f32.cu``) on the card.
Needs one CUDA card and the CUDA toolkit; imports no JAX.

    python3 benchmarks/torch_gram_f32_calibration.py

Two measurements, each built here with ``nvcc`` into its own library under
``build/calibration/`` and called through ctypes:

  * the FFMA rate of the tile body's inner product alone: 256-thread
    blocks, two an SM, each thread 64 accumulators fed per 64 FFMA by
    nothing (operands in registers), or by 4 LDS.128 (the body's ratio,
    the next column's loaded before this one's FMAs) that are one
    broadcast address a warp, 32 consecutive float4s (conflict-free), or
    every lane's float4 two apart (2-way bank conflicts); as a share of
    the H100's 33.45 TFMA/s;
  * variants of the shipped source at the model widths (K = 16 and 32 at
    n = 6 440 960, K = 64 and 100 at n = 2^24, f32): as shipped; with the
    copies skipped (the ring keeps its zeros: the products alone, timing
    only); with the per-stage barrier skipped too; and with every launch
    held to the 256-thread budget.  µs a call by CUDA events (the mean of
    20 calls, twice in turn), and the deal's FMAs a second as a share of
    33.45 TFMA/s.

The last line is one JSON object with those numbers and the card's name
and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PEAK_FMA = 132 * 128 * 1.98e9          # H100 SXM at 700 W: 33.45 TFMA/s
OUT = ROOT / "build" / "calibration"
SHAPES = ((16, 6_440_960), (32, 6_440_960), (64, 1 << 24), (100, 1 << 24))

FFMA_CU = r"""
template <int MODE>
__global__ void __launch_bounds__(256, 2) ffma_rate(float* out, int iters) {
  __shared__ float4 sm[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    sm[i] = make_float4(1e-3f * i, 2e-3f, 3e-3f, 4e-3f);
  __syncthreads();
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;
  const int lane = threadIdx.x & 31;
  const int off = MODE == 1 ? 0 : MODE == 2 ? lane : 2 * lane;
  float4 a0 = sm[off], a1 = sm[off + 64], b0 = sm[off + 128], b1 = sm[off + 192];
#pragma unroll 2
  for (int it = 0; it < iters; ++it) {
    float4 na0 = a0, na1 = a1, nb0 = b0, nb1 = b1;
    if (MODE != 0) {
      const int o = off + ((it & 3) << 8);
      na0 = sm[o];
      na1 = sm[o + 64];
      nb0 = sm[o + 128];
      nb1 = sm[o + 192];
    }
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[r][k] = fmaf(av[r], bv[k], acc[r][k]);
    a0 = na0; a1 = na1; b0 = nb0; b1 = nb1;
  }
  float t = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) t += acc[r][k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

extern "C" int ffma_launch(float* out, int blocks, int iters, int mode) {
  switch (mode) {
    case 0: ffma_rate<0><<<blocks, 256>>>(out, iters); break;
    case 1: ffma_rate<1><<<blocks, 256>>>(out, iters); break;
    case 2: ffma_rate<2><<<blocks, 256>>>(out, iters); break;
    default: ffma_rate<3><<<blocks, 256>>>(out, iters); break;
  }
  return (int)cudaGetLastError();
}
"""
FFMA_MODES = {0: "registers only", 1: "4 LDS.128 a broadcast",
              2: "4 LDS.128 conflict-free", 3: "4 LDS.128 2-way conflicts"}

# edits of the shipped source, each asserted to apply
COPY_LOOP = "    for (int qd = warp; qd < sl.rows / 4; qd += nwarps) {"
BARRIER = ("    cp_async_wait<kStages - 2>();\n"
           "    __syncthreads();  // stage tt has landed; every thread is done "
           "with tt - 1\n")
BUDGET = ("  return row_blocks(K) == 1 && T >= 4 ? kNarrowThreads : "
          "kTileThreads;")


def variants(src: str) -> dict:
    for edit in (COPY_LOOP, BARRIER, BUDGET):
        assert edit in src, f"gram_f32.cu no longer holds {edit!r}"
    no_copies = src.replace(COPY_LOOP, COPY_LOOP.replace(
        "qd < sl.rows / 4;", "qd < sl.rows / 4 && n < 0;"))
    return {"shipped": src,
            "no copies": no_copies,
            "no copies, no barrier": no_copies.replace(BARRIER, ""),
            "256-thread budget": src.replace(BUDGET, "  return kTileThreads;")}


def build(nvcc: str, name: str, cu: str, extra=()) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    src = OUT / f"{name}.cu"
    src.write_text(cu)
    lib = OUT / f"{name}.so"
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
                    str(src), *extra], check=True)
    return ctypes.CDLL(str(lib))


def event_us(fn, reps: int) -> float:
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def f32_caller(lib, U, g):
    """One ``gram_f32_launch`` of this library on U, g, planned as
    ``kernels.gram`` plans it (its grid from this library's occupancy)."""
    import torch
    from repro_torch.kernels import _build, gram
    K, n = U.shape
    vec = gram._f32_vec(U, g)
    per_sm, smem, threads = (ctypes.c_int(), ctypes.c_int(), ctypes.c_int())
    assert lib.gram_f32_launch_config(K, int(vec), ctypes.byref(per_sm),
                                      ctypes.byref(smem),
                                      ctypes.byref(threads)) == 0
    blocks, cols = gram.grid(n, _build.sm_count(U.device.index),
                             per_sm.value, gram.f32_num_slices(K))
    floats = gram.f32_scratch_floats(K, blocks)
    partial = torch.empty(max(floats, 1), device=U.device)
    out = torch.empty(K * K + K, device=U.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.gram_f32_launch(U.data_ptr(), g.data_ptr(),
                                 partial.data_ptr(), floats, out.data_ptr(),
                                 out.data_ptr() + 4 * K * K, K, n, int(vec),
                                 blocks, cols, stream)
        if rc != 0:
            raise RuntimeError(f"gram_f32_launch: CUDA error {rc}")
        return out
    return call, threads.value


def main() -> int:
    import torch
    from repro_torch.kernels import _build, gram
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    result = {"nvidia_smi": smi, "ffma": {}, "variants": {}}

    lib = build(nvcc, "ffma", FFMA_CU)
    lib.ffma_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    blocks, iters = 2 * _build.sm_count(0), 200_000
    buf = torch.empty(blocks * 256, device="cuda")
    for mode, what in FFMA_MODES.items():
        assert lib.ffma_launch(buf.data_ptr(), blocks, 100, mode) == 0
        us = event_us(lambda: lib.ffma_launch(buf.data_ptr(), blocks,
                                               iters, mode), 1)
        share = blocks * 256 * 64 * iters / (us * 1e-6) / PEAK_FMA
        result["ffma"][what] = share
        print(f"FFMA rate, {what}: {share:.1%} of 33.45 TFMA/s", flush=True)

    src = (_build.CSRC / "gram_f32.cu").read_text()
    libs = {}
    for i, (name, cu) in enumerate(variants(src).items()):
        libs[name] = build(nvcc, f"gram_f32_v{i}", cu,
                           (str(_build.CSRC / "errors.cu"), "-I",
                            str(_build.CSRC)))
        for fn, sig in (("gram_f32_launch",
                         _build._SIGNATURES["gram_f32_launch"]),
                        ("gram_f32_launch_config",
                         _build._SIGNATURES["gram_f32_launch_config"])):
            getattr(libs[name], fn).argtypes = sig
            getattr(libs[name], fn).restype = ctypes.c_int
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for K, n in SHAPES:
        U = torch.randn((K, n), generator=gen, device="cuda")
        g = torch.randn((n,), generator=gen, device="cuda")
        sl = gram.f32_slices(K)[0]
        fmas = sl.tiles * 64 * n
        calls = {name: f32_caller(lib, U, g) for name, lib in libs.items()}
        runs = {name: [] for name in calls}
        for _ in range(2):
            for name, (call, _) in calls.items():
                runs[name].append(event_us(call, 20))
        for name, (_, threads) in calls.items():
            us = min(runs[name])
            rec = {"us": runs[name], "threads": threads,
                   "fma_share": fmas / (us * 1e-6) / PEAK_FMA}
            result["variants"][f"K={K} n={n} {name}"] = rec
            print(f"K={K} n={n} {name}: {runs[name][0]:.1f} / "
                  f"{runs[name][1]:.1f} us, {threads} threads, FMAs at "
                  f"{rec['fma_share']:.1%} of 33.45 TFMA/s", flush=True)
        del U, g, calls
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
