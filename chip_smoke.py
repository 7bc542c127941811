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
  2. kernels — ``gram`` (K up to 100, the gateways' 23-25 among them; the
     body each call took: the bf16 tensor-core body of ``gram_mma.cu`` for
     bf16 U and g with K <= 127 and n % 8 == 0, ``gram.cu`` for the rest),
     ``combine`` (the body each call took: ``combine_vec.cu`` where every
     row of U, w and out starts 16-byte aligned, timed in turn with
     ``combine.cu`` on the same inputs and bitwise equal to it where the
     rows are not split; ``combine.cu`` for the rest; the f32-out rows
     also against an f64 sum), ``topk``, ``sign_sketch`` and
     ``sign_sketch_adjoint``
     against their plain PyTorch versions on the card at the main paths'
     shapes, a ragged small set and
     model widths: max |err| within the stated tolerance (``topk`` exactly),
     two ``gram`` and two ``sign_sketch`` calls bitwise equal, and
     CUDA-event times of the kernel, the plain version and a one-call
     PyTorch yardstick (where one exists) beside the bound (``topk`` and
     ``gram``: the median and min-max of five rounds, with device µs from
     ``torch.profiler``; ``combine``: the same, with the host µs to issue
     a call; ``sign_sketch`` and its adjoint: both bodies, ``col``
     (``rng_sketch_col.cu``, every call's) and the first
     (``rng_sketch.cu``), on the same inputs, the col body within the
     tolerance of the plain version and of the first body, each timed as
     the median and min-max of five rounds in turn, with device kernels
     per call, device µs and host µs to issue a call, beside the
     recounted bound and the old count's; one device kernel a col sketch
     call at K <= 8; the async flush's gram and combine shapes timed
     too; ``topk``: one device
     kernel per call at every
     shape of the one-block path; ``gram``'s tensor-core rows also against
     an f64 product beside the plain version's distance from it);
  3. path    — ``run_simulation`` at paper-logreg width (784 → 10) on
     MNIST-like data over 100 devices, contextual then FedAvg, with the
     launch counters showing that every round went through the kernels and
     never through the plain versions; one round is also held against the
     same round on the CPU;
  4. async   — ``run_async_simulation`` on the same data and width over a
     bimodal fleet of 100 devices (slowdown 4, dropout_slow 0.1; buffer 5,
     concurrency 10, lr 0.2): ``contextual_async``, ``fedbuff`` and
     ``fedasync`` (buffer 1), 30 flushes each.  The counters must show
     ``gram`` once per ``contextual_async`` flush and ``combine`` twice on
     every flush (W on ``combine_vec.cu``, b on ``combine.cu``), and no
     plain version; the losses must fall; two ``contextual_async`` runs
     on the card (the second 10 flushes long) give the same virtual times
     and losses within 1e-6; one
     flush on the card matches the same flush on the CPU; the device µs of
     a flush's ``gram`` and ``combine`` launches beside their bounds; and
     ``BENCH_async.json``'s ordering on Synthetic(1,1) at slowdown 1:
     contextual-async reaches 0.5 accuracy at an earlier virtual time than
     fedavg-sync;
  5. hier    — ``run_hier_simulation`` on the same data and width over a
     bimodal fleet of 100 devices: a star cloud (K = 100), two tiers of 4
     gateways, and the two tiers with ``topk`` and with ``sign_sketch``
     summaries.  The counters must show ``gram`` on every round and ``topk``
     or ``sign_sketch`` + ``sign_sketch_adjoint`` on every compressed round,
     and no plain version (every ``gram`` launch of the sync, hier,
     streamed, bigmodel and serve phases runs ``gram.cu``'s body: their
     inputs are f32); the losses must fall; compressed cloud uplink
     below uncompressed below star; one uncompressed and one
     ``sign_sketch`` round on the card match the same round on the CPU;
  6. streamed — the same two-tier runs (uncompressed, ``topk``,
     ``sign_sketch``) on ``engine="streamed"`` and on the fused engine with
     the same mini-batches: every streamed round launches ``stream_stats``
     (its P = 100 f32 slabs on cross.cuh's body) and ``combine`` (each
     call on the body its ``_vec_eligible`` gives it: the apply's
     100 x 7 840 weight slab on ``combine_vec.cu``), the losses fall and
     agree with the fused engine's to
     1.4e-3, the cloud-uplink bytes are equal; one streamed round on the
     card matches the same round on the CPU;
  7. robust  — ``BENCH_robust.json``'s acceptance at its own sizes
     (Synthetic(1,1), dim 20, 64 devices, 16 clients, 10 rounds, 20 %
     adversaries under ``ByzantineGauss(25)``): the loss inflation of
     contextual_mom <= 1.10, contextual >= 1.25, FedAvg >= 1.5, printed
     beside the recorded ones; then the robust path at paper-logreg
     width over ``bimodal_fleet(100)`` with 20 % adversaries: a flat
     ``contextual_mom`` run (``gram``, ``gram_block`` and ``combine``
     once a round), and ``HierConfig(robust=RobustConfig(2.0, "mom"))``
     on two tiers of 4 gateways and on a star, each on the fused
     engine (``gram_block`` on every round, its cross.cuh body only) and
     the streamed one (``stream_stats``, no ``gram_block``), under a
     churn wave set by a clean run's span: event times equal and losses
     within 5e-4 across engines, two card runs of each engine bitwise
     equal, one attacked round of each engine on the card against the
     CPU at 1e-4;
  8. bigmodel — the reference's full ``transformer_stream`` round
     (``benchmarks/bigmodel_round.py``: d_model 1024, vocab 8192, 4 layers,
     P = 16, bf16, n = 58 724 352) through the streamed engine: its round
     time, the accumulate pass beside its bound (every one of its 29
     ``stream_stats`` launches on the tensor-core body), the apply beside
     its bound (all 29 ``combine`` launches on ``combine_vec.cu``), with
     its device and host time, the rise of
     allocated memory across ``begin_round``, G and C against the plain
     version and against an f64 product, and the round's delta against the
     fused engine's on the same inputs;
  9. serve   — the continuous-batching ``DecodeEngine`` on the full
     qwen3-14b (40 layers, d_model 5 120, 40/8 heads, bf16, 14.77 B
     parameters from a seeded generator on the card): 4 slots of 256 rows
     serve 8 requests (prompts of 48-200 tokens, 32 or 4 new) with one
     mid-flight publish on the ``ModelBus``.  Every request completes, the
     versions are monotone, ``flash_decode`` launches L x decode steps, all
     on the tensor-core body, and no plain version runs; tokens/s, one decode step and one prefill chunk
     alone (CUDA events) beside the step's byte bound, the device busy time
     per step from ``torch.profiler``, the swap stall; one step's logits
     with the kernel against the plain ``flash_decode``, beside the floor
     two correct attentions show (the plain version in f32 against f64 and
     against SDPA, a yardstick used nowhere in the port); three staggered
     requests equal to each served alone; a reduced f32 qwen3 served on the
     card (on ``decode_attn.cu``'s body) and on the CPU gives the same
     tokens.

The kernels phase also holds ``stream_stats``, ``gram_block`` and ``sketch``
(U Rᵀ against an explicit R) against their plain versions, bitwise
repeatable, at the paths' (``gram_block``: the robust path's f32 cross
terms, K = 10, 25 and 100 at n = 7 850), the reference benchmark's and
model shapes
(timed rows as the median and min-max of five rounds, with device µs;
``stream_stats``, ``gram_block`` and ``sketch``: which of their two bodies
each shape took, and the model rows and the tensor-core bodies' ragged
shapes also against an f64 product; ``gram_block``'s bf16 rows with
aligned rows and n % 8 == 0 take the tensor-core body of
``gram_block_mma.cu``, every other call ``gram_block.cu``; ``sketch``'s
bf16 rows with K <= 64, aligned rows and n % 8 == 0 take
``sketch_mma.cu``, every other call ``sketch.cu``), and ``flash_decode``
(o and lse) at the serve path's shape, a decode_32k-like cache, gemma-7b's
and starcoder2-15b's heads (the latter windowed), with ragged, strided,
soft-capped and f32 caches, timed beside SDPA (bf16 q, k and v at hd 64
or 128 take the tensor-core body of ``decode_attn_mma.cu``, timed in turn
with ``decode_attn.cu``'s body on the same inputs; every other call
``decode_attn.cu``; device µs of both bodies' partial and merge kernels).

The last lines are one ``{"kernels": [...]}`` JSON object, the
``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device": ...}``.
Matmuls run in full f32 (TF32 off) so the plain ``gram`` is a fair reference.
"""
from __future__ import annotations

import contextlib
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
# Instruction rates of the pipes the sign hash runs on.  The Hopper SM has
# 64 INT32 lanes beside its 128 FP32 lanes (NVIDIA H100 architecture white
# paper); the FP32 lanes' 67 TFLOP/s counts an FMA as 2 operations:
INT32_OPS = 67e12 / 2 / 2      # shifts and logic ops, per second
FMA_PIPE_OPS = 67e12 / 2       # FADD, FFMA and integer multiplies (IMAD)
# The SM's four schedulers issue one warp instruction each a clock, 128
# thread operations: the FP32 lanes' rate, and a cap on every instruction
# whatever its pipe
ISSUE_OPS = FMA_PIPE_OPS
# The recount (the col body, csrc/rng_sketch_col.cu): R[i, j]'s sign is
# msb(mix32'(cc_j ^ R1_i)) with the column's half cc_j = j ^ (j >> 16) and
# the row's half R1_i = rh_i ^ (rh_i >> 16) each formed once, not per sign.
# What a sign needs at the least: the xor cc_j ^ R1_i, y·M1, y ^= y >> 13,
# y·M2 and ±1.0f from y's msb in one LOP3, 6 instructions, then one FFMA
# per row of U: 6 + K, all through the issue slots (ISSUE_OPS).  Of the 6
# only 3 need the INT32 lanes at the least (the two xors and the LOP3: the
# shift can run as IMAD.HI, a multiply by 2^19, on the FMA pipe; the CUDA
# Programming Guide's throughput table for compute capability 9.0 gives
# 32-bit IMAD 64 a clock an SM, so its 3 IMADs bind no sooner than the 3
# INT32 ops).  The least time is the larger of 3·m·n at INT32_OPS and
# (6 + K)·m·n at ISSUE_OPS; the second binds at every K >= 1 (7 against
# 3·2 at K = 1).  The kernel keeps the shift on the INT32 lanes (4 ops a
# sign): as IMAD.HI it ran slower on the H100.
HASH_INT_ONLY_OPS = 3
HASH_OPS = 6
# The old count, printed beside the recount: the first body's 5 INT32
# operations a sign (the xor with the row hash and mix32's first two
# shift-xor pairs) plus a sign flip per row of U, against its 2 multiplies
# plus an add per row on the FMA pipe, the two pipes side by side
HASH_INT_OPS_FIRST = 5
HASH_MUL_OPS_FIRST = 2

# tolerances on max |kernel - plain| relative to max(1, max |plain|):
# f32 and bf16 inputs both accumulate in f32, so gram's two sides differ by
# summation order only (the reference's own kernel tests use 1e-4); combine's
# f32 output likewise (1e-5), its bf16 output by up to one bf16 rounding
# (the reference's tests use 3e-2); sign_sketch and its adjoint sum f32
# products in another order (1e-5); topk must be exact (0)
TOL = {("gram", "float32"): 1e-4, ("gram", "bfloat16"): 1e-4,
       ("combine", "float32"): 1e-5, ("combine", "bfloat16"): 3e-2,
       ("sign_sketch", "float32"): 1e-5, ("sign_sketch", "bfloat16"): 1e-5,
       ("sign_sketch_adjoint", "float32"): 1e-5}
# stream_stats, gram_block and sketch form the same f32 products as their
# plain versions (bf16 inputs upcast exactly) and sum them in another order
CROSS_TOL = 1e-5

PATH_SHAPE = (10, 7850)        # K clients x paper-logreg parameters (784·10 + 10)
RAGGED = [(K, n) for K in (1, 3, 10) for n in (1, 130, 7850)]
MODEL = [(K, n) for K in (10, 64) for n in ((1 << 20) + 3, 1 << 24)]
# gram at the hier gateways (4 gateways of 25 devices; dropouts leave 23-25
# rows), then past 64 rows: the star cloud's K = 100 at the path width, and
# K = 100 at model width beside K = 64 above
# combine_vec.cu at W_k = 1 (K = 1 and 3, and 64 x 2^20+8), 2 (8 x 4 104),
# 4 (17 x 2 056; 16 x 1 024, a layer-norm leaf) and 8 (100 x 7 840), with
# ragged last chunks
COMBINE_VEC_RAGGED = [(1, 8), (3, 136), (17, 2056), (16, 1024), (8, 4104),
                      (100, 7840), (64, (1 << 20) + 8)]
GRAM_GATEWAY = [(25, 7850), (23, 7850)]
GRAM_WIDE = [(65, 7850), (100, 7850), (100, 1 << 24)]
# gram's tensor-core body (bf16, K <= 127, n % 8 == 0): every 16-row tile
# count of [U; g] and its edges, with ragged last staged tiles; the model
# rows K = 10, 64 (MODEL) and 100 (GRAM_WIDE) at n = 2^24 take it timed
GRAM_MMA_K = (1, 15, 16, 17, 31, 32, 63, 64, 65, 100, 127)
GRAM_MMA_N = (8, 72, 4104)
N_PATH = 7850
# topk (n, k): the hier path's summaries (ū and ĝ at ratio 3.4 / u_frac
# 0.75, and the default ratio 8), ragged, ties, and model widths
TOPK_PATH = [(N_PATH, 1731), (N_PATH, 577), (N_PATH, 490)]
TOPK_RAGGED = [(n, k) for n in (1, 130, N_PATH) for k in (1, 17, n) if k <= n]
TOPK_MODEL = [(n, k) for n in ((1 << 20) + 3, 1 << 24)
              for k in (n // 16, 2048)]
# rounds of the timing loop per topk and cross-kernel row, for a median and
# a min-max spread
TOPK_REPEATS = 5
# sign_sketch (K, n, m): ratio 4 and ratio 8 at the path width, ragged, and
# model widths; the adjoint takes (m, n) of each
SKETCH_PATH = [(1, N_PATH, 1962), (1, N_PATH, 981)]
SKETCH_RAGGED = [(1, 1, 1), (3, 130, 17), (8, 4097, 300), (11, 1000, 129)]
SKETCH_MODEL = [(K, (1 << 20) + 3, m) for K in (1, 8) for m in (1024, 8192)]

# stream_stats (P, n): the streamed paper path's two leaf slabs at P = 100
# (w: 784 x 10, b: 10), ragged, and one slab of each size of the
# transformer_stream round (embedding, MLP, attention) at P = 16 bf16
STREAM_PATH = [(100, 7840), (100, 10)]
STREAM_RAGGED = [(1, 7), (3, 129), (65, 1000)]
STREAM_MODEL = [(16, 8192 * 1024), (16, 1024 * 4096), (16, 1024 * 1024)]
# the tensor-core body (bf16, P <= 32): one and two 16-row tiles, ragged
# column tails of 1 024-wide rows
STREAM_MMA_ROWS = (1, 5, 16, 17, 32)
STREAM_MMA_COLS = (1, 31, 1000)
# gram_block (Ka, Kb, n): benchmarks/kernel_bench.py's (K, K // 2) pairs,
# ragged, and at n = 2^24 Ka = 64, Kb = 32 in f32 and bf16, then in bf16
# the one-tile case (10, 5) and a gateway-cohort pair (25, 25) (the bf16
# model rows take the tensor-core body)
# the robust path's cross term U Gmᵀ (f32): the flat contextual_mom round
# (K = J = 10), a gateway cohort of the two tiers (~25) and the star cloud
# (~95-100 survivors), at paper-logreg width
GRAM_BLOCK_PATH = [(10, 10, 7850), (25, 25, 7850), (100, 100, 7850)]
GRAM_BLOCK_BENCH = [(10, 5, 1 << 16), (16, 8, 1 << 18), (32, 16, 1 << 18)]
GRAM_BLOCK_RAGGED = [(1, 1, 1), (5, 7, 333), (3, 130, 1000), (100, 100, 7850)]
GRAM_BLOCK_MODEL = [(64, 32, 1 << 24, ("float32", "bfloat16")),
                    (10, 5, 1 << 24, ("bfloat16",)),
                    (25, 25, 1 << 24, ("bfloat16",))]
# gram_block's tensor-core body (bf16, Ka <= 64, Kb <= 63, n % 8 == 0): the
# edges of every instance (MA, NB) = (ceil(Ka / 16), ceil((Kb + 1) / 8)),
# with a ragged last staged tile at n = 4 104, against f64 too
GRAM_BLOCK_MMA_KA = (1, 16, 17, 32, 33, 48, 49, 64)
GRAM_BLOCK_MMA_KB = (1, 7, 8, 16, 24, 32, 40, 48, 63)
GRAM_BLOCK_MMA_N = (8, 4104)
# sketch (K, n, m): kernel_bench's shape, ragged, and n = 2^20 + 3 (f32
# and bf16 on cross.cuh: a row of odd n starts only 2-byte aligned); the
# bf16 (11, 1 000, 129) takes the tensor-core body, every other of these
# rows cross.cuh's
SKETCH_APPLY_BENCH = [(8, 1 << 16, 1024)]
SKETCH_APPLY_RAGGED = [(1, 1, 1), (3, 130, 17), (11, 1000, 129),
                       (100, 777, 65)]
SKETCH_APPLY_MODEL = [(8, (1 << 20) + 3, 1024)]
# sketch's tensor-core body (bf16, K <= 64, n % 8 == 0): the aligned twin of
# the model row and K = 64 against m = 256, timed; then untimed the edges of
# every instance NB = ceil(K / 8) and of the 128-row slices of R, with a
# ragged last staged tile at n = 4 104, against an f64 product
SKETCH_MMA_MODEL = [(8, 1 << 20, 1024), (64, 1 << 22, 256)]
SKETCH_MMA_K = (1, 7, 8, 9, 16, 57, 64)
SKETCH_MMA_M = (1, 15, 16, 17, 127, 128, 129, 1024)
SKETCH_MMA_N = (8, 4104)

# flash_decode: the serve path's own shape (4 slots of max_seq 256, qwen3-14b
# heads, mixed lengths 1..S), a decode_32k-like cache, gemma-7b's and
# starcoder2-15b's heads (the latter's 4 096-row window); (B, S, KV, G, hd,
# window, lengths or None for full)
DECODE_PATH = (4, 256, 8, 5, 128, None, [1, 97, 200, 256])
DECODE_MODEL = [(8, 32768, 8, 5, 128, None, None),
                (4, 8192, 16, 1, 256, None, None),
                (4, 16384, 4, 12, 128, 4096, None)]
# o and lse against the plain version: f32 sums in another order and the
# kernel's fast exp (relative to max(1, max |plain|))
DECODE_TOL = 1e-4
# the serve phase: full qwen3-14b (40 layers, bf16, 14.77 B parameters) on
# examples/serve_decode.py's traffic shape
SERVE = dict(arch="qwen3-14b", slots=4, max_seq=256, scan_chunk=8,
             prefill_chunk=64, requests=8, prompt=(48, 200), new=(32, 4))
# one decode step's logits with the kernel vs the plain flash_decode, over
# max |logit|.  Full width, bf16: every layer rounds the f32 attention output
# to 8 bits, and 40 random layers amplify the flipped roundings.  Two
# correct attentions show the floor of this statistic: the plain version in
# f32 against the same arithmetic in f64 (2.013e-2) and against SDPA
# (1.702e-2), the same in two runs on an H100; the gate is 1.5x that floor
# (the kernel itself is held to 1e-4 at this shape in the kernels phase).
# The reduced f32 model carries no such rounding and is held to f32
# summation order.
SERVE_LOGIT_FLOOR = 2.013e-2
SERVE_LOGIT_TOL = 1.5 * SERVE_LOGIT_FLOOR
SERVE_LOGIT_TOL_F32 = 1e-5
HIER_ROUNDS = 6
# the reference's recorded streamed-vs-fused loss gap (BENCH_bigmodel.json)
STREAMED_LOSS_GAP = 1.4e-3
# benchmarks/bigmodel_round.py's full transformer_stream round
BIG = dict(d_model=1024, vocab=8192, layers=4, P=16, gateways=4,
           chunk=1 << 18)
BIG_SLABS = (8192 * 1024, 1024 * 4096)   # its embedding and MLP leaves
BIG_N = 58_724_352
BIG_PEAK_BYTES = 33_556_480
BIG_DENSE_BYTES = 7_516_717_056
BIG_MEMORY_RISE = 64 << 20
BIG_DELTA_TOL = 4e-3      # bf16 rounding of the mix weights (mix_rows)
HIER_CFG = dict(lr=0.05, batch_size=10, min_epochs=1, max_epochs=20)

PATH_ROUNDS = 8
PATH_CFG = dict(num_devices=100, clients_per_round=10, lr=0.05,
                batch_size=10, min_epochs=1, max_epochs=20)
ASYNC_FLUSHES = 30
# the second contextual_async run (determinism) and the Synthetic(1,1)
# async run of the ordering check stop early: their prefix is the run
# (the event stream is causal), and every arrival costs ~70-80 ms of host
# time on the card (one eager client_update, ~63 SGD steps)
ASYNC_REPEAT_FLUSHES = 10
ASYNC_BENCH_FLUSHES = 12
ASYNC_CFG = dict(num_devices=100, buffer_size=5, concurrency=10, lr=0.2,
                 batch_size=10, min_epochs=1, max_epochs=20)
ASYNC_FLEET = dict(slowdown=4.0, dropout_slow=0.1, seed=0)
# benchmarks/robust_suite.py's setup (BENCH_robust.json's acceptance):
# Synthetic(1,1), dim 20, 64 devices of 30 samples, 16 clients a round
ROBUST_BENCH = dict(num_devices=64, clients_per_round=16, lr=0.2,
                    batch_size=10, min_epochs=1, max_epochs=4)
ROBUST_BENCH_ROUNDS = 10
# BENCH_robust.json's acceptance thresholds on the loss inflation
# (attacked / clean final loss): (aggregator, key in the file, bound, side)
ROBUST_ACCEPT = (("contextual_mom", "robust_inflation", 1.10, "max"),
                 ("contextual", "plain_inflation", 1.25, "min"),
                 ("fedavg", "fedavg_inflation", 1.5, "min"))
ROBUST_FRAC, ROBUST_ADV_SEED, ROBUST_SCALE = 0.2, 3, 25.0
ROBUST_PATH_ROUNDS = 4
# tests/test_robust.py's fused-vs-streamed tolerance under attack + churn
ROBUST_ENGINE_TOL = 5e-4


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


def time_ms_spread(fns: dict, reps: int, repeats: int = 5) -> dict:
    """``{name: {"median", "min", "max", "runs"}}`` over ``repeats`` rounds
    of :func:`time_ms` (``reps`` calls each), taking the ``fns`` in turn
    within a round so that drift of the host or the card hits all alike."""
    runs = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            runs[name].append(time_ms(fn, reps))
    return {name: {"median": statistics.median(r), "min": min(r),
                   "max": max(r), "runs": r} for name, r in runs.items()}


# torch.profiler traces on an H100 lose device activity at the start of a
# window: a ``profile`` that starts recording as it opens misses the first
# launches after it (seen for one call of topk and of gram at path width,
# the first of three stream_stats_mma launches in most rows, and once the
# first five launches of three stream_stats calls).  So a window first runs
# one call in a warm-up cycle (``schedule(warmup=1)``: CUPTI is on, the
# events are dropped) and records the next ``calls``; and a window that
# still comes back incomplete (no device activity, or a kernel seen a
# number of times that is no multiple of ``calls``: every call of a
# function here launches the same kernels) is profiled again, up to this
# many times in all.  A lost launch is a lost trace, never a result.
PROFILE_ATTEMPTS = 5


def _profile_window(fn, calls: int) -> list:
    """The ``key_averages()`` entries with device time (kernels, not aten
    ops, runtime calls or the step markers) of ``calls`` calls of ``fn``,
    recorded after one call in the profiler's warm-up cycle."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return [e for e in prof.key_averages() if _device_us(e) > 0
            and not e.key.startswith(("aten::", "cuda", "ProfilerStep"))]


def _device_rows(fn, calls: int) -> list:
    """:func:`_profile_window` of ``calls`` calls of ``fn`` after a warm-up
    call; an incomplete trace is taken again (``PROFILE_ATTEMPTS``), and
    if none is complete the one with the most launches is returned."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(PROFILE_ATTEMPTS):
        rows = _profile_window(fn, calls)
        if rows and all(e.count % calls == 0 for e in rows):
            return rows
        log(f"profiler: incomplete trace of {calls} calls "
            f"{ {e.key[:40]: e.count for e in rows} }, profiled again")
        if sum(e.count for e in rows) > sum(e.count for e in best):
            best = rows
    return best


def device_kernels(fn) -> tuple:
    """``(names, ms)``: the device kernels one call of ``fn`` runs, one name
    per launch, and their device time (``torch.profiler`` over one call
    after a warm-up call; the entries with device time, as
    :func:`device_busy` reads them)."""
    rows = _device_rows(fn, 1)
    return ([e.key for e in rows for _ in range(e.count)],
            sum(_device_us(e) for e in rows) / 1e3)


def device_kernel_means(fn, calls: int = 3) -> dict:
    """``{kernel name: [launches seen, mean device ms per launch]}`` over
    ``calls`` calls of ``fn`` under ``torch.profiler`` (after a warm-up
    call): a kernel that a call launches once costs its mean per call, even
    where the trace misses one of its launches."""
    return {e.key: [e.count, _device_us(e) / e.count / 1e3]
            for e in _device_rows(fn, calls)}


def host_ms(fn, reps: int, repeats: int = 5) -> float:
    """Median host ms per call of ``fn`` over ``repeats`` rounds of ``reps``
    calls that are not waited for: what the host spends to issue a call."""
    import torch
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        runs.append((time.perf_counter() - t0) / reps * 1e3)
    torch.cuda.synchronize()
    return statistics.median(runs)


def reps_for(nbytes: int) -> int:
    return 200 if nbytes < (1 << 24) else 20


def bound(nbytes: float, ops_s: float) -> dict:
    """The least time for the work: bytes at the HBM rate against the
    operations' time (already in seconds), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes}


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


def combine_bound(K: int, n: int, dt, w_dt=None) -> dict:
    import torch
    size = torch.finfo(dt).bits // 8
    w_size = torch.finfo(w_dt or dt).bits // 8
    nbytes = K * n * size + 2 * n * w_size + K * 4
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


def _gram_f64_err(got, U, g, chunk: int = 1 << 22, V=None) -> float:
    """max |got - (U Vᵀ, U g) in f64| / max(1, max |f64|) over G and c, V = U
    unless given (the f64 product summed over column chunks, so the copy
    stays small)."""
    import torch
    K, n = U.shape
    V = U if V is None else V
    G64 = torch.zeros((K, V.shape[0]), dtype=torch.float64, device=U.device)
    c64 = torch.zeros((K,), dtype=torch.float64, device=U.device)
    for c0 in range(0, n, chunk):
        u = U[:, c0:c0 + chunk].double()
        v = u if V is U else V[:, c0:c0 + chunk].double()
        G64 += u @ v.T
        c64 += u @ g[c0:c0 + chunk].double()
        del u, v
    return max(float((a.double() - b).abs().max())
               / max(1.0, float(b.abs().max()))
               for a, b in zip(got, (G64, c64)))


def _time_record(rec: dict, fns: dict, reps: int) -> None:
    """Into ``rec``: the device kernels of a call of ``fns["ms"]`` (mean µs
    per launch over three calls) and the median and min-max of
    ``TOPK_REPEATS`` rounds of CUDA-event times of every fn, in turn."""
    kernels = device_kernel_means(fns["ms"])
    rec["device_ms"] = sum(ms for _, ms in kernels.values())
    rec["device_kernels_per_call"] = len(kernels)
    rec["device_kernels"] = kernels
    for key, sp in time_ms_spread(fns, reps, TOPK_REPEATS).items():
        rec[key] = sp["median"]
        rec[key + "_min"], rec[key + "_max"] = sp["min"], sp["max"]
        rec[key + "_runs"] = sp["runs"]


def _gated_err(rec: dict) -> float:
    """The relative error a record was gated on: against the plain version,
    or against an f64 product where the plain version was no oracle."""
    return rec["f64_rel_err"] if rec.get("gated_on") == "f64" else rec["rel_err"]


def _kernel_names(rec: dict) -> str:
    """``rec``'s device kernels as "name launches µs-per-launch"."""
    return ", ".join(
        f"{k.replace('void ', '').replace('(anonymous namespace)::', '').split('(')[0]} "
        f"{c} {ms * 1e3:.1f}" for k, (c, ms) in rec["device_kernels"].items())


def check_gram(K: int, n: int, dt, gen, timed: bool = True, body: str = None,
               f64: bool = False, U=None, g=None) -> dict:
    """gram against its plain version: two calls bitwise equal, G symmetric,
    within the tolerance, and the body both took (``mma``: gram_mma.cu,
    ``cuda_core``: gram.cu; ``body``, if given, must be it); with ``timed``
    the spread of kernel, plain and ``torch.matmul`` times and the device
    kernels; with ``f64`` the kernel's and the plain version's error
    against an f64 product (the kernel's within the tolerance)."""
    import torch
    from repro_torch.kernels import gram, ops, ref
    if U is None:
        U = torch.randn((K, n), generator=gen, device="cuda").to(dt)
        g = torch.randn((n,), generator=gen, device="cuda").to(dt)
    dt = U.dtype
    took = "mma" if gram._mma_eligible(U, g) else "cuda_core"
    what = f"gram K={K} n={n} {_dtype_name(U.dtype)}/{_dtype_name(g.dtype)}"
    need(body is None or took == body,
         f"{what}: takes the {took} body, want {body}")
    gram.reset_body_launches()
    G, c = ops.gram_and_cross(U, g, backend="cuda")
    G2, c2 = ops.gram_and_cross(U, g, backend="cuda")
    tally = gram.body_launches()
    need(tally[took] == 2 and sum(tally.values()) == 2,
         f"{what}: body launches {tally}, want 2 on {took}")
    Gr, cr = ref.gram_ref(U, g)
    torch.cuda.synchronize()
    need(G.shape == (K, K) and c.shape == (K,) and G.dtype == torch.float32,
         f"{what}: output shapes {tuple(G.shape)}, {tuple(c.shape)}")
    bitwise = bool(torch.equal(G, G2) and torch.equal(c, c2))
    need(bitwise, f"{what}: two calls differ bitwise")
    need(torch.equal(G, G.T), f"{what}: G is not symmetric")
    err = max(_max_err(G, Gr) / _scale(Gr), _max_err(c, cr) / _scale(cr))
    abs_err = max(_max_err(G, Gr), _max_err(c, cr))
    tol = TOL[("gram", _dtype_name(dt))]
    need(err <= tol, f"{what}: relative err {err:.3e} > {tol}")
    rec = {"K": K, "n": n, "dtype": _dtype_name(dt), "max_abs_err": abs_err,
           "rel_err": err, "tolerance": tol, "bitwise_repeatable": bitwise,
           "body": took}
    if f64:
        rec["f64_rel_err"] = _gram_f64_err((G, c), U, g)
        rec["plain_f64_rel_err"] = _gram_f64_err((Gr, cr), U, g)
        log(f"{what} against an f64 product: kernel "
            f"{rec['f64_rel_err']:.3e}, plain {rec['plain_f64_rel_err']:.3e} "
            f"(tolerance {tol})")
        need(rec["f64_rel_err"] <= tol,
             f"{what}: {rec['f64_rel_err']:.3e} off an f64 product")
    if timed:
        reps = reps_for(U.numel() * U.element_size())
        _time_record(rec, {
            "ms": lambda: ops.gram_and_cross(U, g, backend="cuda"),
            "plain_ms": lambda: ref.gram_ref(U, g),
            "library_ms": lambda: (U @ U.T, U @ g)}, reps)
        rec.update(gram_bound(K, n, dt))
        log(f"{what}: device kernels (launches in 3 calls, us per launch) "
            + _kernel_names(rec))
        if took == "mma":
            need(any("gram_mma_partial" in k for k in rec["device_kernels"]),
                 f"{what}: device kernels {rec['device_kernels']}")
    return rec


def _combine_f64_err(out, w, U, a, chunk: int = 1 << 21) -> float:
    """max |out - (w + a U) in f64| / max(1, max |f64|), over column chunks
    so the f64 copy stays small."""
    import torch
    err, scale = 0.0, 1.0
    a64 = a.double()
    for c0 in range(0, U.shape[1], chunk):
        ref64 = w[c0:c0 + chunk].double() + a64 @ U[:, c0:c0 + chunk].double()
        err = max(err, float((out[c0:c0 + chunk].double() - ref64).abs().max()))
        scale = max(scale, float(ref64.abs().max()))
        del ref64
    torch.cuda.synchronize()
    return err / scale


def check_combine(K: int, n: int, dt, gen, timed: bool = True,
                  w_dt=None, f64: bool = False) -> dict:
    """combine against its plain version: within the tolerance, two calls
    bitwise equal, on the body the inputs route to (``vec``:
    combine_vec.cu, for rows of U, w and out that start 16-byte aligned;
    ``scalar``: combine.cu); a ``vec`` row also runs the first body on the
    same inputs (bitwise equal where the rows are not split, W_k = 1) and
    in place (out = w).  ``w_dt``: the base's dtype where it differs from
    U's (the streamed apply adds bf16 update slabs into f32 parameters).
    With ``f64`` (f32 out) it is held within 1e-5 of an f64 sum; with
    ``timed`` the spread of kernel, plain and library times, the device
    kernels, the host µs to issue a call, and on a ``vec`` row both bodies
    timed in turn (scalar, vec, vec, scalar)."""
    import torch
    from repro_torch.kernels import combine, ops, ref
    U = torch.randn((K, n), generator=gen, device="cuda").to(dt)
    w = torch.randn((n,), generator=gen, device="cuda").to(w_dt or dt)
    a = torch.randn((K,), generator=gen, device="cuda") / K
    body = "vec" if combine._vec_eligible(w, U) else "scalar"
    what = (f"combine K={K} n={n} {_dtype_name(dt)}"
            + (f" into {_dtype_name(w_dt)}" if w_dt is not None else ""))
    combine.reset_body_launches()
    out = ops.weighted_combine(w, U, a, backend="cuda")
    again = ops.weighted_combine(w, U, a, backend="cuda")
    tally = combine.body_launches()
    outr = ref.combine_ref(w, U, a)
    torch.cuda.synchronize()
    need(tally[body] == 2 and sum(tally.values()) == 2,
         f"{what}: body launches {tally}, want 2 on {body}")
    need(out.shape == (n,) and out.dtype == w.dtype,
         f"{what}: output {tuple(out.shape)} {out.dtype}")
    bitwise = bool(torch.equal(out, again))
    need(bitwise, f"{what}: two calls differ bitwise")
    err = _max_err(out, outr) / _scale(outr)
    tol = TOL[("combine", _dtype_name(w.dtype))]
    need(err <= tol, f"{what}: relative err {err:.3e} > {tol}")
    rec = {"K": K, "n": n, "dtype": _dtype_name(dt),
           "max_abs_err": _max_err(out, outr), "rel_err": err,
           "tolerance": tol, "bitwise_repeatable": bitwise, "body": body}
    if w_dt is not None:
        rec["w_dtype"] = _dtype_name(w_dt)
    if body == "vec":
        wk, blocks, chunks = combine.vec_plan(K, n, dt == torch.bfloat16,
                                              w.dtype == torch.bfloat16, 0)
        rec.update(split=wk, blocks=blocks, chunks=chunks,
                   chunk_rounds=-(-chunks // blocks))
        first = combine.combine_cuda(w, U, a, body="scalar")
        base = w.clone()
        combine.combine_cuda(base, U, a, out=base)
        torch.cuda.synchronize()
        rec["scalar_rel_err"] = _max_err(first, outr) / _scale(outr)
        rec["bitwise_equal_scalar"] = bool(torch.equal(out, first))
        need(rec["scalar_rel_err"] <= tol,
             f"{what}: the scalar body {rec['scalar_rel_err']:.3e} off plain")
        need(wk > 1 or rec["bitwise_equal_scalar"],
             f"{what}: W_k = 1 but the two bodies differ bitwise")
        need(torch.equal(base, out), f"{what}: in place differs")
    if f64:
        rec["f64_rel_err"] = _combine_f64_err(out, w, U, a)
        rec["plain_f64_rel_err"] = _combine_f64_err(outr, w, U, a)
        need(rec["f64_rel_err"] <= 1e-5,
             f"{what}: {rec['f64_rel_err']:.3e} off an f64 sum")
    del outr
    if timed:
        reps = reps_for(U.numel() * U.element_size())
        lib = (lambda: torch.addmv(w, U.T, a.to(dt))) if w_dt is None else (
            lambda: w + a.to(dt) @ U)
        kernel = lambda: ops.weighted_combine(w, U, a, backend="cuda")  # noqa: E731
        _time_record(rec, {"ms": kernel,
                           "plain_ms": lambda: ref.combine_ref(w, U, a),
                           "library_ms": lib}, reps)
        rec["host_ms"] = host_ms(kernel, reps)
        rec["library_device_ms"] = sum(
            ms for _, ms in device_kernel_means(lib).values())
        if body == "vec":
            vec = lambda: combine.combine_cuda(w, U, a)  # noqa: E731
            scalar = lambda: combine.combine_cuda(w, U, a, body="scalar")  # noqa: E731
            runs = [time_ms(fn, reps) for fn in (scalar, vec, vec, scalar)]
            rec["vec_ms_runs"], rec["scalar_ms_runs"] = runs[1:3], runs[::3]
            rec["scalar_ms"] = statistics.median(runs[::3])
            kernels = device_kernel_means(scalar)
            rec["scalar_device_kernels"] = kernels
            rec["scalar_device_ms"] = sum(ms for _, ms in kernels.values())
            rec["scalar_host_ms"] = host_ms(scalar, reps)
            need(any("combine_vec_kernel" in k for k in rec["device_kernels"]),
                 f"{what}: device kernels {list(rec['device_kernels'])}")
        rec.update(combine_bound(K, n, dt, w_dt))
        log(f"{what}: body {body}"
            + (f" (W_k={rec['split']}, {rec['blocks']} blocks, "
               f"{rec['chunks']} chunks, {rec['chunk_rounds']} a block at "
               f"most); vec {' / '.join(f'{t * 1e3:.1f}' for t in rec['vec_ms_runs'])}"
               f" us, scalar {' / '.join(f'{t * 1e3:.1f}' for t in rec['scalar_ms_runs'])}"
               f" us (in turn: scalar, vec, vec, scalar), scalar device "
               f"{rec['scalar_device_ms'] * 1e3:.1f} us, host "
               f"{rec['scalar_host_ms'] * 1e3:.1f} us"
               if body == "vec" else "")
            + f"; device kernels (launches in 3 calls, us per launch) "
            + _kernel_names(rec) + f"; library device "
            f"{rec['library_device_ms'] * 1e3:.1f} us"
            + (f"; off f64 {rec['f64_rel_err']:.3e} (plain "
               f"{rec['plain_f64_rel_err']:.3e})" if f64 else ""))
    return rec


def check_topk(n: int, k: int, gen, timed: bool = True, v=None) -> dict:
    """Exact against the plain version on values (bitwise) and indices.
    Timed: ``TOPK_REPEATS`` rounds of the kernel, the plain version and the
    ``torch.topk`` yardstick in turn (median, min, max); the device kernels
    of one call (one, the one-block kernel, where ``single_block`` holds)
    and their device time; the host time to issue a call."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.topk import single_block
    if v is None:
        v = torch.randn((n,), generator=gen, device="cuda")
    vals, idx = ops.topk_select(v, k, backend="cuda")
    rv, ri = ref.topk_ref(v, k)
    torch.cuda.synchronize()
    need(vals.shape == (k,) and idx.dtype == torch.int32,
         f"topk n={n} k={k}: outputs {tuple(vals.shape)} {idx.dtype}")
    same = bool(torch.equal(idx, ri)
                and torch.equal(vals.view(torch.int32), rv.view(torch.int32)))
    need(same, f"topk n={n} k={k}: values or indices differ from the plain "
         "version")
    rec = {"n": n, "k": k, "dtype": "float32", "max_abs_err": 0.0,
           "rel_err": 0.0, "tolerance": 0.0, "exact": same,
           "single_block": single_block(n, k)}
    if timed:
        call = lambda: ops.topk_select(v, k, backend="cuda")  # noqa: E731
        kernels, rec["device_ms"] = device_kernels(call)
        rec["device_kernels_per_call"] = len(kernels)
        rec["host_ms"] = host_ms(call, reps_for(4 * n))
        if rec["single_block"]:
            need(len(kernels) == 1 and "topk_small" in kernels[0],
                 f"topk n={n} k={k}: one call ran {kernels}, want the one "
                 "topk_small kernel")
        spread = time_ms_spread({
            "ms": call,
            "plain_ms": lambda: ref.topk_ref(v, k),
            "library_ms": lambda: v.gather(0, torch.topk(v.abs(), k).indices),
        }, reps_for(4 * n), TOPK_REPEATS)
        for key, sp in spread.items():
            rec[key] = sp["median"]
            rec[key + "_min"], rec[key + "_max"] = sp["min"], sp["max"]
            rec[key + "_runs"] = sp["runs"]
        rec.update(bound(4 * n + 8 * k, 0.0))
    return rec


def hash_ops_s(rows: int, m: int, n: int) -> float:
    """Least seconds for m·n sign hashes applied to ``rows`` rows, by the
    recount: the INT32-only operations at the INT32 rate against every
    instruction at the issue rate, whichever is longer."""
    return max(HASH_INT_ONLY_OPS * m * n / INT32_OPS,
               (HASH_OPS + rows) * m * n / ISSUE_OPS)


def hash_ops_s_first(rows: int, m: int, n: int) -> float:
    """The same by the old count (the first body's hash): the INT32 pipe's
    and the FMA pipe's counts at their rates, whichever is longer."""
    return max((HASH_INT_OPS_FIRST + rows) * m * n / INT32_OPS,
               (HASH_MUL_OPS_FIRST + rows) * m * n / FMA_PIPE_OPS)


def sign_bound(rows: int, m: int, n: int, nbytes: int) -> dict:
    """The recounted bound of m·n signs applied to ``rows`` rows moving
    ``nbytes``, with the old count's beside it."""
    old = bound(nbytes, hash_ops_s_first(rows, m, n))
    return dict(bound(nbytes, hash_ops_s(rows, m, n)),
                bound_ms_old_count=old["bound_ms"],
                int_only_ops=HASH_INT_ONLY_OPS * m * n,
                issue_ops=(HASH_OPS + rows) * m * n)


def sketch_bound(K: int, n: int, m: int, dt) -> dict:
    import torch
    size = torch.finfo(dt).bits // 8
    return sign_bound(K, m, n, K * n * size + 4 * K * m)


def _device_and_host(rec: dict, call, reps: int) -> None:
    """Into ``rec``: the device kernels of ``call`` (mean µs per launch over
    three calls, ``torch.profiler``), their sum, and the host µs to issue a
    call, as the ``combine`` rows carry them."""
    kernels = device_kernel_means(call)
    rec["device_kernels"] = kernels
    rec["device_kernels_per_call"] = len(kernels)
    rec["device_ms"] = sum(ms for _, ms in kernels.values())
    rec["host_ms"] = host_ms(call, reps)


def _sign_bodies(rec: dict, col, first, reps: int, kernel: str,
                 what: str) -> None:
    """Into ``rec``: the col body (``col``) and the first (``first``) timed
    in turn on the same inputs, the median and min-max of ``TOPK_REPEATS``
    rounds each (``ms``, ``first_ms``), and each body's device kernels per
    call, device µs and host µs to issue a call; the col body's trace must
    hold ``kernel`` and, for the sketch at K <= 8 and the adjoint, only it,
    once a call."""
    for key, sp in time_ms_spread({"ms": col, "first_ms": first}, reps,
                                  TOPK_REPEATS).items():
        rec[key] = sp["median"]
        rec[key + "_min"], rec[key + "_max"] = sp["min"], sp["max"]
        rec[key + "_runs"] = sp["runs"]
    _device_and_host(rec, col, reps)
    kernels = device_kernel_means(first)
    rec["first_device_kernels"] = kernels
    rec["first_device_kernels_per_call"] = len(kernels)
    rec["first_device_ms"] = sum(ms for _, ms in kernels.values())
    rec["first_host_ms"] = host_ms(first, reps)
    need(any(kernel in k for k in rec["device_kernels"]),
         f"{what}: device kernels {list(rec['device_kernels'])}, want "
         f"{kernel}")
    if rec.get("K", 1) <= 8:
        need(rec["device_kernels_per_call"] == 1 and all(
            c == 3 for c, _ in rec["device_kernels"].values()),
             f"{what}: the col body ran {rec['device_kernels']} in 3 calls, "
             "want one kernel a call")
    log(f"{what}: col {_fmt_spread(rec, 'ms')}us, device "
        f"{rec['device_ms'] * 1e3:.1f} us ({rec['device_kernels_per_call']} "
        f"kernel a call), host {rec['host_ms'] * 1e3:.1f} us; first (in turn) "
        f"{_fmt_spread(rec, 'first_ms')}us, device "
        f"{rec['first_device_ms'] * 1e3:.1f} us "
        f"({rec['first_device_kernels_per_call']} kernels: "
        + ", ".join(f"{k.replace('void ', '').replace('(anonymous namespace)::', '').split('(')[0]} "
                    f"{ms * 1e3:.1f}" for k, (_, ms)
                    in rec["first_device_kernels"].items())
        + f"), host {rec['first_host_ms'] * 1e3:.1f} us; bound "
        f"{rec['bound_ms'] * 1e3:.2f} us (old count "
        f"{rec['bound_ms_old_count'] * 1e3:.2f})")


def check_sketch(K: int, n: int, m: int, dt, gen, timed: bool = True) -> dict:
    """sign_sketch on the col body (every call's) against its plain version
    and the first body on the same inputs, both within the tolerance, two
    calls bitwise equal; with ``timed`` both bodies timed in turn
    (:func:`_sign_bodies`) beside the recounted bound and the old count's."""
    import torch
    from repro_torch.kernels import ops, ref, rng_sketch
    U = torch.randn((K, n), generator=gen, device="cuda").to(dt)
    seed = (0x9E3779B1 * (K + m) + n) & 0xFFFFFFFF
    what = f"sign_sketch K={K} n={n} m={m} {_dtype_name(dt)}"
    rng_sketch.reset_body_launches()
    S = ops.sign_sketch(U, seed, m, backend="cuda")
    S2 = ops.sign_sketch(U, seed, m, backend="cuda")
    tally = rng_sketch.body_launches()["sign_sketch"]
    S1 = rng_sketch.sign_sketch_cuda(U, seed, m, body="first")
    Sr = ref.rng_sketch_ref(U, seed, m)
    torch.cuda.synchronize()
    need(tally == {"col": 2, "first": 0},
         f"{what}: body launches {tally}, want 2 on col")
    need(S.shape == (K, m) and S.dtype == torch.float32,
         f"{what}: output {tuple(S.shape)}")
    bitwise = bool(torch.equal(S, S2))
    need(bitwise, f"{what}: two calls differ bitwise")
    err = _max_err(S, Sr) / _scale(Sr)
    first_err = _max_err(S1, Sr) / _scale(Sr)
    vs_first = _max_err(S, S1) / _scale(S1)
    tol = TOL[("sign_sketch", _dtype_name(dt))]
    need(err <= tol and vs_first <= tol and first_err <= tol,
         f"{what}: relative err {err:.3e} (first body {first_err:.3e}, col "
         f"vs first {vs_first:.3e}) > {tol}")
    rec = {"K": K, "n": n, "m": m, "dtype": _dtype_name(dt),
           "max_abs_err": _max_err(S, Sr), "rel_err": err, "tolerance": tol,
           "bitwise_repeatable": bitwise, "body": "col",
           "first_rel_err": first_err, "col_vs_first_rel_err": vs_first,
           "plan": rng_sketch.col_plan(K, n, m, _sms())._asdict()}
    if timed:
        reps = 5 if m * n > (1 << 30) else 200
        rec.update(sketch_bound(K, n, m, dt))
        _sign_bodies(
            rec, lambda: ops.sign_sketch(U, seed, m, backend="cuda"),
            lambda: rng_sketch.sign_sketch_cuda(U, seed, m, body="first"),
            reps, "sign_sketch_col", what)
        rec["plain_ms"] = time_ms(lambda: ref.rng_sketch_ref(U, seed, m),
                                  2 if reps == 5 else 20, warmup=1)
        rec["library_ms"] = None
    return rec


def check_adjoint(m: int, n: int, gen, timed: bool = True) -> dict:
    """sign_sketch_adjoint on the col body against its plain version and
    the first body, as :func:`check_sketch`."""
    import torch
    from repro_torch.kernels import ops, ref, rng_sketch
    s = torch.randn((m,), generator=gen, device="cuda")
    seed = (0x85EBCA6B * m + n) & 0xFFFFFFFF
    what = f"sign_sketch_adjoint m={m} n={n}"
    rng_sketch.reset_body_launches()
    out = ops.sign_sketch_adjoint(s, seed, n, backend="cuda")
    out2 = ops.sign_sketch_adjoint(s, seed, n, backend="cuda")
    tally = rng_sketch.body_launches()["sign_sketch_adjoint"]
    out1 = rng_sketch.sign_sketch_adjoint_cuda(s, seed, n, body="first")
    outr = ref.rng_sketch_adjoint_ref(s, seed, n)
    torch.cuda.synchronize()
    need(tally == {"col": 2, "first": 0},
         f"{what}: body launches {tally}, want 2 on col")
    need(out.shape == (n,) and torch.equal(out, out2),
         f"{what}: shape {tuple(out.shape)} or two calls differ")
    err = _max_err(out, outr) / _scale(outr)
    first_err = _max_err(out1, outr) / _scale(outr)
    vs_first = _max_err(out, out1) / _scale(out1)
    tol = TOL[("sign_sketch_adjoint", "float32")]
    need(err <= tol and vs_first <= tol and first_err <= tol,
         f"{what}: relative err {err:.3e} (first body {first_err:.3e}, col "
         f"vs first {vs_first:.3e}) > {tol}")
    rec = {"m": m, "n": n, "dtype": "float32",
           "max_abs_err": _max_err(out, outr), "rel_err": err,
           "tolerance": tol, "bitwise_repeatable": True, "body": "col",
           "first_rel_err": first_err, "col_vs_first_rel_err": vs_first,
           "plan": rng_sketch.adjoint_plan(m, n, _sms())._asdict()}
    if timed:
        reps = 5 if m * n > (1 << 30) else 200
        rec.update(sign_bound(1, m, n, 4 * m + 4 * n))
        _sign_bodies(
            rec, lambda: ops.sign_sketch_adjoint(s, seed, n, backend="cuda"),
            lambda: rng_sketch.sign_sketch_adjoint_cuda(s, seed, n,
                                                        body="first"),
            reps, "sign_sketch_adjoint_col", what)
        rec["plain_ms"] = time_ms(
            lambda: ref.rng_sketch_adjoint_ref(s, seed, n),
            2 if reps == 5 else 20, warmup=1)
        rec["library_ms"] = None
    return rec


def _sms() -> int:
    from repro_torch.kernels import _build
    return _build.sm_count(0)


def cross_bound(rows_read: int, n: int, fmas_per_col: int, out_floats: int,
                dt) -> dict:
    """Bound of a cross product: ``rows_read`` input rows of n entries read
    once and ``out_floats`` f32 written, against ``fmas_per_col`` FMAs per
    column at the input type's peak (and, for reference, on the f32 CUDA
    cores the kernels use)."""
    import torch
    size = torch.finfo(dt).bits // 8
    nbytes = rows_read * n * size + out_floats * 4
    flops = 2 * n * fmas_per_col
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[_dtype_name(dt)] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "f32_cuda_core_ms": flops / F32_CUDA_CORE_FLOPS * 1e3}


def _outs(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def check_cross(op: str, args: tuple, shape: dict, dt, bound_rec: dict,
                timed: bool = True, library=None,
                plain_gate: bool = True) -> dict:
    """One of the cross-product kernels (``stream_stats``, ``gram_block``,
    ``sketch``) against its plain version on ``args``: bitwise equal over
    two calls and within CROSS_TOL of max |plain| (unless ``plain_gate`` is
    False: then the caller gates on an f64 product and the distance from
    the plain version is only recorded); with ``timed``, CUDA-event times
    of the kernel, the plain version and ``library`` (the median and
    min-max of ``TOPK_REPEATS`` rounds taken in turn) and the kernel's
    device kernels and device time per call."""
    import torch
    from repro_torch.kernels import registry
    out = _outs(registry.dispatch(op, *args, backend="cuda"))
    out2 = _outs(registry.dispatch(op, *args, backend="cuda"))
    want = _outs(registry.dispatch(op, *args, backend="torch"))
    torch.cuda.synchronize()
    what = f"{op} {shape} {dt}"
    need(all(a.shape == b.shape and a.dtype == torch.float32
             for a, b in zip(out, want)), f"{what}: output shapes")
    bitwise = all(torch.equal(a, b) for a, b in zip(out, out2))
    need(bitwise, f"{what}: two calls differ bitwise")
    err = max(_max_err(a, b) / _scale(b) for a, b in zip(out, want))
    abs_err = max(_max_err(a, b) for a, b in zip(out, want))
    need(err <= CROSS_TOL or not plain_gate,
         f"{what}: relative err {err:.3e} > {CROSS_TOL}")
    rec = dict(shape, dtype=_dtype_name(dt), max_abs_err=abs_err,
               rel_err=err, tolerance=CROSS_TOL, bitwise_repeatable=bitwise,
               gated_on="plain" if plain_gate else "f64")
    if timed:
        reps = reps_for(args[0].numel() * args[0].element_size()
                        + args[1].numel() * args[1].element_size())
        _time_record(rec, {
            "ms": lambda: registry.dispatch(op, *args, backend="cuda"),
            "plain_ms": lambda: registry.dispatch(op, *args, backend="torch"),
            "library_ms": library}, reps)
        rec.update(bound_rec)
    return rec


def _f64_err(got, d64, g64) -> float:
    """max |got - (D Dᵀ, D GMᵀ) in f64| / max(1, max |f64|) over G and C."""
    want = (d64 @ d64.T, d64 @ g64.T)
    return max(float((a.double() - b).abs().max())
               / max(1.0, float(b.abs().max())) for a, b in zip(got, want))


def check_stream_stats(P: int, n: int, dt, gen, timed: bool = True,
                       D=None, GM=None, body: str = None,
                       f64: bool = False) -> dict:
    """``check_cross`` for stream_stats, plus the body the calls took
    (``body``, if given, must be it: ``mma`` for the tensor-core body,
    ``cross`` for cross.cuh's) and, with ``f64``, the kernel's and the
    plain version's error against an f64 product (the kernel's within
    CROSS_TOL)."""
    import torch
    from repro_torch.kernels import ops, stream
    if D is None:
        D = torch.randn((P, n), generator=gen, device="cuda").to(dt)
        GM = torch.randn((P, n), generator=gen, device="cuda").to(dt)
    took = "mma" if stream._mma_eligible(D, GM) else "cross"
    need(body is None or took == body,
         f"stream_stats P={P} n={n} {dt}: takes the {took} body, want {body}")
    stream.reset_body_launches()
    rec = check_cross(
        "stream_stats", (D, GM), {"P": P, "n": n}, dt,
        cross_bound(2 * P, n, P * (P + 1) // 2 + P * P, 2 * P * P, dt),
        timed, library=lambda: (D @ D.T, D @ GM.T))
    tally = stream.body_launches()
    need(tally[took] >= 2 and sum(tally.values()) == tally[took],
         f"stream_stats P={P} n={n} {dt}: body launches {tally}, want only "
         f"{took}")
    rec["body"] = took
    if timed:
        log(f"stream_stats P={P} n={n} {_dtype_name(dt)}: device kernels "
            "(launches in 3 calls, us per launch) " + _kernel_names(rec))
    if timed and took == "mma":
        need(any("stream_stats_mma" in k for k in rec["device_kernels"]),
             f"stream_stats P={P} n={n}: device kernels "
             f"{rec['device_kernels']}")
    if f64:
        d64, g64 = D.double(), GM.double()
        rec["f64_rel_err"] = _f64_err(ops.stream_stats(D, GM, backend="cuda"),
                                      d64, g64)
        rec["plain_f64_rel_err"] = _f64_err(
            ops.stream_stats(D, GM, backend="torch"), d64, g64)
        del d64, g64
        log(f"stream_stats P={P} n={n} {_dtype_name(dt)} against an f64 "
            f"product: kernel {rec['f64_rel_err']:.3e}, plain "
            f"{rec['plain_f64_rel_err']:.3e} (tolerance {CROSS_TOL})")
        need(rec["f64_rel_err"] <= CROSS_TOL,
             f"stream_stats P={P} n={n}: {rec['f64_rel_err']:.3e} off f64")
    return rec


def check_gram_block(Ka: int, Kb: int, n: int, dt, gen,
                     timed: bool = True, body: str = None, f64: bool = False,
                     plain_gate: bool = True, ua=None, ub=None,
                     g=None) -> dict:
    """``check_cross`` for gram_block (U_a and U_b row blocks of one matrix
    unless given), plus the body the calls took (``body``, if given, must
    be it: ``mma`` for gram_block_mma.cu, ``cross`` for gram_block.cu) and,
    with ``f64``, the kernel's and the plain version's error against an
    f64 product (the kernel's within CROSS_TOL).  ``plain_gate=False``
    (with ``f64``) gates on the f64 product alone: at n = 4 104 a c_a that
    cancels below 1 leaves the plain f32 version itself beyond CROSS_TOL of
    it."""
    import torch
    from repro_torch.kernels import gram, ops
    if ua is None:
        U = torch.randn((Ka + Kb, n), generator=gen, device="cuda").to(dt)
        ua, ub = U[:Ka], U[Ka:]              # row blocks of one matrix
        g = torch.randn((n,), generator=gen, device="cuda").to(dt)
    took = "mma" if gram._block_mma_eligible(ua, ub, g) else "cross"
    what = (f"gram_block Ka={Ka} Kb={Kb} n={n} {_dtype_name(ua.dtype)}/"
            f"{_dtype_name(ub.dtype)}/{_dtype_name(g.dtype)}")
    need(body is None or took == body,
         f"{what}: takes the {took} body, want {body}")
    gram.reset_block_body_launches()
    rec = check_cross(
        "gram_block", (ua, ub, g), {"Ka": Ka, "Kb": Kb, "n": n}, dt,
        cross_bound(Ka + Kb + 1, n, Ka * (Kb + 1), Ka * Kb + Ka, dt),
        timed, library=lambda: (ua @ ub.T, ua @ g),
        plain_gate=plain_gate or not f64)
    tally = gram.block_body_launches()
    need(tally[took] >= 2 and sum(tally.values()) == tally[took],
         f"{what}: body launches {tally}, want only {took}")
    rec["body"] = took
    if timed:
        log(f"{what}: device kernels (launches in 3 calls, us per launch) "
            + _kernel_names(rec))
        if took == "mma":
            need(any("gram_block_mma_partial" in k
                     for k in rec["device_kernels"]),
                 f"{what}: device kernels {rec['device_kernels']}")
    if f64:
        rec["f64_rel_err"] = _gram_f64_err(
            ops.gram_block_and_cross(ua, ub, g, backend="cuda"), ua, g, V=ub)
        rec["plain_f64_rel_err"] = _gram_f64_err(
            ops.gram_block_and_cross(ua, ub, g, backend="torch"), ua, g, V=ub)
        if timed:
            log(f"{what} against an f64 product: kernel "
                f"{rec['f64_rel_err']:.3e}, plain "
                f"{rec['plain_f64_rel_err']:.3e} (tolerance {CROSS_TOL})")
        need(rec["f64_rel_err"] <= CROSS_TOL,
             f"{what}: {rec['f64_rel_err']:.3e} off an f64 product")
    return rec


def _sketch_f64_err(got, U, R, chunk: int = 1 << 20) -> float:
    """max |got - U Rᵀ in f64| / max(1, max |f64|) (the f64 product summed
    over column chunks, so the copies stay small)."""
    import torch
    S64 = torch.zeros((U.shape[0], R.shape[0]), dtype=torch.float64,
                      device=U.device)
    for c0 in range(0, U.shape[1], chunk):
        S64 += U[:, c0:c0 + chunk].double() @ R[:, c0:c0 + chunk].double().T
    return (float((got.double() - S64).abs().max())
            / max(1.0, float(S64.abs().max())))


def check_sketch_apply(K: int, n: int, m: int, dt, gen, timed: bool = True,
                       body: str = None, f64: bool = False,
                       plain_gate: bool = True, U=None, R=None) -> dict:
    """``check_cross`` for sketch, plus the body the calls took (``body``,
    if given, must be it: ``mma`` for sketch_mma.cu, ``cross`` for
    sketch.cu) and, with ``f64``, the kernel's and the plain version's
    error against an f64 product (the kernel's within CROSS_TOL).
    ``plain_gate=False`` (with ``f64``) gates on the f64 product alone, as
    gram_block's sweep does."""
    import torch
    from repro_torch.kernels import ops, sketch
    if U is None:
        U = torch.randn((K, n), generator=gen, device="cuda").to(dt)
        R = torch.randn((m, n), generator=gen, device="cuda").to(dt)
    took = "mma" if sketch._mma_eligible(U, R) else "cross"
    what = (f"sketch K={K} n={n} m={m} {_dtype_name(U.dtype)}/"
            f"{_dtype_name(R.dtype)}")
    need(body is None or took == body,
         f"{what}: takes the {took} body, want {body}")
    sketch.reset_body_launches()
    rec = check_cross(
        "sketch", (U, R), {"K": K, "n": n, "m": m}, dt,
        cross_bound(K + m, n, K * m, K * m, dt), timed,
        library=lambda: U @ R.T, plain_gate=plain_gate or not f64)
    tally = sketch.body_launches()
    need(tally[took] >= 2 and sum(tally.values()) == tally[took],
         f"{what}: body launches {tally}, want only {took}")
    rec["body"] = took
    if timed:
        log(f"{what}: device kernels (launches in 3 calls, us per launch) "
            + _kernel_names(rec))
        if took == "mma":
            need(any("sketch_mma_partial" in k for k in rec["device_kernels"])
                 and any("sketch_mma_finish" in k
                         for k in rec["device_kernels"]),
                 f"{what}: device kernels {rec['device_kernels']}")
    if f64:
        rec["f64_rel_err"] = _sketch_f64_err(
            ops.sketch_apply(U, R, backend="cuda"), U, R)
        rec["plain_f64_rel_err"] = _sketch_f64_err(
            ops.sketch_apply(U, R, backend="torch"), U, R)
        if timed:
            log(f"{what} against an f64 product: kernel "
                f"{rec['f64_rel_err']:.3e}, plain "
                f"{rec['plain_f64_rel_err']:.3e} (tolerance {CROSS_TOL})")
        need(rec["f64_rel_err"] <= CROSS_TOL,
             f"{what}: {rec['f64_rel_err']:.3e} off an f64 product")
    return rec


def cross_phase_records(gen) -> dict:
    """The three cross-product kernels at their shapes (kernels phase)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    out = {"stream_stats": [], "gram_block": [], "sketch": []}
    for P, n in STREAM_PATH:
        out["stream_stats"].append(dict(
            check_stream_stats(P, n, f32, gen, body="cross"), set="path"))
    for P, n in STREAM_RAGGED:
        for dt in (f32, bf16):
            out["stream_stats"].append(dict(
                check_stream_stats(P, n, dt, gen, timed=False), set="ragged"))
    # slab views of a stacked leaf, and a strided column window (row stride
    # 400): taken as they lie
    leaf = torch.randn((3, 43, 7), generator=gen, device="cuda")
    gleaf = torch.randn((3, 43, 7), generator=gen, device="cuda")
    wide = torch.randn((5, 400), generator=gen, device="cuda")
    for D, GM in ((leaf.reshape(3, -1), gleaf.reshape(3, -1)),
                  (wide[:, 5:305], wide[:, 90:390])):
        out["stream_stats"].append(dict(check_stream_stats(
            D.shape[0], D.shape[1], f32, gen, timed=False, D=D, GM=GM),
            set="ragged"))
    # the tensor-core body: column views of 1 024-wide bf16 rows (16-byte
    # aligned) with ragged tails; a misaligned bf16 view and a mixed
    # f32/bf16 pair keep cross.cuh's body
    for P in STREAM_MMA_ROWS:
        D = torch.randn((P, 1024), generator=gen, device="cuda").to(bf16)
        GM = torch.randn((P, 1024), generator=gen, device="cuda").to(bf16)
        for n in STREAM_MMA_COLS:
            out["stream_stats"].append(dict(check_stream_stats(
                P, n, bf16, gen, timed=False, D=D[:, :n], GM=GM[:, :n],
                body="mma", f64=True), set="ragged"))
    out["stream_stats"].append(dict(check_stream_stats(
        16, 1000, bf16, gen, timed=False, D=D[:16, 1:1001],
        GM=GM[:16, 1:1001], body="cross"), set="ragged"))
    out["stream_stats"].append(dict(check_stream_stats(
        16, 1000, f32, gen, timed=False, D=D[:16, :1000].float(),
        GM=GM[:16, :1000], body="cross"), set="ragged"))
    for P, n in STREAM_MODEL:
        out["stream_stats"].append(dict(check_stream_stats(
            P, n, bf16, gen, body="mma", f64=True), set="model"))
        torch.cuda.empty_cache()
    for Ka, Kb, n in GRAM_BLOCK_PATH:
        ua = torch.randn((Ka, n), generator=gen, device="cuda")
        ub = torch.randn((Kb, n), generator=gen, device="cuda")
        g = torch.randn((n,), generator=gen, device="cuda")
        out["gram_block"].append(dict(
            check_gram_block(Ka, Kb, n, f32, gen, body="cross", ua=ua, ub=ub,
                             g=g), set="path"))
    for Ka, Kb, n in GRAM_BLOCK_BENCH:
        out["gram_block"].append(dict(
            check_gram_block(Ka, Kb, n, f32, gen, body="cross"), set="bench"))
    for Ka, Kb, n in GRAM_BLOCK_RAGGED:
        for dt in (f32, bf16):
            out["gram_block"].append(dict(
                check_gram_block(Ka, Kb, n, dt, gen, timed=False,
                                 body="cross"), set="ragged"))
    # the tensor-core body at every instance's edges and ragged last tiles,
    # held to an f64 product (the plain version's distance recorded); a
    # bf16 U_a starting 2 bytes into its buffer and a mixed f32/bf16 call
    # keep cross.cuh's body
    for Ka in GRAM_BLOCK_MMA_KA:
        for Kb in GRAM_BLOCK_MMA_KB:
            for n in GRAM_BLOCK_MMA_N:
                out["gram_block"].append(dict(check_gram_block(
                    Ka, Kb, n, bf16, gen, timed=False, body="mma", f64=True,
                    plain_gate=False), set="ragged"))
    shifted = torch.randn((10 * 1024 + 1,), generator=gen,
                          device="cuda").to(bf16)[1:].view(10, 1024)
    ub = torch.randn((5, 1024), generator=gen, device="cuda").to(bf16)
    g1024 = torch.randn((1024,), generator=gen, device="cuda").to(bf16)
    for ua in (shifted, shifted.float()):
        out["gram_block"].append(dict(check_gram_block(
            10, 5, 1024, ua.dtype, gen, timed=False, body="cross", ua=ua,
            ub=ub, g=g1024), set="ragged"))
    for Ka, Kb, n, dts in GRAM_BLOCK_MODEL:
        for dt in (getattr(torch, name) for name in dts):
            mma = dt == bf16
            out["gram_block"].append(dict(check_gram_block(
                Ka, Kb, n, dt, gen, body="mma" if mma else "cross", f64=mma),
                set="model"))
            torch.cuda.empty_cache()
    for K, n, m in SKETCH_APPLY_BENCH:
        out["sketch"].append(dict(check_sketch_apply(K, n, m, f32, gen,
                                                     body="cross"),
                                  set="bench"))
    for K, n, m in SKETCH_APPLY_RAGGED:
        for dt in (f32, bf16):
            mma = dt == bf16 and (K, n, m) == (11, 1000, 129)
            out["sketch"].append(dict(
                check_sketch_apply(K, n, m, dt, gen, timed=False,
                                   body="mma" if mma else "cross"),
                set="ragged"))
    # the tensor-core body at every instance's and slice's edges, U and R
    # row blocks of one matrix, held to an f64 product (the plain version's
    # distance recorded); row blocks at an odd n, a bf16 U starting 2 bytes
    # into its buffer and a mixed f32/bf16 pair keep cross.cuh's body
    for K in SKETCH_MMA_K:
        for m in SKETCH_MMA_M:
            for n in SKETCH_MMA_N:
                M = torch.randn((K + m, n), generator=gen,
                                device="cuda").to(bf16)
                out["sketch"].append(dict(check_sketch_apply(
                    K, n, m, bf16, gen, timed=False, body="mma", f64=True,
                    plain_gate=False, U=M[:K], R=M[K:]), set="ragged"))
    M = torch.randn((8 + 129, 1001), generator=gen, device="cuda").to(bf16)
    shifted = torch.randn((8 * 1024 + 1,), generator=gen,
                          device="cuda").to(bf16)[1:].view(8, 1024)
    r1024 = torch.randn((129, 1024), generator=gen, device="cuda").to(bf16)
    for U, R in ((M[:8], M[8:]), (shifted, r1024), (shifted.float(), r1024)):
        out["sketch"].append(dict(check_sketch_apply(
            8, U.shape[1], 129, U.dtype, gen, timed=False, body="cross", U=U,
            R=R), set="ragged"))
    for K, n, m in SKETCH_APPLY_MODEL:
        for dt in (f32, bf16):
            out["sketch"].append(dict(check_sketch_apply(K, n, m, dt, gen,
                                                         body="cross"),
                                      set="model"))
            torch.cuda.empty_cache()
    for K, n, m in SKETCH_MMA_MODEL:
        out["sketch"].append(dict(check_sketch_apply(
            K, n, m, bf16, gen, body="mma", f64=True), set="model"))
        torch.cuda.empty_cache()
    return out


def decode_bound(B: int, S: int, KV: int, G: int, hd: int, dt, lengths,
                 window) -> dict:
    """Least time of one flash_decode: the live K and V rows (and q, o,
    lse, lengths) at the HBM rate against its FMAs (QK and PV, 2·G·hd per
    live row and head) at the f32 rate."""
    import torch
    size = torch.finfo(dt).bits // 8
    live = sum(min(n, S) - (max(0, n - window) if window else 0)
               for n in lengths)
    nbytes = (2 * live * KV * hd * size + B * KV * G * hd * size
              + B * KV * G * (hd + 1) * 4 + 4 * B)
    flops = 4 * live * KV * G * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "live_rows": live}


def check_decode(B: int, S: int, KV: int, G: int, hd: int, dt, gen,
                 lengths=None, window=None, softcap=None, timed=True,
                 stacked=False) -> dict:
    """flash_decode against its plain version on the card (o and lse within
    DECODE_TOL, two calls bitwise equal, both on the body the inputs route
    to: ``mma``, decode_attn_mma.cu, for bf16 q, k and v at hd 64 or 128,
    ``cuda_core``, decode_attn.cu, otherwise); with ``timed``, CUDA-event
    times of the kernel, the plain version and SDPA on the same rows and
    the device µs of the call's kernels from ``torch.profiler``.  A row on
    the tensor-core body also times the CUDA-core body on the same inputs
    (held to the same tolerance), the two bodies in turn (CUDA-core,
    tensor-core, tensor-core, CUDA-core)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn, ops
    lengths = lengths or [S] * B
    q = torch.randn((B, KV, G, hd), generator=gen, device="cuda").to(dt)
    if stacked:     # layer 1 of a stacked (3, B, S, KV, hd) cache, in place
        k = torch.randn((3, B, S, KV, hd), generator=gen, device="cuda").to(dt)[1]
        v = torch.randn((3, B, S, KV, hd), generator=gen, device="cuda").to(dt)[1]
    else:
        k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dt)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kw = dict(window=window, softcap=softcap)
    body = "mma" if decode_attn._mma_eligible(q, k, v) else "cuda_core"
    decode_attn.reset_body_launches()
    got = ops.flash_decode(q, k, v, ln, backend="cuda", **kw)
    again = ops.flash_decode(q, k, v, ln, backend="cuda", **kw)
    tally = decode_attn.body_launches()
    want = ops.flash_decode(q, k, v, ln, backend="torch", **kw)
    torch.cuda.synchronize()
    what = f"flash_decode B={B} S={S} KV={KV} G={G} hd={hd} {dt}"
    need(tally[body] == 2 and sum(tally.values()) == 2,
         f"{what}: body launches {tally}, want 2 on {body}")
    need(all(a.shape == b.shape and a.dtype == torch.float32
             for a, b in zip(got, want)), f"{what}: output shapes")
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    need(bitwise, f"{what}: two calls differ bitwise")
    err = max(_max_err(a, b) / _scale(b) for a, b in zip(got, want))
    need(err <= DECODE_TOL, f"{what}: relative err {err:.3e} > {DECODE_TOL}")
    rec = {"B": B, "S": S, "KV": KV, "G": G, "hd": hd,
           "dtype": _dtype_name(dt), "window": window, "softcap": softcap,
           "lengths": lengths if len(set(lengths)) > 1 else f"all {S}",
           "max_abs_err": max(_max_err(a, b) for a, b in zip(got, want)),
           "rel_err": err, "tolerance": DECODE_TOL,
           "bitwise_repeatable": bitwise, "body": body}
    if body == "mma":
        first = decode_attn.flash_decode_cuda(q, k, v, ln, body="cuda_core",
                                              **kw)
        rec["cuda_core_rel_err"] = max(_max_err(a, b) / _scale(b)
                                       for a, b in zip(first, want))
        need(rec["cuda_core_rel_err"] <= DECODE_TOL,
             f"{what}: the CUDA-core body {rec['cuda_core_rel_err']:.3e} "
             f"off plain")
    if timed:
        b_rec = decode_bound(B, S, KV, G, hd, dt, lengths, window)
        reps = reps_for(b_rec["bytes"])
        kernel = lambda: ops.flash_decode(q, k, v, ln, backend="cuda", **kw)  # noqa: E731
        if body == "mma":
            parent = lambda: decode_attn.flash_decode_cuda(  # noqa: E731
                q, k, v, ln, body="cuda_core", **kw)
            runs = [time_ms(fn, reps) for fn in (parent, kernel, kernel,
                                                 parent)]
            rec["ms_runs"], rec["cuda_core_ms_runs"] = runs[1:3], runs[::3]
            rec["ms"] = statistics.median(runs[1:3])
            rec["cuda_core_ms"] = statistics.median(runs[::3])
            kernels = device_kernel_means(parent)
            rec["cuda_core_device_kernels"] = kernels
            rec["cuda_core_device_ms"] = sum(ms for _, ms in kernels.values())
        else:
            rec["ms"] = time_ms(kernel, reps)
        rec["plain_ms"] = time_ms(
            lambda: ops.flash_decode(q, k, v, ln, backend="torch", **kw), reps)
        kernels = device_kernel_means(kernel)
        rec["device_kernels"] = kernels
        rec["device_ms"] = sum(ms for _, ms in kernels.values())
        rec["device_kernels_per_call"] = len(kernels)
        rec["host_ms"] = host_ms(kernel, reps)
        if body == "mma":
            need(any("decode_mma_partial" in name for name in kernels),
                 f"{what}: device kernels {list(kernels)}")
        # SDPA on the same rows with a length (and window) mask; it returns
        # o but no lse.  k and v are transposed to (B, KV, S, hd) once,
        # outside the timing.
        qh = q.reshape(B, KV * G, 1, hd)
        kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        pos = torch.arange(S, device="cuda")[None, :]
        ok = pos < ln[:, None]
        if window:
            ok = ok & (pos > ln[:, None] - 1 - window)
        mask = ok[:, None, None, :]
        try:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, attn_mask=mask, enable_gqa=True)
            lib()
            rec["library_ms"] = None if softcap else time_ms(lib, reps)
            if rec["library_ms"] is not None:
                rec["library_device_ms"] = sum(
                    ms for _, ms in device_kernel_means(lib).values())
        except (RuntimeError, TypeError) as exc:
            rec["library_ms"], rec["library_error"] = None, str(exc)[:200]
        rec["library"] = ("scaled_dot_product_attention(enable_gqa, bool "
                          "length mask): o only, no lse; transpose not timed")
        rec.update(b_rec)
        if body == "mma":
            log(f"{what} window={window}: tensor-core body "
                f"{' / '.join(f'{t * 1e3:.1f}' for t in rec['ms_runs'])} us, "
                f"CUDA-core body "
                f"{' / '.join(f'{t * 1e3:.1f}' for t in rec['cuda_core_ms_runs'])}"
                f" us (in turn: CUDA-core, tensor-core, tensor-core, "
                f"CUDA-core); device kernels (launches in 3 calls, us per "
                f"launch) tensor-core: " + _kernel_names(rec) + "; CUDA-core: "
                + _kernel_names({"device_kernels":
                                 rec["cuda_core_device_kernels"]})
                + f"; SDPA device {rec.get('library_device_ms', 0) * 1e3:.1f}"
                " us")
        else:
            log(f"{what} window={window}: device kernels (launches in 3 "
                f"calls, us per launch) " + _kernel_names(rec))
    return rec


def decode_phase_records(gen) -> list:
    """flash_decode at the serve path's shape, model shapes, and ragged,
    strided, windowed, soft-capped and f32 shapes (kernels phase); the
    bf16 rows at hd 64 and 128 take the tensor-core body, the rest the
    CUDA-core body."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    B, S, KV, G, hd, window, lengths = DECODE_PATH
    recs = [dict(check_decode(B, S, KV, G, hd, bf16, gen, lengths, window),
                 set="path")]
    for B, S, KV, G, hd, window, lengths in DECODE_MODEL:
        recs.append(dict(check_decode(B, S, KV, G, hd, bf16, gen, lengths,
                                      window), set="model"))
        torch.cuda.empty_cache()
    ragged = [
        dict(B=4, S=256, KV=8, G=5, hd=128, dt=f32, lengths=[1, 97, 200, 256]),
        dict(B=4, S=256, KV=8, G=5, hd=128, dt=bf16, stacked=True,
             lengths=[256, 1, 31, 130]),
        dict(B=4, S=8192, KV=16, G=1, hd=256, dt=bf16, softcap=50.0,
             lengths=[1, 8192, 4000, 8191]),
        dict(B=3, S=1000, KV=4, G=12, hd=128, dt=bf16, window=64,
             lengths=[1, 1000, 65]),
        dict(B=3, S=77, KV=4, G=1, hd=64, dt=f32, lengths=[1, 77, 40]),
        dict(B=2, S=4097, KV=2, G=3, hd=64, dt=bf16, window=4096,
             softcap=30.0, lengths=[4097, 2]),
        dict(B=8, S=1000, KV=2, G=16, hd=64, dt=bf16, window=300,
             softcap=30.0, lengths=[1, 63, 64, 65, 299, 300, 301, 1000]),
        dict(B=3, S=300, KV=4, G=12, hd=128, dt=f32, window=100,
             lengths=[300, 1, 150])]
    for c in ragged:
        dt = c.pop("dt")
        recs.append(dict(check_decode(gen=gen, dt=dt, timed=False, **c),
                         set="ragged"))
    return recs


def _fmt_us(v) -> str:
    return "     none" if v is None else f"{v * 1e3:9.1f}"


def _fmt_spread(rec: dict, key: str) -> str:
    """The time, and its min-max over the rounds where it has a spread."""
    if key + "_min" not in rec:
        return _fmt_us(rec[key])
    return (f"{_fmt_us(rec[key])} [{rec[key + '_min'] * 1e3:.1f}-"
            f"{rec[key + '_max'] * 1e3:.1f}]")


def _log_rec(name: str, rec: dict) -> None:
    shape = " ".join(f"{k}={rec[k]}" for k in ("P", "K", "Ka", "Kb", "n", "k",
                                                "m", "B", "S", "KV", "G",
                                                "hd", "window") if k in rec)
    kernels = (f" kernels/call={rec['device_kernels_per_call']} device="
               f"{rec['device_ms'] * 1e3:.1f}us"
               if "device_kernels_per_call" in rec else "")
    if "host_ms" in rec:
        kernels += f" host={rec['host_ms'] * 1e3:.1f}us"
    if "body" in rec:
        kernels += f" body={rec['body']}"
    log(f"{name:19s} {rec['set']:6s} {shape:28s} {rec['dtype']:9s} "
        f"err={rec['max_abs_err']:.3e} kernel={_fmt_spread(rec, 'ms')}us "
        f"plain={_fmt_spread(rec, 'plain_ms')}us "
        f"library={_fmt_spread(rec, 'library_ms')}us "
        f"bound={rec['bound_ms'] * 1e3:9.2f}us ({rec['bound_by']}){kernels}")


def _tie_vectors(n: int):
    import torch
    ar = torch.arange(n, device="cuda")
    return [torch.where(ar % 3 == 0, -2.5, 2.5),
            torch.zeros(n, device="cuda"),
            torch.where(ar % 2 == 0, 0.0, -0.0),
            (ar % 4).float() - 1.5]


def kernels_phase() -> dict:
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {"gram": [], "combine": [], "topk": [], "sign_sketch": [],
           "sign_sketch_adjoint": []}
    f32, bf16 = torch.float32, torch.bfloat16
    K, n = PATH_SHAPE
    for name, check in (("gram", check_gram), ("combine", check_combine)):
        out[name].append(dict(check(K, n, f32, gen, **(
            dict(f64=True) if name == "combine" else {})), set="path"))
        for Kr, nr in RAGGED:
            for dt in (f32, bf16):
                out[name].append(dict(check(Kr, nr, dt, gen, timed=False),
                                      set="ragged"))
        for Km, nm in MODEL:
            for dt in (f32, bf16):
                # gram's bf16 rows at n = 2^24 take the tensor-core body;
                # combine's f32 rows are held to an f64 sum too
                mma = name == "gram" and dt == bf16 and nm % 8 == 0
                kw = (dict(body="mma" if mma else "cuda_core", f64=mma)
                      if name == "gram" else dict(f64=dt == f32))
                out[name].append(dict(check(Km, nm, dt, gen, **kw),
                                      set="model"))
                torch.cuda.empty_cache()
    # combine at the streamed apply: K = 100 at the paper path (f32), and
    # the big-model round's slabs (bf16 rows into f32 parameters): the
    # embedding and an MLP matrix
    out["combine"].append(dict(check_combine(100, 7840, f32, gen, f64=True),
                               set="path"))
    for nb in BIG_SLABS:
        out["combine"].append(dict(check_combine(BIG["P"], nb, bf16, gen,
                                                 w_dt=f32, f64=True),
                                   set="model"))
        torch.cuda.empty_cache()
    # combine_vec.cu at each split and ragged last chunks, all four
    # (U, w) dtype pairs
    for Kr, nr in COMBINE_VEC_RAGGED:
        for dt, w_dt in ((f32, None), (bf16, None), (bf16, f32), (f32, bf16)):
            rec = check_combine(Kr, nr, dt, gen, timed=False, w_dt=w_dt)
            need(rec["body"] == "vec", f"combine K={Kr} n={nr}: {rec['body']}")
            out["combine"].append(dict(rec, set="ragged"))
    for Kw, nw in GRAM_GATEWAY + GRAM_WIDE:
        for dt in (f32, bf16):
            mma = dt == bf16 and nw % 8 == 0
            out["gram"].append(dict(
                check_gram(Kw, nw, dt, gen, f64=mma,
                           body="mma" if mma else "cuda_core"),
                set="path" if nw == N_PATH else "model"))
            torch.cuda.empty_cache()
    # gram's tensor-core body at every tile count with ragged last tiles
    # (against f64 too), and bf16 calls that keep gram.cu's body: K = 128,
    # n % 8 != 0, U starting 2 bytes into its buffer, and an f32 U
    for Km in GRAM_MMA_K:
        for nm in GRAM_MMA_N:
            out["gram"].append(dict(check_gram(Km, nm, bf16, gen, timed=False,
                                               body="mma", f64=True),
                                    set="ragged"))
    shifted = torch.randn((10 * 1024 + 1,), generator=gen,
                          device="cuda").to(bf16)[1:].view(10, 1024)
    g1024 = torch.randn((1024,), generator=gen, device="cuda").to(bf16)
    for Km, nm, U_, g_ in ((128, 1024, None, None), (10, 1001, None, None),
                           (10, 1024, shifted, g1024),
                           (10, 1024, shifted.float(), g1024)):
        out["gram"].append(dict(check_gram(Km, nm, bf16, gen, timed=False,
                                           body="cuda_core", U=U_, g=g_),
                                set="ragged"))

    for nk in TOPK_PATH:
        out["topk"].append(dict(check_topk(*nk, gen), set="path"))
    for nk in TOPK_RAGGED:
        out["topk"].append(dict(check_topk(*nk, gen, timed=False),
                                set="ragged"))
    for v in _tie_vectors(130):
        for k in (1, 17, 130):
            out["topk"].append(dict(check_topk(130, k, gen, False, v=v),
                                    set="ragged"))
    for nk in TOPK_MODEL:
        out["topk"].append(dict(check_topk(*nk, gen), set="model"))
        torch.cuda.empty_cache()

    for K_, n_, m_ in SKETCH_PATH:
        out["sign_sketch"].append(dict(check_sketch(K_, n_, m_, f32, gen),
                                       set="path"))
        out["sign_sketch_adjoint"].append(dict(check_adjoint(m_, n_, gen),
                                               set="path"))
    for K_, n_, m_ in SKETCH_RAGGED:
        for dt in (f32, bf16):
            out["sign_sketch"].append(dict(
                check_sketch(K_, n_, m_, dt, gen, timed=False), set="ragged"))
        out["sign_sketch_adjoint"].append(dict(
            check_adjoint(m_, n_, gen, timed=False), set="ragged"))
    for K_, n_, m_ in SKETCH_MODEL:
        out["sign_sketch"].append(dict(check_sketch(K_, n_, m_, f32, gen),
                                       set="model"))
        if K_ == 1:
            out["sign_sketch_adjoint"].append(dict(
                check_adjoint(m_, n_, gen), set="model"))
        torch.cuda.empty_cache()
    out["sign_sketch"].append(dict(check_sketch(8, (1 << 20) + 3, 1024, bf16,
                                                gen), set="model"))
    # one contextual_async flush's kernels (buffer 5, paper-logreg width):
    # gram over the five flattened updates, combine_vec.cu on W's rows and
    # combine.cu on b's 40-byte rows, timed with their plain versions and
    # yardsticks as the path rows
    out["gram"].append(dict(check_gram(5, N_PATH, f32, gen), set="async"))
    for n_leaf in (784 * 10, 10):
        out["combine"].append(dict(check_combine(5, n_leaf, f32, gen),
                                   set="async"))
    out.update(cross_phase_records(gen))
    out["flash_decode"] = decode_phase_records(gen)
    torch.cuda.empty_cache()

    for name, recs in out.items():
        for rec in recs:
            if "ms" in rec:
                _log_rec(name, rec)
        ragged = [r for r in recs if r["set"] == "ragged"]
        log(f"{name:19s} ragged: {len(ragged)} shapes within tolerance, "
            f"worst rel err {max(_gated_err(r) for r in ragged):.3e}")
        on_f64 = [r for r in ragged if r.get("gated_on") == "f64"]
        if on_f64:
            log(f"{name:19s} ragged: {len(on_f64)} of them held to an f64 "
                f"product (kernel worst {max(_gated_err(r) for r in on_f64):.3e}"
                f"); the plain version there: worst "
                f"{max(r['plain_f64_rel_err'] for r in on_f64):.3e} off f64, "
                f"{max(r['rel_err'] for r in on_f64):.3e} off the kernel")
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


def path_phase():
    """Drive the paper-logreg path; returns its launch counts, the data and
    the initial parameters (the hier phase reuses them)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fl import ServerConfig, run_simulation
    from repro_torch.kernels import (decode_attn, launch_counts,
                                     reset_launch_counts)
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
    return {k: ctx[k] + avg[k] for k in ctx}, ds, params


# -------------------------------------------------------------------- hier

def hier_round_vs_cpu(ds, params, topo, cfg, engine: str = "fused",
                      **run_kw) -> float:
    """One hier round on the card against the same round on the CPU (plain
    versions); both draw their mini-batches from a CPU generator with one
    seed, so they train on the same batches (``run_kw`` goes to both runs).
    Returns max |Δ new params| relative to max |params|."""
    import torch
    from repro_torch.core.flatten import tree_map, tree_to_vector
    from repro_torch.fl import run_hier_simulation
    from repro_torch.models.logistic import logistic_apply, logistic_loss
    news = []
    for dev in ("cuda", "cpu"):
        got = []
        batches = torch.Generator()
        batches.manual_seed(7)
        run_hier_simulation(
            "vs_cpu", logistic_loss, logistic_apply,
            tree_map(lambda p: p.to(dev), params), ds, cfg, topo, 1,
            selection_seed=7, device=dev, batch_generator=batches,
            engine=engine,
            publish_fn=lambda t, p: got.append(tree_to_vector(p).cpu()),
            **run_kw)
        need(len(got) == 1, "the card-vs-CPU round was skipped")
        news.append(got[0])
    return _max_err(news[0], news[1]) / _scale(news[1])


def hier_phase(ds, params) -> dict:
    """Drive run_hier_simulation at paper-logreg width; returns its launch
    counts, summed over the runs."""
    import numpy as np
    import torch
    from repro_torch.compress import CompressConfig
    from repro_torch.edge import bimodal_fleet
    from repro_torch.fl import run_hier_simulation
    from repro_torch.hier import HierConfig, star_topology, two_tier_topology
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.logistic import logistic_apply, logistic_loss
    from repro_torch.obs import InMemoryTracker, use_tracker
    from repro_torch.obs.spans import span_fields

    fleet = bimodal_fleet(ds.num_devices, slowdown=10.0, dropout_slow=0.05,
                          seed=0)
    star, tiers = star_topology(fleet), two_tier_topology(fleet, 4)
    plain_cfg = HierConfig(**HIER_CFG)
    sketch = dict(aggregator="hier_contextual_sketch", **HIER_CFG)
    runs = [
        ("star", star, plain_cfg, ()),
        ("two_tier", tiers, plain_cfg, ()),
        ("topk", tiers, HierConfig(compress=CompressConfig(
            scheme="topk", ratio=3.4, u_frac=0.75), **sketch), ("topk",)),
        ("sign_sketch", tiers, HierConfig(compress=CompressConfig(
            scheme="sign_sketch", ratio=4.0), **sketch),
         ("sign_sketch", "sign_sketch_adjoint")),
    ]
    log(f"hier: {ds.num_devices} devices (bimodal, slowdown 10, dropout_slow "
        f"0.05), {HIER_ROUNDS} rounds per run, lr {HIER_CFG['lr']}")
    results, total = {}, {}
    for name, topo, cfg, compress_ops in runs:
        snaps = []
        tracker = InMemoryTracker()
        torch.cuda.synchronize()
        reset_launch_counts()
        with use_tracker(tracker):
            res = run_hier_simulation(
                name, logistic_loss, logistic_apply, params, ds, cfg, topo,
                HIER_ROUNDS, selection_seed=42, device="cuda",
                publish_fn=lambda t, p: snaps.append(launch_counts()))
        torch.cuda.synchronize()
        counts = launch_counts()
        results[name] = res
        for key, v in counts.items():
            total[key] = total.get(key, 0) + v
        round_ms = [span_fields(e)["dur_wall_s"] * 1e3
                    for e in tracker.span_events()
                    if span_fields(e)["name"] == "round"]
        need(np.isfinite(res.train_loss).all(),
             f"hier {name}: non-finite losses {res.train_loss}")
        need(res.train_loss[-1] < res.train_loss[0],
             f"hier {name}: loss did not fall: {res.train_loss}")
        need(len(snaps) == HIER_ROUNDS - res.rounds_skipped,
             f"hier {name}: {len(snaps)} rounds published")
        prev = {k: 0 for k in counts}
        for t, snap in enumerate(snaps):
            for op in ("gram",) + compress_ops:
                need(snap[f"{op}/cuda"] > prev[f"{op}/cuda"],
                     f"hier {name}: round {t} launched no {op}/cuda")
            prev = snap
        plain = {k: v for k, v in counts.items() if k.endswith("/torch") and v}
        need(not plain, f"hier {name}: plain versions ran on the path: {plain}")
        log(f"hier {name:11s} loss {res.train_loss[0]:.4f} -> "
            f"{res.train_loss[-1]:.4f}  acc {res.test_acc[-1]:.4f}  "
            f"cloud uplink {res.cloud_uplink_bytes:.0f} B  "
            f"skipped {res.rounds_skipped}  round ms median "
            f"{statistics.median(round_ms):.2f} (first {round_ms[0]:.2f}, all "
            f"{[round(r, 2) for r in round_ms]})  launches "
            f"{ {k: v for k, v in counts.items() if v} }")
    up = {k: r.cloud_uplink_bytes for k, r in results.items()}
    need(up["topk"] < up["two_tier"] and up["sign_sketch"] < up["two_tier"]
         and up["two_tier"] < up["star"],
         f"hier: cloud uplink bytes out of order: {up}")
    for name, topo, cfg, _ in runs[1:]:
        rel = hier_round_vs_cpu(ds, params, topo, cfg)
        gated = name != "topk"
        log(f"hier: one {name} round, card vs CPU, max rel err of new params "
            f"{rel:.3e} ({'tolerance 1e-4' if gated else 'not gated: a near tie in ū may pick another coordinate'})")
        if gated:
            need(rel <= 1e-4, f"hier {name}: card round disagrees with the "
                 f"CPU round: {rel:.3e}")
    return total


# ------------------------------------------------------------------- async

def _async_items(ds, params, cfg):
    """``cfg.buffer_size`` buffered updates of mixed staleness (dispatch
    versions 0, 1, ...) trained on the CPU from one seeded generator:
    ``[(delta, grad, dispatch version, device id)]`` on the CPU."""
    import torch
    from repro_torch.core.flatten import tree_map
    from repro_torch.fl.client import client_update, draw_batch_indices
    from repro_torch.models.logistic import logistic_loss
    spe = max(ds.samples_per_device // cfg.batch_size, 1)
    max_steps = cfg.max_epochs * spe
    cpu_params = tree_map(lambda p: p.cpu(), params)
    gen = torch.Generator()
    gen.manual_seed(7)
    items = []
    for j, d in enumerate((3, 22, 41, 60, 79)[:cfg.buffer_size]):
        x = torch.as_tensor(ds.x[d:d + 1])
        y = torch.as_tensor(ds.y[d:d + 1], dtype=torch.long)
        mask = torch.as_tensor(ds.mask[d:d + 1])
        idx = draw_batch_indices(mask, max_steps, cfg.batch_size, gen)
        delta, grad = client_update(logistic_loss, cpu_params, x, y, mask,
                                    torch.tensor([spe * (2 * j + 1)]), idx,
                                    lr=cfg.lr)
        items.append((tree_map(lambda t: t[0], delta),
                      tree_map(lambda t: t[0], grad), j, d))
    return items


def _async_flush(cfg, items, params, device: str):
    """One flush of ``items`` into ``params`` on ``device`` at model version
    ``len(items)``: ``(new params, info)``."""
    from repro_torch.core.flatten import tree_map
    from repro_torch.edge import AsyncBuffer, BufferedUpdate
    buf = AsyncBuffer(cfg)
    for delta, grad, ver, d in items:
        buf.add(BufferedUpdate(tree_map(lambda t: t.to(device), delta),
                               tree_map(lambda t: t.to(device), grad),
                               ver, d))
    return buf.flush(tree_map(lambda p: p.to(device), params), len(items))


def async_flush_vs_cpu(cfg, items, params) -> dict:
    """One ``contextual_async`` flush on the card against the same flush on
    the CPU (plain versions), from the same buffered deltas and gradients;
    returns the max |Δ new params| relative to max |new params| and the
    same for α."""
    from repro_torch.core.flatten import tree_to_vector
    outs = [_async_flush(cfg, items, params, dev) for dev in ("cuda", "cpu")]
    (new_c, info_c), (new_p, info_p) = outs
    vec_c, vec_p = tree_to_vector(new_c).cpu(), tree_to_vector(new_p)
    return {"params_rel_err": _max_err(vec_c, vec_p) / _scale(vec_p),
            "alpha_rel_err": _max_err(info_c["alpha"].cpu(), info_p["alpha"])
            / _scale(info_p["alpha"]),
            "staleness": [float(t) for t in info_p["staleness"]]}


def async_flush_kernels(cfg, items, params) -> dict:
    """Device µs of one ``contextual_async`` flush's ``gram`` and
    ``combine`` launches (``torch.profiler``, mean per launch over three
    flushes) beside their bounds."""
    import torch
    flush = lambda: _async_flush(cfg, items, params, "cuda")  # noqa: E731
    rows = device_kernel_means(flush)
    K, f32 = cfg.buffer_size, torch.float32
    n_w, n_b = 784 * 10, 10
    out = {}
    for key, (count, ms) in rows.items():
        kind = ("combine_vec" if "combine_vec_kernel" in key else
                "combine" if "combine_kernel" in key else
                "gram_finish" if "gram_finish" in key else
                "gram" if "gram_partial" in key else None)
        if kind is not None:
            out[kind] = {"launches_in_3_flushes": count, "device_ms": ms}
    need(set(out) >= {"combine_vec", "combine", "gram"},
         f"async flush: device kernels {list(rows)}, want gram's and "
         "combine's two bodies")
    out["gram"]["bound"] = gram_bound(K, N_PATH, f32)
    out["combine_vec"]["bound"] = combine_bound(K, n_w, f32)
    out["combine"]["bound"] = combine_bound(K, n_b, f32)
    out["all_kernels"] = {k: v for k, v in rows.items()}
    return out


def async_bench_ordering() -> dict:
    """``BENCH_async.json``'s ordering at slowdown 1.0 on the card:
    contextual-async reaches 0.5 test accuracy on Synthetic(1,1) at an
    earlier virtual time than fedavg-sync (``benchmarks/async_vs_sync.py``'s
    configs, ``benchmarks/common.py``'s data; 30 sync rounds as there, the
    async run's first ``ASYNC_BENCH_FLUSHES`` of its 30 flushes: the time
    to 0.5 is fixed by the first flushes, the reference's 0.0082 s of
    0.039)."""
    import numpy as np
    from repro_torch.data import FederatedDataset, make_synthetic
    from repro_torch.edge import (AsyncConfig, bimodal_fleet,
                                  model_flops_per_step, model_payload_bytes,
                                  run_async_simulation, sync_wallclock_curve)
    from repro_torch.fl import ServerConfig, run_simulation
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.logistic import (init_logistic, logistic_apply,
                                             logistic_loss)
    xs, ys = make_synthetic(1.0, 1.0, num_devices=30, samples_per_device=60,
                            dim=60, seed=0)
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, 60)[:400], ys.reshape(-1)[:400], 10)
    params = init_logistic(ArchConfig(name="lr", family="logreg",
                                      input_dim=60, num_classes=10), 0,
                           device="cuda")
    fleet = bimodal_fleet(30, slowdown=1.0, dropout_slow=0.1, seed=0)
    common = dict(num_devices=30, lr=0.2, batch_size=10, min_epochs=1,
                  max_epochs=20)
    sync_cfg = ServerConfig(aggregator="fedavg", clients_per_round=10,
                            **common)
    r = run_simulation("fedavg-sync", logistic_loss, logistic_apply, params,
                       ds, sync_cfg, num_rounds=30, selection_seed=42,
                       eval_every=2, device="cuda")
    sync = sync_wallclock_curve(
        r, fleet, sync_cfg, max(ds.samples_per_device // 10, 1), 30, 2,
        model_flops_per_step(params, 10), model_payload_bytes(params),
        selection_seed=42)
    a = run_async_simulation(
        "contextual-async", logistic_loss, logistic_apply, params, ds,
        AsyncConfig(aggregator="contextual_async", buffer_size=5,
                    concurrency=10, staleness_mode="poly",
                    staleness_decay=0.5, **common),
        fleet, num_aggregations=ASYNC_BENCH_FLUSHES, selection_seed=42,
        eval_every=2, device="cuda")
    out = {"target_acc": 0.5,
           "fedavg_sync_s": sync.time_to_accuracy(0.5),
           "contextual_async_s": a.time_to_accuracy(0.5),
           "fedavg_sync_best_acc": max(sync.test_acc),
           "contextual_async_best_acc": max(a.test_acc)}
    need(out["contextual_async_s"] is not None
         and (out["fedavg_sync_s"] is None
              or out["contextual_async_s"] < out["fedavg_sync_s"]),
         f"async: contextual-async does not reach 0.5 accuracy before "
         f"fedavg-sync on Synthetic(1,1): {out}")
    return out


def async_phase(ds, params) -> dict:
    """Drive run_async_simulation at paper-logreg width; returns the launch
    counts of its three runs, summed, and its numbers."""
    import numpy as np
    import torch
    from repro_torch.edge import AsyncConfig, bimodal_fleet, run_async_simulation
    from repro_torch.kernels import combine, launch_counts, reset_launch_counts
    from repro_torch.models.logistic import logistic_apply, logistic_loss
    from repro_torch.obs import InMemoryTracker, use_tracker

    t0 = time.perf_counter()
    fleet = bimodal_fleet(ds.num_devices, **ASYNC_FLEET)
    runs = [("contextual_async", dict(aggregator="contextual_async")),
            ("fedbuff", dict(aggregator="fedbuff", server_lr=0.5)),
            ("fedasync", dict(aggregator="fedasync", buffer_size=1))]
    log(f"async: {ds.num_devices} devices (bimodal, slowdown "
        f"{ASYNC_FLEET['slowdown']}, dropout_slow "
        f"{ASYNC_FLEET['dropout_slow']}), {ASYNC_FLUSHES} flushes per run, "
        f"{ASYNC_CFG}")

    def drive(agg, kw, flushes=ASYNC_FLUSHES):
        tracker = InMemoryTracker()
        torch.cuda.synchronize()
        reset_launch_counts()
        before = combine.body_launches()
        with use_tracker(tracker):
            res = run_async_simulation(
                agg, logistic_loss, logistic_apply, params, ds,
                AsyncConfig(**dict(ASYNC_CFG, **kw)), fleet,
                num_aggregations=flushes, selection_seed=42,
                eval_every=5, device="cuda")
        torch.cuda.synchronize()
        return (res, launch_counts(),
                _tally_since(before, combine.body_launches()), tracker)

    results, total, numbers = {}, {}, {"runs": {}}
    for agg, kw in runs:
        res, counts, bodies, tracker = drive(agg, kw)
        results[agg] = res
        for key, v in counts.items():
            total[key] = total.get(key, 0) + v
        F = ASYNC_FLUSHES
        need(np.isfinite(res.train_loss).all() and
             res.train_loss[-1] < res.train_loss[0],
             f"async {agg}: losses did not fall: {res.train_loss}")
        want_gram = F if agg == "contextual_async" else 0
        need(counts["gram/cuda"] == want_gram,
             f"async {agg}: gram/cuda launched {counts['gram/cuda']} times in "
             f"{F} flushes, want {want_gram}")
        need(counts["combine/cuda"] == 2 * F,
             f"async {agg}: combine/cuda launched {counts['combine/cuda']} "
             f"times in {F} flushes, want 2 a flush (W and b)")
        plain = {k: v for k, v in counts.items() if k.endswith("/torch") and v}
        need(not plain, f"async {agg}: plain versions ran: {plain}")
        # each flush: W (K, 7 840) f32 rows of 31 360 bytes on combine_vec.cu,
        # b (K, 10) rows of 40 bytes on combine.cu
        need(bodies == {"vec": F, "scalar": F},
             f"async {agg}: combine bodies {bodies}, want {F} vec (W) and "
             f"{F} scalar (b)")
        cu, ag = _round_ms(tracker, "client_update"), _round_ms(
            tracker, "aggregate")
        numbers["runs"][agg] = {
            "train_loss": [res.train_loss[0], res.train_loss[-1]],
            "test_acc": res.test_acc[-1], "virtual_s": res.times[-1],
            "arrived": res.arrived, "dropped": res.dropped,
            "staleness_mean": float(np.mean(res.staleness_mean)),
            "combine_bodies": bodies,
            "client_update_ms_per_flush": sum(cu) / F,
            "client_update_ms_mean": statistics.mean(cu),
            "aggregate_ms_mean": statistics.mean(ag),
            "aggregate_ms_median": statistics.median(ag),
            "wall_s": res.wall_time}
        log(f"async {agg:16s} loss {res.train_loss[0]:.4f} -> "
            f"{res.train_loss[-1]:.4f}  acc {res.test_acc[-1]:.4f}  virtual "
            f"{res.times[-1]:.4f} s  arrived {res.arrived} dropped "
            f"{res.dropped}  per flush: client_update "
            f"{sum(cu) / F:.2f} ms ({len(cu)} updates, "
            f"{statistics.mean(cu):.2f} ms each), aggregate "
            f"{statistics.mean(ag):.2f} ms (median "
            f"{statistics.median(ag):.2f})  launches "
            f"{ {k: v for k, v in counts.items() if v} }  combine bodies "
            f"{bodies}")

    again = drive(*runs[0], flushes=ASYNC_REPEAT_FLUSHES)[0]
    first = results["contextual_async"]
    same_times = again.times == first.times[:len(again.times)]
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(again.train_loss, first.train_loss))
    need(same_times and len(again.times) == ASYNC_REPEAT_FLUSHES // 5
         and loss_rel <= 1e-6,
         f"async: two card runs differ: times equal {same_times}, loss rel "
         f"diff {loss_rel:.3e}")
    log(f"async: a second contextual_async run on the card "
        f"({ASYNC_REPEAT_FLUSHES} flushes, {len(again.times)} evals) against "
        f"the first one's: virtual times bitwise equal, largest train-loss "
        f"rel diff {loss_rel:.3e} (tolerance 1e-6)")
    numbers["repeat_loss_rel_diff"] = loss_rel

    flush_cfg = AsyncConfig(aggregator="contextual_async", **ASYNC_CFG)
    items = _async_items(ds, params, flush_cfg)
    vs = async_flush_vs_cpu(flush_cfg, items, params)
    log(f"async: one contextual_async flush (staleness {vs['staleness']}), "
        f"card vs CPU: max rel err of new params {vs['params_rel_err']:.3e}, "
        f"of alpha {vs['alpha_rel_err']:.3e} (tolerance 1e-4)")
    need(vs["params_rel_err"] <= 1e-4 and vs["alpha_rel_err"] <= 1e-4,
         f"async: card flush disagrees with the CPU flush: {vs}")
    numbers["flush_vs_cpu"] = vs

    kern = async_flush_kernels(flush_cfg, items, params)
    for kind in ("gram", "gram_finish", "combine_vec", "combine"):
        if kind not in kern:
            continue
        k = kern[kind]
        b = (f" bound {k['bound']['bound_ms'] * 1e3:.2f} us "
             f"({k['bound']['bound_by']})" if "bound" in k else "")
        log(f"async flush: {kind:12s} device {k['device_ms'] * 1e3:.1f} us "
            f"per launch ({k['launches_in_3_flushes']} in 3 flushes){b}")
    numbers["flush_kernels"] = {k: v for k, v in kern.items()
                                if k != "all_kernels"}
    numbers["flush_device_kernels"] = kern["all_kernels"]

    bench = async_bench_ordering()
    log(f"async: Synthetic(1,1), slowdown 1.0: virtual s to 0.5 accuracy "
        f"contextual-async {bench['contextual_async_s']} vs fedavg-sync "
        f"{bench['fedavg_sync_s']} (best acc "
        f"{bench['contextual_async_best_acc']:.3f} / "
        f"{bench['fedavg_sync_best_acc']:.3f})")
    numbers["bench_ordering"] = bench
    numbers["host_s"] = time.perf_counter() - t0
    log(f"async: phase host time {numbers['host_s']:.1f} s")
    return {"counts": total, **numbers}


# ---------------------------------------------------------------- streamed

def _round_ms(tracker, name: str = "round") -> list:
    from repro_torch.obs.spans import span_fields
    return [span_fields(e)["dur_wall_s"] * 1e3 for e in tracker.span_events()
            if span_fields(e)["name"] == name]


def streamed_phase(ds, params) -> dict:
    """The two-tier paper-logreg runs on the streamed engine beside the
    fused engine, on the same mini-batches; returns the streamed runs'
    launch counts, summed."""
    import numpy as np
    import torch
    from repro_torch.compress import CompressConfig
    from repro_torch.edge import bimodal_fleet
    from repro_torch.fl import run_hier_simulation
    from repro_torch.hier import HierConfig, two_tier_topology
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import _build, combine, stream
    from repro_torch.models.logistic import logistic_apply, logistic_loss
    from repro_torch.obs import InMemoryTracker, use_tracker

    # each combine call's _vec_eligible verdict, by (leaf width, verdict)
    verdicts = {}
    eligible = combine._vec_eligible

    def recording(w, U, out=None):
        v = eligible(w, U, out)
        verdicts[(U.shape[1], v)] = verdicts.get((U.shape[1], v), 0) + 1
        return v

    fleet = bimodal_fleet(ds.num_devices, slowdown=10.0, dropout_slow=0.05,
                          seed=0)
    tiers = two_tier_topology(fleet, 4)
    sketch = dict(aggregator="hier_contextual_sketch", **HIER_CFG)
    runs = [
        ("two_tier", HierConfig(**HIER_CFG), ()),
        ("topk", HierConfig(compress=CompressConfig(
            scheme="topk", ratio=3.4, u_frac=0.75), **sketch), ("topk",)),
        ("sign_sketch", HierConfig(compress=CompressConfig(
            scheme="sign_sketch", ratio=4.0), **sketch),
         ("sign_sketch", "sign_sketch_adjoint")),
    ]
    log(f"streamed: two tiers of 4 gateways over {ds.num_devices} devices, "
        f"{HIER_ROUNDS} rounds per run, streamed and fused engines on the "
        "same mini-batches")
    total = {}
    for name, cfg, compress_ops in runs:
        res, ms = {}, {}
        for engine in ("fused", "streamed"):
            batches = torch.Generator(device="cuda")
            batches.manual_seed(42)
            snaps = []
            tracker = InMemoryTracker()
            torch.cuda.synchronize()
            reset_launch_counts()
            stream.reset_body_launches()
            combine_before = combine.body_launches()
            verdicts.clear()
            combine._vec_eligible = recording
            try:
                with use_tracker(tracker):
                    r = run_hier_simulation(
                        f"{name}_{engine}", logistic_loss, logistic_apply,
                        params, ds, cfg, tiers, HIER_ROUNDS,
                        selection_seed=42, device="cuda", engine=engine,
                        batch_generator=batches,
                        publish_fn=lambda t, p: snaps.append(launch_counts()))
            finally:
                combine._vec_eligible = eligible
            torch.cuda.synchronize()
            counts = launch_counts()
            res[engine], ms[engine] = r, _round_ms(tracker)
            need(r.engine["engine_name"] == engine,
                 f"streamed {name}: ran on {r.engine['engine_name']}")
            need(np.isfinite(r.train_loss).all()
                 and r.train_loss[-1] < r.train_loss[0],
                 f"streamed {name} ({engine}): losses {r.train_loss}")
            plain = {k: v for k, v in counts.items()
                     if k.endswith("/torch") and v}
            need(not plain, f"streamed {name} ({engine}): plain versions ran "
                 f"on the path: {plain}")
            if engine == "streamed":
                # the paper path's P = 100 f32 slabs keep cross.cuh's body
                bodies = stream.body_launches()
                need(bodies == {"mma": 0,
                                "cross": counts["stream_stats/cuda"]},
                     f"streamed {name}: stream_stats bodies {bodies}")
                # combine: each call on the body _vec_eligible gave it; the
                # uncompressed run's apply takes vec for the 100 x 7 840
                # weight slab and scalar for the 40-byte bias rows
                cb = _tally_since(combine_before, combine.body_launches())
                want = {"vec": sum(c for (_, v), c in verdicts.items() if v),
                        "scalar": sum(c for (_, v), c in verdicts.items()
                                      if not v)}
                by_width = {f"{nw} {'vec' if v else 'scalar'}": c
                            for (nw, v), c in sorted(verdicts.items())}
                wk, blocks, chunks = combine.vec_plan(
                    100, 7840, False, False, 0)
                log(f"streamed {name}: combine bodies {cb}; _vec_eligible by "
                    f"leaf width {by_width}; the 100 x 7 840 f32 slab splits "
                    f"W_k = {wk} ({blocks} blocks of "
                    f"{combine.VEC_WARPS // wk} column groups, "
                    f"{_build.sm_count(0)} SMs)")
                need(cb == want and sum(cb.values()) == counts["combine/cuda"],
                     f"streamed {name}: combine bodies {cb}, eligibility "
                     f"{by_width}, {counts['combine/cuda']} launches")
                need(name != "two_tier" or (
                    cb["vec"] == counts["combine/cuda"] // 2
                    == verdicts.get((7840, True), 0)),
                     f"streamed {name}: the apply's weight slab took "
                     f"{by_width}")
                need(len(snaps) == HIER_ROUNDS - r.rounds_skipped,
                     f"streamed {name}: {len(snaps)} rounds published")
                prev = {k: 0 for k in counts}
                for t, snap in enumerate(snaps):
                    for op in ("stream_stats", "combine") + compress_ops:
                        need(snap[f"{op}/cuda"] > prev[f"{op}/cuda"],
                             f"streamed {name}: round {t} launched no "
                             f"{op}/cuda")
                    prev = snap
                for key, v in counts.items():
                    total[key] = total.get(key, 0) + v
            log(f"streamed {name:11s} {engine:8s} loss {r.train_loss[0]:.6f} "
                f"-> {r.train_loss[-1]:.6f}  cloud uplink "
                f"{r.cloud_uplink_bytes:.0f} B  round ms median "
                f"{statistics.median(ms[engine]):.2f} (first "
                f"{ms[engine][0]:.2f}, all {[round(x, 2) for x in ms[engine]]})"
                f"  launches { {k: v for k, v in counts.items() if v} }")
        gap = abs(res["streamed"].train_loss[-1] - res["fused"].train_loss[-1])
        log(f"streamed {name}: |loss streamed - fused| after {HIER_ROUNDS} "
            f"rounds {gap:.3e} (tolerance {STREAMED_LOSS_GAP}); peak round "
            f"bytes streamed {res['streamed'].engine['round_matrix_peak_bytes']:.0f}"
            f" vs fused {res['fused'].engine['round_matrix_peak_bytes']:.0f}")
        need(gap <= STREAMED_LOSS_GAP, f"streamed {name}: loss gap {gap:.3e}")
        need(res["streamed"].cloud_uplink_bytes
             == res["fused"].cloud_uplink_bytes,
             f"streamed {name}: cloud uplink "
             f"{res['streamed'].cloud_uplink_bytes} vs fused "
             f"{res['fused'].cloud_uplink_bytes}")
    rel = hier_round_vs_cpu(ds, params, tiers, runs[0][1], engine="streamed")
    log(f"streamed: one two_tier round, card vs CPU, max rel err of new "
        f"params {rel:.3e} (tolerance 1e-4)")
    need(rel <= 1e-4, f"streamed: card round disagrees with the CPU round: "
         f"{rel:.3e}")
    return total


# ------------------------------------------------------------------ robust

def _robust_bench() -> dict:
    """``BENCH_robust.json``'s acceptance at its own sizes on the card: the
    clean and attacked runs of contextual_mom (clip 2, mom), contextual and
    FedAvg on the port's own draws; returns the inflations."""
    import numpy as np
    from repro_torch.data import FederatedDataset, make_synthetic
    from repro_torch.edge import uniform_fleet
    from repro_torch.fl import ServerConfig, run_simulation
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.logistic import (init_logistic, logistic_apply,
                                             logistic_loss)
    from repro_torch.robust import (ByzantineGauss, RobustConfig,
                                    assign_adversaries)
    recorded = json.loads((ROOT / "BENCH_robust.json").read_text())[
        "acceptance"]
    xs, ys = make_synthetic(1.0, 1.0, num_devices=64, samples_per_device=30,
                            dim=20, seed=5)
    ds = FederatedDataset(xs, ys, np.ones(ys.shape, np.float32),
                          xs.reshape(-1, 20)[:400], ys.reshape(-1)[:400], 10)
    params = init_logistic(ArchConfig(name="lr", family="logreg",
                                      input_dim=20, num_classes=10), 0,
                           device="cuda")
    fleet = assign_adversaries(uniform_fleet(64), ROBUST_FRAC,
                               seed=ROBUST_ADV_SEED)
    attack = ByzantineGauss(scale=ROBUST_SCALE)
    robust = {"contextual_mom": RobustConfig(clip=2.0, pool="mom")}
    out = {}
    for agg, key, bound, side in ROBUST_ACCEPT:
        loss = {}
        for tag, atk in (("clean", None), ("attacked", attack)):
            cfg = ServerConfig(aggregator=agg, attack=atk,
                               malicious=fleet.malicious if atk else (),
                               robust=robust.get(agg), **ROBUST_BENCH)
            loss[tag] = run_simulation(
                f"{agg}-{tag}", logistic_loss, logistic_apply, params, ds,
                cfg, num_rounds=ROBUST_BENCH_ROUNDS, selection_seed=42,
                eval_every=ROBUST_BENCH_ROUNDS, device="cuda").train_loss[-1]
        infl = loss["attacked"] / loss["clean"]
        ok = infl <= bound if side == "max" else infl >= bound
        log(f"robust bench {agg:15s} clean {loss['clean']:.6f} attacked "
            f"{loss['attacked']:.6f} inflation {infl:.4f} (gate "
            f"{'<=' if side == 'max' else '>='} {bound}; recorded "
            f"{recorded[key]:.4f} on the reference's draws)")
        need(ok and np.isfinite(infl),
             f"robust bench {agg}: inflation {infl:.4f}, gate {side} {bound}")
        out[agg] = {"clean": loss["clean"], "attacked": loss["attacked"],
                    "inflation": infl, "recorded": recorded[key]}
    return out


def _cpu_noise(t, deltas, grads):
    """The adversary's draws from a CPU generator keyed by the round: the
    same noise for a card round and its CPU twin."""
    import torch
    from repro_torch.robust import generator_noise
    gen = torch.Generator()
    gen.manual_seed(1000 + t)
    return generator_noise(gen)(deltas, grads)


def robust_phase(ds, params) -> dict:
    """The robust subsystem on the card: BENCH_robust.json's acceptance,
    then the robust path at paper-logreg width under ByzantineGauss(25)
    (and a churn wave on the hier runs); returns the runs' launch counts,
    summed, and the phase's numbers."""
    import numpy as np
    import torch
    from repro_torch.edge import bimodal_fleet
    from repro_torch.fl import (ServerConfig, run_hier_simulation,
                                run_simulation)
    from repro_torch.hier import HierConfig, star_topology, two_tier_topology
    from repro_torch.kernels import gram, launch_counts, reset_launch_counts
    from repro_torch.models.logistic import logistic_apply, logistic_loss
    from repro_torch.obs import InMemoryTracker, use_tracker
    from repro_torch.robust import (ByzantineGauss, RobustConfig,
                                    assign_adversaries, churn_schedule)

    t0 = time.perf_counter()
    bench = _robust_bench()
    bench_s = time.perf_counter() - t0
    fleet = assign_adversaries(
        bimodal_fleet(ds.num_devices, slowdown=10.0, dropout_slow=0.05,
                      seed=0), ROBUST_FRAC, seed=ROBUST_ADV_SEED)
    attack = ByzantineGauss(scale=ROBUST_SCALE)
    robust = RobustConfig(clip=2.0, pool="mom")
    log(f"robust: {ds.num_devices} devices (bimodal, slowdown 10, "
        f"dropout_slow 0.05), {len(fleet.malicious)} malicious "
        f"{fleet.malicious}, {attack.name} at {attack.scale:g}x")
    total, numbers = {}, {"bench": bench, "bench_s": bench_s, "runs": {}}

    def counted(name, run, fused_rounds=False, streamed=False):
        """Run one card run; gate its launches; add them to the total."""
        snaps = []
        tracker = InMemoryTracker()
        torch.cuda.synchronize()
        reset_launch_counts()
        before = gram.block_body_launches()
        with use_tracker(tracker):
            res = run(lambda t, p: snaps.append(launch_counts()))
        torch.cuda.synchronize()
        counts = launch_counts()
        bodies = _tally_since(before, gram.block_body_launches())
        plain = {k: v for k, v in counts.items() if k.endswith("/torch") and v}
        need(not plain, f"robust {name}: plain versions ran: {plain}")
        need(np.isfinite(res.train_loss).all(),
             f"robust {name}: non-finite losses {res.train_loss}")
        need(bodies["mma"] == 0
             and bodies["cross"] == counts["gram_block/cuda"],
             f"robust {name}: gram_block bodies {bodies}, "
             f"{counts['gram_block/cuda']} launches")
        prev = {k: 0 for k in counts}
        ops = (("gram", "gram_block") if fused_rounds else
               ("stream_stats", "combine") if streamed else ())
        for t, snap in enumerate(snaps):
            for op in ops:
                need(snap[f"{op}/cuda"] > prev[f"{op}/cuda"],
                     f"robust {name}: round {t} launched no {op}/cuda")
            prev = snap
        if streamed:
            need(counts["gram_block/cuda"] == 0,
                 f"robust {name}: the streamed engine launched gram_block")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        ms = _round_ms(tracker)
        launched = {k: v for k, v in counts.items() if v}
        log(f"robust {name:28s} loss {res.train_loss[0]:.6f} -> "
            f"{res.train_loss[-1]:.6f}  dropped {getattr(res, 'dropped', '-')}"
            f"  round ms median {statistics.median(ms):.2f} (first "
            f"{ms[0]:.2f})  launches {launched}  gram_block bodies {bodies}")
        numbers["runs"][name] = {"loss": res.train_loss, "round_ms": ms,
                                 "launches": launched,
                                 "gram_block_bodies": bodies}
        return res

    # the flat contextual_mom path: G from gram, C = U Gmᵀ from gram_block
    flat_cfg = ServerConfig(aggregator="contextual_mom", attack=attack,
                            malicious=fleet.malicious, robust=robust,
                            **PATH_CFG)
    counted("flat contextual_mom", lambda pub: run_simulation(
        "robust_flat", logistic_loss, logistic_apply, params, ds, flat_cfg,
        num_rounds=ROBUST_PATH_ROUNDS, selection_seed=42, device="cuda"))
    flat = numbers["runs"]["flat contextual_mom"]["launches"]
    need(flat["gram_block/cuda"] == ROBUST_PATH_ROUNDS
         and flat["gram/cuda"] == ROBUST_PATH_ROUNDS
         and flat["combine/cuda"] >= ROBUST_PATH_ROUNDS,
         f"robust flat: launches {flat} in {ROBUST_PATH_ROUNDS} rounds")

    hcfg = HierConfig(robust=robust, **HIER_CFG)
    for topo_name, topo in (("two_tier", two_tier_topology(fleet, 4)),
                            ("star", star_topology(fleet))):
        clean = counted(f"{topo_name} clean fused", lambda pub: (
            run_hier_simulation(
                f"robust_{topo_name}_clean", logistic_loss, logistic_apply,
                params, ds, hcfg, topo, HIER_ROUNDS, selection_seed=42,
                device="cuda", engine="fused", publish_fn=pub)),
            fused_rounds=True)
        churn = churn_schedule("wave", ds.num_devices, clean.times[-1],
                               seed=1)
        runs = {}
        for engine in ("fused", "streamed"):
            for rep in range(2 if topo_name == "two_tier" else 1):
                def run(pub, engine=engine):
                    batches = torch.Generator(device="cuda")
                    batches.manual_seed(42)
                    return run_hier_simulation(
                        f"robust_{topo_name}_{engine}", logistic_loss,
                        logistic_apply, params, ds, hcfg, topo, HIER_ROUNDS,
                        selection_seed=42, device="cuda", engine=engine,
                        batch_generator=batches, attack=attack, churn=churn,
                        publish_fn=pub)
                res = counted(f"{topo_name} {engine} attacked #{rep + 1}",
                              run, fused_rounds=engine == "fused",
                              streamed=engine == "streamed")
                need(res.engine["engine_name"] == engine,
                     f"robust {topo_name}: ran on {res.engine['engine_name']}")
                need(res.dropped > clean.dropped,
                     f"robust {topo_name} {engine}: dropped {res.dropped}, "
                     f"clean {clean.dropped}: the churn wave took nothing")
                runs.setdefault(engine, []).append(res)
        rf, rs = runs["fused"][0], runs["streamed"][0]
        gap = float(np.max(np.abs(np.asarray(rf.train_loss)
                                  - np.asarray(rs.train_loss))))
        log(f"robust {topo_name}: fused vs streamed event times "
            f"{'equal' if rf.times == rs.times else 'DIFFER'}, max |loss gap| "
            f"{gap:.3e} (rtol = atol = {ROBUST_ENGINE_TOL})")
        need(rf.times == rs.times, f"robust {topo_name}: fused times "
             f"{rf.times} vs streamed {rs.times}")
        need(np.allclose(rf.train_loss, rs.train_loss, rtol=ROBUST_ENGINE_TOL,
                         atol=ROBUST_ENGINE_TOL),
             f"robust {topo_name}: fused losses {rf.train_loss} vs streamed "
             f"{rs.train_loss}")
        for engine, pair in runs.items():
            if len(pair) == 2:
                a, b = pair
                same = (a.times == b.times and a.train_loss == b.train_loss
                        and (a.dispatched, a.arrived, a.dropped)
                        == (b.dispatched, b.arrived, b.dropped))
                log(f"robust {topo_name} {engine}: two card runs bitwise "
                    f"{'equal' if same else 'DIFFERENT'}")
                need(same, f"robust {topo_name} {engine}: two runs differ")
        numbers["runs"][f"{topo_name} gap"] = gap
    for topo_name, topo, engine in (("two_tier", two_tier_topology(fleet, 4),
                                     "fused"),
                                    ("star", star_topology(fleet),
                                     "streamed")):
        rel = hier_round_vs_cpu(ds, params, topo, hcfg, engine=engine,
                                attack=attack, attack_noise=_cpu_noise)
        log(f"robust: one {topo_name} {engine} attacked round, card vs CPU, "
            f"max rel err of new params {rel:.3e} (tolerance 1e-4)")
        need(rel <= 1e-4, f"robust {topo_name} {engine}: card round "
             f"disagrees with the CPU round: {rel:.3e}")
        numbers[f"{topo_name}_{engine}_vs_cpu"] = rel
    numbers["host_s"] = time.perf_counter() - t0
    log(f"robust: launches by kernel "
        f"{ {k: v for k, v in sorted(total.items()) if v} }; phase host "
        f"seconds {numbers['host_s']:.1f} (acceptance runs {bench_s:.1f})")
    return {"counts": total, "numbers": numbers}


# ---------------------------------------------------------------- bigmodel

def transformer_stacked(gen):
    """benchmarks/bigmodel_round.py's transformer-shaped stacked update and
    gradient trees (leading P axis, bf16, 0.01·N(0, 1)) drawn on the card,
    its f32 zero template, and n."""
    import torch
    d, P = BIG["d_model"], BIG["P"]
    shapes = {"embed": (BIG["vocab"], d)}
    for layer in range(BIG["layers"]):
        for w in ("wq", "wk", "wv", "wo"):
            shapes[f"layer{layer}/{w}"] = (d, d)
        shapes[f"layer{layer}/w_up"] = (d, 4 * d)
        shapes[f"layer{layer}/w_down"] = (4 * d, d)
        shapes[f"layer{layer}/ln"] = (d,)

    def draw(shape):
        return (0.01 * torch.randn((P,) + shape, generator=gen,
                                   device="cuda")).to(torch.bfloat16)

    import numpy as np

    deltas = {k: draw(s) for k, s in shapes.items()}
    grads = {k: draw(s) for k, s in shapes.items()}
    template = {k: torch.zeros(s, device="cuda") for k, s in shapes.items()}
    n = sum(int(np.prod(s)) for s in shapes.values())
    return deltas, grads, template, n


def _big_round(eng, template, deltas, grads):
    """One tier-tree round through the context API, as the reference's
    ``_round_once``: gateway solves, the cloud's γ stage, the apply."""
    P, gws = BIG["P"], BIG["gateways"]
    per = P // gws
    cohorts = [list(range(g * per, (g + 1) * per)) for g in range(gws)]
    ctx = eng.begin_round(deltas, grads)
    sums = [ctx.gateway(c) for c in cohorts]
    counts = [float(len(c)) for c in cohorts]
    ghat = ctx.compose_grads([s["ghat"] for s in sums], counts)
    delta, info = ctx.cloud_combo([s["u_bar"] for s in sums], counts, ghat)
    return ctx, delta, ctx.apply(template, delta)


def bigmodel_phase() -> dict:
    """The streamed engine at transformer width; returns its launch
    counts."""
    import torch
    from repro_torch.core.solve import SolveConfig
    from repro_torch.hier import HierRoundEngine
    from repro_torch.hier.streamed import StreamedRoundEngine, dense_round_bytes
    from repro_torch.kernels import (combine, force_backend, launch_counts,
                                     reset_launch_counts, stream)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    deltas, grads, template, n = transformer_stacked(gen)
    P = BIG["P"]
    cfg = SolveConfig(beta=5.0, ridge=1e-6)
    seng = StreamedRoundEngine(template, cfg, "contextual", chunk=BIG["chunk"])
    peak, dense = seng.peak_round_bytes(P), dense_round_bytes(P, n)
    log(f"bigmodel: transformer_stream d_model {BIG['d_model']}, vocab "
        f"{BIG['vocab']}, {BIG['layers']} layers, P={P} bf16, n={n}, "
        f"{len(deltas)} leaves; peak round bytes {peak:.0f} vs dense "
        f"{dense:.0f} ({dense / peak:.1f}x)")
    need(n == BIG_N, f"bigmodel: n={n}")
    need(peak == BIG_PEAK_BYTES and dense == BIG_DENSE_BYTES,
         f"bigmodel: peak {peak} / dense {dense} differ from the reference")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    stream.reset_body_launches()
    ctx = seng.begin_round(deltas, grads)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    need(launch_counts()["stream_stats/cuda"] == len(deltas),
         f"bigmodel: begin_round launched {launch_counts()}")
    # every slab of the accumulate pass takes the tensor-core body
    bodies = stream.body_launches()
    need(bodies == {"mma": len(deltas), "cross": 0},
         f"bigmodel: begin_round's stream_stats bodies {bodies}")
    log(f"bigmodel: begin_round raised allocated memory by {rise} B "
        f"(limit {BIG_MEMORY_RISE}; one f32 (P, n) copy: {P * n * 4} B)")
    need(rise < BIG_MEMORY_RISE, f"bigmodel: begin_round raised memory by "
         f"{rise} B")

    # the accumulate pass alone, beside its bound (the bytes of D and GM)
    acc_ms = time_ms(lambda: seng.begin_round(deltas, grads), 10, warmup=2)
    acc_bound = cross_bound(2 * P, n, P * (P + 1) // 2 + P * P, 2 * P * P,
                            torch.bfloat16)
    # the same pass through the plain version, and through one torch.matmul
    # pair per slab summed in f32 (the library yardstick; bf16 products on
    # the tensor cores)
    with force_backend("torch", op="stream_stats"):
        acc_plain_ms = time_ms(lambda: seng.begin_round(deltas, grads), 5,
                               warmup=1)
    slabs = [(deltas[k].reshape(P, -1), grads[k].reshape(P, -1))
             for k in sorted(deltas)]

    def library_pass():
        G = torch.zeros((P, P), device="cuda")
        C = torch.zeros((P, P), device="cuda")
        for D, GM in slabs:
            G += D @ D.T
            C += D @ GM.T
        return G, C
    acc_library_ms = time_ms(library_pass, 5, warmup=1)
    # whole rounds: host clock around a round that ends in a sync
    reset_launch_counts()
    stream.reset_body_launches()
    combine_before = combine.body_launches()
    round_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sctx, sdelta, _ = _big_round(seng, template, deltas, grads)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    need(counts["stream_stats/cuda"] == 4 * len(deltas)
         and counts["combine/cuda"] == 4 * len(deltas),
         f"bigmodel: 4 rounds launched {counts}")
    need(stream.body_launches() == {"mma": 4 * len(deltas), "cross": 0},
         f"bigmodel: 4 rounds' stream_stats bodies {stream.body_launches()}")
    # every slab's apply has 16-byte rows: all on combine_vec.cu
    combine_bodies = _tally_since(combine_before, combine.body_launches())
    need(combine_bodies == {"vec": 4 * len(deltas), "scalar": 0},
         f"bigmodel: 4 rounds' combine bodies {combine_bodies}")
    plain = {k: v for k, v in counts.items() if k.endswith("/torch") and v}
    need(not plain, f"bigmodel: plain versions ran on the path: {plain}")
    log(f"bigmodel: round ms {[round(x, 2) for x in round_ms]} (median of the "
        f"last 3 {statistics.median(round_ms[1:]):.2f}); accumulate pass "
        f"({len(deltas)} stream_stats launches) {acc_ms * 1e3:.1f} us against "
        f"a bound of {acc_bound['bound_ms'] * 1e3:.1f} us "
        f"({acc_bound['bound_by']}); plain {acc_plain_ms * 1e3:.1f} us, "
        f"library (torch.matmul per slab) {acc_library_ms * 1e3:.1f} us")

    # where a round's time goes: the P-space stages (host clock, ending in a
    # sync) and the apply (CUDA events) beside the accumulate pass above
    P_gw = P // BIG["gateways"]
    cohorts = [list(range(g * P_gw, (g + 1) * P_gw))
               for g in range(BIG["gateways"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = [sctx.gateway(c) for c in cohorts]
    counts_g = [float(len(c)) for c in cohorts]
    ghat = sctx.compose_grads([x["ghat"] for x in sums], counts_g)
    sctx.cloud_combo([x["u_bar"] for x in sums], counts_g, ghat)
    torch.cuda.synchronize()
    stages_ms = (time.perf_counter() - t0) * 1e3
    apply_ms = time_ms(lambda: sctx.apply(template, sdelta), 5, warmup=1)
    apply_bound = (2 * P * n + 2 * 4 * n) / HBM_BYTES_PER_S * 1e3
    # the apply's device kernels over three calls (each kernel's launches
    # seen, and its mean device time a launch), and the host time to issue
    # one apply: where the host takes as long, the apply is host-paced
    apply_kernels = device_kernel_means(lambda: sctx.apply(template, sdelta))
    apply_device_ms = sum(c * ms for c, ms in apply_kernels.values()) / 3
    apply_host_ms = host_ms(lambda: sctx.apply(template, sdelta), 5)
    apply_launches = {}
    for k, (c, _) in apply_kernels.items():
        short = k.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0].split("<")[0]
        apply_launches[short] = apply_launches.get(short, 0) + c
    log(f"bigmodel: round parts — P-space stages {stages_ms:.2f} ms (host "
        f"clock), apply ({len(deltas)} combine launches) "
        f"{apply_ms * 1e3:.1f} us against a bound of {apply_bound * 1e3:.1f} "
        "us (bytes: the bf16 deltas read, the f32 parameters read and "
        f"written); {apply_device_ms * 1e3:.1f} us a call on the device, "
        f"{apply_host_ms * 1e3:.1f} us of host time to issue one; the "
        f"apply's device kernels seen in three calls {apply_launches}")

    with force_backend("torch", op="stream_stats"):
        ref_ctx = seng.begin_round(deltas, grads)
    err_g = _max_err(ctx.G, ref_ctx.G) / float(ref_ctx.G.abs().max())
    err_c = _max_err(ctx.C, ref_ctx.C) / float(ref_ctx.C.abs().max())
    log(f"bigmodel: G and C against the plain version: max |err| / max |plain|"
        f" {err_g:.3e} and {err_c:.3e} (tolerance {CROSS_TOL})")
    need(max(err_g, err_c) <= CROSS_TOL, f"bigmodel: G/C err {err_g:.3e}, "
         f"{err_c:.3e}")
    # both against the same statistics in f64, slab by slab
    G64 = torch.zeros((P, P), dtype=torch.float64, device="cuda")
    C64 = torch.zeros_like(G64)
    for k in sorted(deltas):
        d64 = deltas[k].reshape(P, -1).double()
        G64 += d64 @ d64.T
        C64 += d64 @ grads[k].reshape(P, -1).double().T
        del d64
    f64_errs = {}
    for who, c in (("kernel", ctx), ("plain", ref_ctx)):
        f64_errs[who] = (
            float((c.G.double() - G64).abs().max() / G64.abs().max()),
            float((c.C.double() - C64).abs().max() / C64.abs().max()))
    log(f"bigmodel: G and C against an f64 product: kernel "
        f"{f64_errs['kernel'][0]:.3e} and {f64_errs['kernel'][1]:.3e}, plain "
        f"{f64_errs['plain'][0]:.3e} and {f64_errs['plain'][1]:.3e} "
        f"(tolerance {CROSS_TOL})")
    need(max(f64_errs["kernel"]) <= CROSS_TOL,
         f"bigmodel: G/C off f64 by {f64_errs['kernel']}")
    del ref_ctx, G64, C64

    svec = sctx.materialize(sdelta)
    feng = HierRoundEngine(template, cfg, "contextual")
    _, fdelta, _ = _big_round(feng, template, deltas, grads)
    torch.cuda.synchronize()
    derr = _max_err(svec, fdelta) / float(fdelta.abs().max())
    log(f"bigmodel: streamed round delta against the fused engine's: max "
        f"|err| / max |fused| {derr:.3e} (tolerance {BIG_DELTA_TOL})")
    need(derr <= BIG_DELTA_TOL, f"bigmodel: delta err {derr:.3e}")
    return {"counts": counts, "round_ms": round_ms, "accumulate_ms": acc_ms,
            "accumulate_bound": acc_bound,
            "accumulate_plain_ms": acc_plain_ms,
            "accumulate_library_ms": acc_library_ms, "stages_ms": stages_ms,
            "apply_ms": apply_ms, "apply_bound_ms": apply_bound,
            "apply_device_ms": apply_device_ms,
            "apply_host_ms": apply_host_ms,
            "apply_launches_in_3_calls": apply_launches,
            "combine_bodies": combine_bodies,
            "memory_rise_bytes": rise,
            "G_rel_err": err_g, "C_rel_err": err_c, "delta_rel_err": derr,
            "G_C_f64_rel_err": f64_errs["kernel"],
            "plain_G_C_f64_rel_err": f64_errs["plain"],
            "accumulate_body": "mma"}


# ------------------------------------------------------------------- serve

def _event_ms(fn, reps: int, warmup: int = 2) -> list:
    """CUDA-event ms of each of ``reps`` calls of ``fn`` (after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _device_us(e) -> float:
    """A profiler average's own device time (the attribute's name differs
    between torch versions)."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_busy(fn, steps: int) -> dict:
    """Device time per call of ``fn`` from a ``torch.profiler`` trace: the
    sum of the kernels' own device time, and the largest kernels by name.
    None when the trace holds no device time."""
    rows = [(e.key[:60], _device_us(e) / 1e3 / steps, e.count / steps)
            for e in _device_rows(fn, steps)]
    total = sum(r[1] for r in rows)
    if total <= 0:
        return None
    rows.sort(key=lambda r: -r[1])
    return {"busy_ms": total,
            "top": [(k, (ms, n)) for k, ms, n in rows[:8]]}


def _flash_decode_f64(q, k, v, lengths, *, window=None, softcap=None,
                      backend=None):
    """The plain flash_decode's arithmetic in f64, cast back to f32 — a
    second correct attention for the serve phase's logit floor."""
    import torch
    S, hd = k.shape[1], k.shape[3]
    s = torch.einsum("bkgd,bskd->bkgs", q.double() * hd ** -0.5, k.double())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(S, device=k.device)[None, None, None, :]
    length = lengths.to(torch.int64)[:, None, None, None]
    ok = kpos < length
    if window is not None:
        ok = ok & (kpos > length - 1 - window)
    s = s.masked_fill(~ok, float("-inf"))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", torch.exp(s - lse), v.double())
    return o.float(), lse.float()


def _flash_decode_sdpa(q, k, v, lengths, *, window=None, softcap=None,
                       backend=None):
    """``scaled_dot_product_attention`` in f32 with a boolean length/window
    mask: a yardstick for the logit floor only, never on the port's path
    (o only: the decode step drops lse)."""
    import torch
    import torch.nn.functional as F
    need(softcap is None, "serve: the SDPA yardstick has no softcap")
    B, KV, G, hd = q.shape
    S = k.shape[1]
    kpos = torch.arange(S, device=k.device)[None, :]
    length = lengths.to(torch.int64)[:, None]
    ok = kpos < length
    if window is not None:
        ok = ok & (kpos > length - 1 - window)
    o = F.scaled_dot_product_attention(
        q.float().reshape(B, KV * G, 1, hd), k.float().transpose(1, 2),
        v.float().transpose(1, 2), attn_mask=ok[:, None, None, :],
        enable_gqa=True)
    return o.reshape(B, KV, G, hd), None


@contextlib.contextmanager
def _attention(fn):
    """Route the model's ``flash_decode`` calls to ``fn`` inside the block
    (the decode step looks the op up on ``kernels.ops`` at each call)."""
    from repro_torch.kernels import ops
    saved, ops.flash_decode = ops.flash_decode, fn
    try:
        yield
    finally:
        ops.flash_decode = saved


def _decode_logits(cfg, params, device, cache=None,
                   variants=("kernel", "plain")) -> dict:
    """The logits of one decode step (4 slots at depths 200-230, all
    active), once per attention in ``variants``, each from the same cache:
    ``kernel`` (the port's path), ``plain`` (the plain flash_decode in f32),
    ``f64`` (its arithmetic in f64) and ``sdpa`` (the SDPA yardstick)."""
    import torch
    from repro_torch.kernels import force_backend
    from repro_torch.models import transformer as ttf
    if cache is None:
        cache = ttf.init_lm_cache(cfg, SERVE["slots"], SERVE["max_seq"],
                                  ring=False, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(3)
        for t in cache.kv:
            t.copy_(torch.randn(t.shape, generator=gen, device=device))
    pos = torch.tensor([200, 210, 220, 230], dtype=torch.int32, device=device)
    tok = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=device)
    active = torch.ones(SERVE["slots"], dtype=torch.bool, device=device)
    routes = {"kernel": contextlib.nullcontext,
              "plain": lambda: force_backend("torch", "flash_decode"),
              "f64": lambda: _attention(_flash_decode_f64),
              "sdpa": lambda: _attention(_flash_decode_sdpa)}
    saved = [t.clone() for t in cache.kv]
    out = {}
    for name in variants:
        for t, s in zip(cache.kv, saved):
            t.copy_(s)
        with routes[name]():
            out[name], _ = ttf.decode_slots(cfg, params, tok, cache, pos,
                                            active=active)
    return out


def _logit_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return _max_err(a, b) / float(b.float().abs().max())


def _serve_requests(vocab: int, seed: int = 1) -> list:
    """examples/serve_decode.py's traffic: prompts of SERVE["prompt"] tokens,
    every other request generating the long budget, the rest the short."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i in range(SERVE["requests"]):
        plen = int(rng.integers(SERVE["prompt"][0], SERVE["prompt"][1] + 1))
        out.append(([int(t) for t in rng.integers(0, vocab, plen)],
                    SERVE["new"][i % 2]))
    return out


def _engine(cfg, params, device, **kw):
    from repro_torch.serve import DecodeEngine, ModelBus
    opts = dict(num_slots=SERVE["slots"], max_seq=SERVE["max_seq"],
                scan_chunk=SERVE["scan_chunk"],
                prefill_chunk_tokens=SERVE["prefill_chunk"])
    opts.update(kw)
    return DecodeEngine(cfg, ModelBus(params), device=device, **opts)


def _staggered(eng, reqs) -> dict:
    """The first request resident before the rest are submitted."""
    eng.submit(reqs[0][0], reqs[0][1], rid=0)
    done = eng.step()
    for rid, (prompt, new) in enumerate(reqs[1:], start=1):
        eng.submit(prompt, new, rid=rid)
    return {c.rid: c.tokens for c in done + eng.run()}


def _tally_since(before: dict, now: dict) -> dict:
    """A launch tally by body over a stretch of a phase (the phase's own
    tally, read by ``main``, runs on across it)."""
    return {key: now[key] - before[key] for key in now}


def _dense_param_count(cfg) -> int:
    """Parameters of a dense config: the analytic estimate plus the norm
    scales it leaves out (ln1, ln2, qk-norm per layer; final norm)."""
    qk = 2 * cfg.resolved_head_dim if cfg.qk_norm else 0
    return (cfg.param_count_estimate()
            + cfg.num_layers * (2 * cfg.d_model + qk) + cfg.d_model)


def serve_phase(device: str = "cuda", cfg=None) -> dict:
    """The continuous-batching engine on the full qwen3-14b, bf16 (``cfg``
    and ``device`` other than the defaults only to rehearse the phase's
    control flow at a small size)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves, tree_map
    from repro_torch.kernels import (decode_attn, launch_counts,
                                     reset_launch_counts)
    from repro_torch.models import get_model
    from repro_torch.models import transformer as ttf
    from repro_torch.obs import InMemoryTracker, use_tracker
    cfg = cfg or get_config(SERVE["arch"])
    L = cfg.num_layers
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = get_model(cfg).init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in tree_leaves(params))
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in tree_leaves(params))
    step_bytes = weight_bytes - params["embed"].numel() * 2
    step_bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"serve: {cfg.name} L={L} d={cfg.d_model} heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} hd={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} bf16: {n} parameters, {weight_bytes} B, "
        f"init {init_s:.1f} s; weights read per decode step {step_bytes} B "
        f"-> bound {step_bound_ms:.3f} ms")
    need(n == _dense_param_count(cfg), f"serve: {n} parameters")

    # the main path: 8 requests, one mid-flight publish of a tree that
    # shares every leaf but final_norm
    reqs = _serve_requests(cfg.vocab_size)
    eng = _engine(cfg, params, device)
    for rid, (prompt, new) in enumerate(reqs):
        eng.submit(prompt, new, rid=rid)
    tracker = InMemoryTracker()
    done, seen = [], []
    reset_launch_counts()
    before = decode_attn.body_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with use_tracker(tracker):
        done += eng.step()
        seen.append(eng.model_version)
        published = dict(params, final_norm=params["final_norm"] + 0.01)
        eng.bus.publish(published)
        while not eng.idle:
            done += eng.step()
            seen.append(eng.model_version)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    bodies = _tally_since(before, decode_attn.body_launches())
    tokens = sum(len(c.tokens) for c in done)
    steps = int(eng.stats["decode_steps"])
    need(sorted(c.rid for c in done) == list(range(len(reqs)))
         and all(len(c.tokens) == reqs[c.rid][1] for c in done),
         "serve: not every request completed with its budget")
    need(seen == sorted(seen) and eng.model_version == 1
         and eng.stats["swaps"] == 1, f"serve: versions {seen}")
    need(all(0 <= c.admit_version <= c.final_version <= 1 for c in done),
         "serve: completion versions")
    need(counts["flash_decode/cuda"] == L * steps,
         f"serve: flash_decode/cuda {counts['flash_decode/cuda']} launches, "
         f"want L x decode steps = {L * steps}")
    need(bodies == {"mma": L * steps, "cuda_core": 0},
         f"serve: flash_decode bodies {bodies}, want all {L * steps} bf16 "
         "launches on the tensor-core body")
    plain = {k: v for k, v in counts.items() if k.endswith("/torch") and v}
    need(not plain, f"serve: plain versions ran on the path: {plain}")
    chunk_ms = sorted(ms / SERVE["scan_chunk"]
                      for ms in _round_ms(tracker, "serve/decode_chunk"))
    swap_stall = eng.stats["swap_stall_s_max"]
    log(f"serve: {len(done)} requests, {tokens} tokens in {wall:.2f} s = "
        f"{tokens / wall:.1f} tokens/s; {steps} decode steps in "
        f"{int(eng.stats['decode_chunks'])} chunks, "
        f"{int(eng.stats['prefill_chunks'])} prefill chunks; "
        f"median {statistics.median(chunk_ms):.2f} ms per step as served "
        f"(chunk wall / {SERVE['scan_chunk']}, prefill work included); "
        f"swap stall {swap_stall * 1e3:.3f} ms; flash_decode launches "
        f"{counts['flash_decode/cuda']} = {L} x {steps}, bodies {bodies}")

    # one decode step and one prefill chunk alone, timed with CUDA events
    B = SERVE["slots"]
    pos = torch.tensor([200, 210, 220, 230], dtype=torch.int32,
                       device=device)
    tok = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=device)
    active = torch.ones(B, dtype=torch.bool, device=device)
    cache = eng._cache
    step_ms = _event_ms(lambda: ttf.decode_slots(
        cfg, params, tok, cache, pos, active=active), reps=10)
    chunk = torch.tensor(reqs[0][0][:SERVE["prefill_chunk"]],
                         dtype=torch.int32, device=device)
    prefill_ms = _event_ms(lambda: ttf.prefill_chunk(
        cfg, params, chunk, cache, 0, 0), reps=3, warmup=1)
    step_med = statistics.median(step_ms)
    busy = device_busy(lambda: ttf.decode_slots(cfg, params, tok, cache, pos,
                                                active=active), steps=2)
    log(f"serve: decode step B={B} S={SERVE['max_seq']} alone: median "
        f"{step_med:.2f} ms (min {min(step_ms):.2f}) against the "
        f"{step_bound_ms:.3f} ms bound ({step_bound_ms / step_med:.1%}); "
        f"prefill chunk of {SERVE['prefill_chunk']} tokens: median "
        f"{statistics.median(prefill_ms):.2f} ms")

    if busy is None:
        log("serve: device busy time per step: not measured (the profiler "
            "recorded no device time)")
    else:
        log(f"serve: device busy per decode step {busy['busy_ms']:.2f} ms of "
            f"{step_med:.2f} ms ({busy['busy_ms'] / step_med:.1%}; idle "
            f"share {1 - busy['busy_ms'] / step_med:.1%}); by kernel (ms per "
            f"step, launches per step): " + "; ".join(
                f"{k} {v[0]:.3f} ({v[1]:g})" for k, v in busy["top"]))

    # the kernel against the plain flash_decode inside one decode step,
    # beside the floor that two correct attentions show through the bf16
    # model: the plain version in f32 against the same arithmetic in f64,
    # and against SDPA
    lg = _decode_logits(cfg, params, device, cache,
                        ("kernel", "plain", "f64", "sdpa"))
    logit_err = _logit_err(lg["kernel"], lg["plain"])
    floor = {"plain_vs_f64": _logit_err(lg["plain"], lg["f64"]),
             "plain_vs_sdpa": _logit_err(lg["plain"], lg["sdpa"]),
             "kernel_vs_f64": _logit_err(lg["kernel"], lg["f64"])}
    logit_floor = max(floor["plain_vs_f64"], floor["plain_vs_sdpa"])
    log(f"serve: logit floor (one full-width bf16 step, max |dlogit| / max "
        f"|logit|) of two correct attentions {logit_floor:.3e}: plain f32 vs "
        f"f64 {floor['plain_vs_f64']:.3e}, plain vs SDPA "
        f"{floor['plain_vs_sdpa']:.3e}; kernel vs plain {logit_err:.3e}, "
        f"kernel vs f64 {floor['kernel_vs_f64']:.3e} (gate "
        f"{SERVE_LOGIT_TOL:.4g})")
    need(logit_err <= SERVE_LOGIT_TOL, f"serve: decode-step logits with the "
         f"kernel vs plain flash_decode: {logit_err:.3e} of max |logit| > "
         f"{SERVE_LOGIT_TOL}")
    del lg, eng, cache
    torch.cuda.empty_cache()

    # continuous batching equals solo decode at full width
    few = [(p[:60 + 20 * i], 6 + 3 * i) for i, (p, _) in enumerate(reqs[:3])]
    batched = _staggered(_engine(cfg, params, device), few)
    for rid, req in enumerate(few):
        solo = _staggered(_engine(cfg, params, device), [req])
        need(solo[0] == batched[rid], f"serve: rid {rid} batched "
             f"{batched[rid]} != solo {solo[0]}")
    torch.cuda.empty_cache()

    # a reduced f32 qwen3 on the card and on the CPU: the same tokens
    small = get_config(SERVE["arch"]).reduced()
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(0)
    small_cpu = get_model(small).init(cpu_gen)
    small_card = tree_map(lambda a: a.to(device), small_cpu)
    small_reqs = [(p[:20 + 9 * i], 8 + 2 * i)
                  for i, (p, _) in enumerate(_serve_requests(
                      small.vocab_size, seed=2)[:4])]
    kw = dict(max_seq=64, prefill_chunk_tokens=16)
    before = decode_attn.body_launches()
    on_card = _staggered(_engine(small, small_card, device, **kw),
                         small_reqs)
    small_bodies = _tally_since(before, decode_attn.body_launches())
    need(small_bodies["mma"] == 0 and small_bodies["cuda_core"] > 0,
         f"serve: reduced f32 flash_decode bodies {small_bodies}, want the "
         "CUDA-core body only")
    on_cpu = _staggered(_engine(small, small_cpu, "cpu", **kw), small_reqs)
    need(on_card == on_cpu, f"serve: reduced f32 tokens card {on_card} != "
         f"CPU {on_cpu}")
    lg = _decode_logits(small, small_card, device)
    small_err = _logit_err(lg["kernel"], lg["plain"])
    need(small_err <= SERVE_LOGIT_TOL_F32, f"serve: reduced f32 decode-step "
         f"logits kernel vs plain flash_decode {small_err:.3e} > "
         f"{SERVE_LOGIT_TOL_F32}")
    log(f"serve: kernel vs plain flash_decode in one decode step: "
        f"{logit_err:.3e} of max |logit| (tolerance {SERVE_LOGIT_TOL:.4g}); "
        f"reduced f32: {small_err:.3e} (tolerance {SERVE_LOGIT_TOL_F32}); "
        f"3 staggered requests equal solo at full width; reduced f32 "
        f"qwen3 tokens equal on card and CPU ({sum(map(len, on_cpu.values()))}"
        f" tokens; flash_decode bodies {small_bodies})")
    return {"counts": counts, "bodies": bodies,
            "reduced_f32_bodies": small_bodies,
            "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall, "decode_steps": steps,
            "decode_step_ms_alone": step_med,
            "decode_step_ms_alone_all": step_ms,
            "decode_step_ms_as_served_median": statistics.median(chunk_ms),
            "decode_step_bound_ms": step_bound_ms,
            "decode_step_bytes": step_bytes,
            "prefill_chunk_ms": statistics.median(prefill_ms),
            "swap_stall_s": swap_stall, "logit_rel_err_vs_plain": logit_err,
            "logit_floor": logit_floor, "logit_floor_pairs": floor,
            "logit_tolerance": SERVE_LOGIT_TOL,
            "logit_rel_err_vs_plain_reduced_f32": small_err,
            "device_busy": busy, "init_s": init_s}


# -------------------------------------------------------------------- main

def setup_phase() -> str:
    import torch
    from repro_torch.kernels import (_build, cross, gram, rng_sketch, sketch,
                                     topk)
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
    build_s = {}
    for line in _build.ptxas_log().splitlines():
        if ("Compiling entry function" in line or "registers" in line
                or line.startswith("==") or ("spill" in line and not line
                                             .strip().startswith("0 bytes"))):
            log("ptxas: " + line.strip())
        if line.startswith("== "):           # "== name.cu (seconds s)"
            name, secs = line[3:].split(" (")
            build_s[name] = float(secs.split()[0])
    log("build: nvcc seconds, combine_vec.cu (16 instances) "
        f"{build_s['combine_vec.cu']:.2f} beside combine.cu (4) "
        f"{build_s['combine.cu']:.2f}, decode_attn_mma.cu (2 instances) "
        f"{build_s['decode_attn_mma.cu']:.2f} beside decode_attn.cu (32) "
        f"{build_s['decode_attn.cu']:.2f}, sketch_mma.cu (8) "
        f"{build_s['sketch_mma.cu']:.2f}, gram_block_mma.cu (32) "
        f"{build_s['gram_block_mma.cu']:.2f} and gram_mma.cu (8) "
        f"{build_s['gram_mma.cu']:.2f}; slowest "
        f"{max(build_s, key=build_s.get)} {max(build_s.values()):.2f}")
    _build.load_library()
    for K in (PATH_SHAPE[0], 25, 64, 100):
        for dt in ("f32", "bf16"):
            per_sm, smem = gram.launch_config(K, dt == "bf16", dt == "bf16", 0)
            log(f"launch: gram partial K={K} {dt}: {smem} B dynamic shared "
                f"memory per block, {per_sm} blocks per SM, "
                f"{gram.row_slices(K)} grid slices; gram finish: 0 B; "
                f"combine: 4*K = {4 * K} B (alpha)")
    sms = _build.sm_count(0)
    from repro_torch.kernels import combine
    for K, n, u16, w16 in ((100, 7840, False, False),
                           (BIG["P"], BIG_SLABS[0], True, False),
                           (BIG["P"], BIG_SLABS[1], True, False),
                           (BIG["P"], BIG["d_model"], True, False),
                           (64, 1 << 24, True, True),
                           (64, 1 << 24, False, False)):
        wk, blocks, chunks = combine.vec_plan(K, n, u16, w16, 0)
        per_sm = combine.vec_blocks_per_sm(u16, w16, wk, K, 0)
        log(f"launch: combine_vec K={K} n={n} U {'bf16' if u16 else 'f32'} "
            f"w {'bf16' if w16 else 'f32'}: W_k={wk} ({combine.VEC_WARPS // wk}"
            f" column groups a block), {per_sm} blocks of 256 threads per SM "
            f"({per_sm * sms} resident), {blocks} blocks over {chunks} chunks"
            f" ({-(-chunks // blocks)} a block at most, "
            f"{-(-blocks // (per_sm * sms))} wave)")
    for K in (1, PATH_SHAPE[0], 64, 100, 127):
        per_sm, smem = gram.mma_launch_config(K, 0)
        log(f"launch: gram_mma_partial K={K} bf16 (Kp={gram.mma_rows(K)}, "
            f"tiles per warp {max(len(w) for w in gram.mma_deal(K))}): "
            f"{smem} B dynamic shared memory per block, {per_sm} blocks of "
            f"256 threads per SM; n=2^24: (blocks, columns per block) "
            f"{gram.grid(1 << 24, sms, per_sm)}")
    for Ka, Kb in ((10, 5), (25, 25), (64, 32), (64, 63)):
        per_sm, smem = gram.block_mma_launch_config(Ka, Kb, 0)
        log(f"launch: gram_block_mma_partial Ka={Ka} Kb={Kb} bf16 (staged "
            f"rows {gram.block_mma_rows(Ka, Kb)}, tiles per warp "
            f"{max(len(w) for w in gram.block_mma_deal(Ka, Kb))}): {smem} B "
            f"dynamic shared memory per block, {per_sm} blocks of 256 "
            f"threads per SM; n=2^24: (blocks, columns per block) "
            f"{gram.grid(1 << 24, sms, per_sm)}")
    for K, n, m in SKETCH_MMA_MODEL + [(11, 1000, 129)]:
        per_sm, _ = cross.launch_config("sketch_mma_launch_config", (K, m), 0)
        log(f"launch: sketch_mma_partial K={K} m={m} bf16 (staged rows of U "
            f"{sketch.mma_rows(K)}, tiles per warp "
            f"{max(len(w) for w in sketch.mma_deal(K))}): {per_sm} blocks of "
            f"256 threads per SM; n={n}: (slices, blocks per slice, columns "
            f"per block) {sketch.mma_grid(n, m, sms, per_sm)}")
    for n, k in TOPK_PATH:
        p2 = 1 << (k - 1).bit_length()
        log(f"launch: topk n={n} k={k}: one block of 1024 threads, "
            f"{-(-4 * n // 8) * 8 + 8 * p2} B dynamic shared memory "
            f"({n} entries, {p2} sort keys)")
    for n, k in TOPK_MODEL[-2:-1]:
        log(f"launch: topk n={n} k={k}: (blocks, chunk) "
            f"{topk.grid(n, sms)}, 256 threads, 1 KB static shared memory")
    for K, n, m in SKETCH_PATH + SKETCH_MODEL:
        plan = rng_sketch.col_plan(K, n, m, sms)
        adj = rng_sketch.adjoint_plan(m, n, sms)
        log(f"launch: sign_sketch col K={K} n={n} m={m}: {plan.launches} "
            f"launch of {plan.row_tiles} row tiles of {plan.rows} rows (RI="
            f"{plan.ri}) x {plan.ranks} cluster ranks of "
            f"{plan.cols_per_rank} columns = {plan.blocks} blocks of 256 "
            f"threads; adjoint col: {adj.blocks} blocks of 512 threads, "
            f"{adj.cols_per_block} columns (CJ={adj.cj}) x WR={adj.wr} row "
            f"slices ({adj.blocks * rng_sketch.ADJ_WARPS / sms:.1f} warps an "
            f"SM); first body: (column splits, columns per split, rows per "
            f"pass) {rng_sketch.grid(K, n, m, sms)}")
    for fn, dims, n in (("stream_stats_launch_config", (100, 0), 7840),
                        ("stream_stats_launch_config", (16, 1), 8192 * 1024),
                        ("gram_block_launch_config", (64, 32), 1 << 24),
                        ("sketch_apply_launch_config", (8, 1024),
                         (1 << 20) + 3)):
        per_sm, slices = cross.launch_config(fn, dims, 0)
        what = fn.replace("_launch_config", "")
        if fn.startswith("stream_stats"):
            what += (f" ({'mma' if dims[1] else 'cross'} body) P={dims[0]}")
        elif fn.startswith("gram_block"):
            what += f" (cross body) rows {dims}"
        else:
            what += f" rows {dims}"
        log(f"launch: {what} n={n}: "
            f"{slices} slices x (blocks, columns per block) "
            f"{cross.grid(n, sms, per_sm, slices)}, {per_sm} blocks of 256 "
            "threads per SM")
    from repro_torch.kernels.decode_attn import (
        MMA_HEAD_DIMS, decode_mma_splits, decode_splits, mma_resident_blocks,
        resident_blocks)
    for B, S, KV, G, hd, window, _ in (DECODE_PATH,) + tuple(DECODE_MODEL):
        resident = resident_blocks(hd, G, True, 0)
        splits, rows = decode_splits(B, S, KV, resident, window)
        log(f"launch: flash_decode B={B} S={S} KV={KV} G={G} hd={hd} "
            f"window={window} bf16, CUDA-core body: {resident // sms} blocks "
            f"of 128 threads per SM; {splits} splits of {rows} rows -> "
            f"{splits * KV * B} blocks" + (
                f", then a merge of {B * KV} blocks" if splits > 1 else ""))
        if hd in MMA_HEAD_DIMS:
            resident = mma_resident_blocks(hd, 0)
            splits, rows = decode_mma_splits(B, S, KV, resident, window)
            log(f"launch: flash_decode B={B} S={S} KV={KV} G={G} hd={hd} "
                f"window={window} bf16, tensor-core body: {resident // sms} "
                f"blocks of 128 threads per SM; {splits} splits x {rows} "
                f"rows of each row's live window -> {splits * KV * B} "
                "blocks" + (f", then a merge of {B * KV * G} blocks of {hd}"
                            " threads" if splits > 1 else ""))
    return smi_line


KERNEL_SOURCES = {
    "gram": ("src/repro_torch/kernels/csrc/gram.cu",
             "src/repro/kernels/gram.py:104"),
    "combine": ("src/repro_torch/kernels/csrc/combine.cu",
                "src/repro/kernels/combine.py:30"),
    "topk": ("src/repro_torch/kernels/csrc/topk.cu",
             "src/repro/kernels/topk.py:34"),
    "sign_sketch": ("src/repro_torch/kernels/csrc/rng_sketch_col.cu",
                    "src/repro/kernels/rng_sketch.py:127"),
    "sign_sketch_adjoint": ("src/repro_torch/kernels/csrc/rng_sketch_col.cu",
                            "src/repro/kernels/rng_sketch.py:94"),
    "stream_stats": ("src/repro_torch/kernels/csrc/stream_stats.cu",
                     "src/repro/kernels/stream.py:102"),
    "gram_block": ("src/repro_torch/kernels/csrc/gram_block.cu",
                   "src/repro/kernels/gram.py:60"),
    "sketch": ("src/repro_torch/kernels/csrc/sketch.cu",
               "src/repro/kernels/sketch.py:39"),
    "flash_decode": ("src/repro_torch/kernels/csrc/decode_attn_mma.cu",
                     "src/repro/kernels/decode_attn.py:72"),
}


def kernel_entry(name: str, recs: list, launches: dict) -> dict:
    """The kernel's line: its numbers at the main path's shape (for
    gram_block the flat robust path's), or, for an op no runtime path
    reaches (sketch), at its first model shape."""
    src = KERNEL_SOURCES[name]
    path = next((r for r in recs if r["set"] == "path"), None) or next(
        r for r in recs if r["set"] == "model")
    return {"name": name, "route": "cuda", "source": src[0], "replaces": src[1],
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": path["max_abs_err"],
            "ms": path["ms"], "plain_ms": path["plain_ms"],
            "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
            "library_ms": path["library_ms"],
            "shape": {k: path[k] for k in ("P", "K", "Ka", "Kb", "n", "k",
                                           "m", "B", "S", "KV", "G", "hd",
                                           "window", "lengths", "dtype")
                      if k in path},
            "tolerance": path["tolerance"],
            "max_rel_err_all_shapes": max(_gated_err(r) for r in recs),
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
    from repro_torch.kernels import (combine, decode_attn, gram, rng_sketch,
                                     sketch)
    gram_bodies, block_bodies, sketch_bodies, decode_bodies = {}, {}, {}, {}
    combine_bodies, sign_bodies = {}, {}

    def on_cuda_core(path: str, phase, *args):
        """Run a path phase; every gram launch in it must take gram.cu's
        body (the paths hand gram f32 inputs), no path but the robust one
        reaches gram_block, and that one only its cross.cuh body (f32
        inputs), and no path reaches sketch."""
        gram.reset_body_launches()
        gram.reset_block_body_launches()
        sketch.reset_body_launches()
        decode_attn.reset_body_launches()
        combine.reset_body_launches()
        rng_sketch.reset_body_launches()
        result = phase(*args)
        combine_bodies[path] = combine.body_launches()
        sign_bodies[path] = rng_sketch.body_launches()
        gram_bodies[path] = gram.body_launches()
        block_bodies[path] = gram.block_body_launches()
        sketch_bodies[path] = sketch.body_launches()
        decode_bodies[path] = decode_attn.body_launches()
        need(gram_bodies[path]["mma"] == 0,
             f"{path}: gram bodies {gram_bodies[path]}, want cuda_core only")
        if path == "robust":
            need(block_bodies[path]["mma"] == 0
                 and block_bodies[path]["cross"] > 0,
                 f"{path}: gram_block bodies {block_bodies[path]}, want "
                 "cross only")
        else:
            need(sum(block_bodies[path].values()) == 0,
                 f"{path}: gram_block bodies {block_bodies[path]}, want none")
        need(sum(sketch_bodies[path].values()) == 0,
             f"{path}: sketch bodies {sketch_bodies[path]}, want none")
        need(all(t["first"] == 0 for t in sign_bodies[path].values()),
             f"{path}: sign sketch bodies {sign_bodies[path]}, want col only")
        return result

    try:
        smi_line = setup_phase()
        kern = kernels_phase()
        sync_counts, ds, params = on_cuda_core("sync", path_phase)
        asynced = on_cuda_core("async", async_phase, ds, params)
        hier_counts = on_cuda_core("hier", hier_phase, ds, params)
        streamed_counts = on_cuda_core("streamed", streamed_phase, ds, params)
        robusted = on_cuda_core("robust", robust_phase, ds, params)
        big = on_cuda_core("bigmodel", bigmodel_phase)
        served = on_cuda_core("serve", serve_phase)
        by_path = {"sync": sync_counts, "async": asynced["counts"],
                   "hier": hier_counts,
                   "streamed": streamed_counts, "robust": robusted["counts"],
                   "bigmodel": big["counts"], "serve": served["counts"]}
        for path, counts in by_path.items():
            need(gram_bodies[path]["cuda_core"] >= counts.get("gram/cuda", 0),
                 f"{path}: {counts.get('gram/cuda', 0)} gram launches, "
                 f"bodies {gram_bodies[path]}")
        log(f"gram bodies by path (each phase, its checks against the CPU "
            f"included): {gram_bodies}")
        # every gram_block launch of the robust runs was counted by body
        # (each run gated exactly); the phase's card-vs-CPU rounds add more
        need(block_bodies["robust"]["cross"]
             >= robusted["counts"]["gram_block/cuda"] > 0,
             f"robust: gram_block bodies {block_bodies['robust']}, "
             f"{robusted['counts']['gram_block/cuda']} launches in the runs")
        log(f"gram_block bodies by path: {block_bodies}")
        # combine: the sync path's K = 10 x 7 850 f32 rows (31 400 bytes)
        # keep combine.cu; every big-model slab takes combine_vec.cu
        need(combine_bodies["sync"]["vec"] == 0
             and combine_bodies["sync"]["scalar"]
             >= sync_counts["combine/cuda"],
             f"sync: combine bodies {combine_bodies['sync']}")
        need(combine_bodies["bigmodel"]["scalar"] == 0
             and big["combine_bodies"]["vec"] == big["counts"]["combine/cuda"],
             f"bigmodel: combine bodies {combine_bodies['bigmodel']}")
        log(f"combine bodies by path (each phase, its checks against the CPU "
            f"included): {combine_bodies}")
        # every sign sketch and adjoint launch of the hier and streamed
        # phases took the col body (the phases' card rounds against the CPU
        # included: at least the runs' own launches)
        for path in ("hier", "streamed"):
            for op in ("sign_sketch", "sign_sketch_adjoint"):
                launched = by_path[path].get(f"{op}/cuda", 0)
                need(launched > 0 and sign_bodies[path][op]["first"] == 0
                     and sign_bodies[path][op]["col"] >= launched,
                     f"{path}: {op} bodies {sign_bodies[path][op]}, "
                     f"{launched} launches in the runs, want col only")
        log(f"sign sketch bodies by path (each phase, its checks against the "
            f"CPU included): {sign_bodies}")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    entries = [kernel_entry(name, kern[name],
                            {path: counts.get(f"{name}/cuda", 0)
                             for path, counts in by_path.items()})
               for name in KERNEL_SOURCES]
    names = [e["name"] for e in entries]
    entries[names.index("gram")].update(
        sources=[KERNEL_SOURCES["gram"][0],
                 "src/repro_torch/kernels/csrc/gram_mma.cu"],
        bodies_by_path=gram_bodies)
    entries[names.index("gram_block")].update(
        sources=[KERNEL_SOURCES["gram_block"][0],
                 "src/repro_torch/kernels/csrc/gram_block_mma.cu"],
        bodies_by_path=block_bodies)
    entries[names.index("sketch")].update(
        sources=[KERNEL_SOURCES["sketch"][0],
                 "src/repro_torch/kernels/csrc/sketch_mma.cu"],
        bodies_by_path=sketch_bodies)
    entries[names.index("combine")].update(
        sources=[KERNEL_SOURCES["combine"][0],
                 "src/repro_torch/kernels/csrc/combine_vec.cu"],
        bodies_by_path=combine_bodies)
    entries[names.index("flash_decode")].update(
        sources=[KERNEL_SOURCES["flash_decode"][0],
                 "src/repro_torch/kernels/csrc/decode_attn.cu"],
        bodies_by_path=decode_bodies)
    for op in ("sign_sketch", "sign_sketch_adjoint"):
        entries[names.index(op)].update(
            sources=[KERNEL_SOURCES[op][0],
                     "src/repro_torch/kernels/csrc/rng_sketch.cu"],
            bodies_by_path={path: t[op] for path, t in sign_bodies.items()})
    async_numbers = {k: v for k, v in asynced.items() if k != "counts"}
    entries[names.index("combine")]["async"] = async_numbers
    entries[names.index("gram")]["async"] = async_numbers["flush_kernels"][
        "gram"]
    entries[names.index("gram_block")]["robust"] = robusted["numbers"]
    entries[names.index("stream_stats")]["bigmodel"] = {
        k: v for k, v in big.items() if k != "counts"}
    entries[names.index("flash_decode")]["serve"] = {
        k: v for k, v in served.items() if k != "counts"}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
