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
  2. kernels — ``gram`` (K up to 100, the gateways' 23-25 among them, the
     train path's scopes; the body each call took: ``gram_f32.cu`` for f32
     U and g, timed in turn with ``gram.cu`` on the same inputs, one device
     kernel a call, against an f64 product at model width; the bf16
     tensor-core body of ``gram_mma.cu`` for bf16 U and g with K <= 127 and
     n % 8 == 0; ``gram_realign.cu``, the same loop on realigned tiles, for
     the other bf16 calls with K <= 127: bitwise equal to ``gram_mma.cu`` on
     shifted views and as resident, the odd-n model rows timed in turn with
     ``gram.cu`` beside an aligned twin (the realigning body forced on it
     in turn) and their speed targets recorded; ``gram.cu`` for the rest,
     timed at bf16 K = 128 and at a bf16 U with an f32 g; and cross.cuh's
     bf16 ``gram_block`` at an odd n, ``stream_stats`` at P = 64 and
     ``sketch`` at K = 100 timed once each),
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
     too, and ``gram`` at the fleet's shapes, K = 500, 200 and 2 000 at
     n = 68 f32, with the host µs to issue a call; ``topk``: one device
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
     streamed, bigmodel, serve and moe phases runs ``gram_f32.cu``'s body:
     their inputs are f32); the losses must fall; compressed cloud uplink
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
     card matches the same round on the CPU; then its mesh part
     (``streamed_mesh``): one round of each configuration on the engine's
     mesh path (a one-rank NCCL group, a ('data',) mesh of ranks) bitwise
     equal to the round without a mesh, with the same launches, and the
     big-model round through the engine on each of 8 places of a mesh,
     its collectives done in-process: (G, C), the weights, the
     materialized vector and the new params against the round without a
     mesh and the plain versions, the places bitwise equal, every
     ``stream_stats`` window on ``stream_stats_mma`` and every ``combine``
     window on ``combine_vec.cu``, one place's pass time beside its byte
     bound;
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
  8. fleet   — ``benchmarks/torch_fleet_scale.py``'s ``collect()``: the
     64-device event path on ``materialize()``d shards against the cohort
     path on the ``VirtualFleetDataset`` (times, both byte totals, arrivals
     and drops equal, loss gap < 1e-5), then 10³, 10⁴ and 10⁵ devices at 3
     rounds and 10⁶ at 2 (cohort scheduler, v2 stream, ``cohort_chunk``
     131 072, ``max(4, N // 500)`` gateways), each held to
     ``BENCH_fleet.json``'s record (devices a round and both byte totals
     exactly, ``t_virtual_end`` at rel 1e-12, the loss within 2 %; at 10⁶,
     which has no record, the devices a round and the device-tier bytes
     they imply), with ``gram`` on the card on every round at every
     gateway and the cloud and no plain version; the warm round ms,
     devices/s, peak allocated memory and the round's spans per record;
     the shard generation's share of ``client_update``; the device idle
     share of a warm 10⁵ round (``torch.profiler``); and one 4 096-device
     cohort round on the card against the same round on the CPU on the
     card's shards (1e-4), beside how far the two devices' generators
     differ (max |Δx| within 1e-5 of max |x|, flipped labels);
  9. scaffold — ``run_scaffold`` at paper-logreg width on the path phase's
     data, FedAvg then contextual, 8 rounds each: the losses fall, every
     round launches ``combine`` (and, contextual, ``gram``) on the card and
     no plain version, round ms; one contextual round on the card against
     the same round on the CPU at 1e-4;
  10. bigmodel — the reference's full ``transformer_stream`` round
     (``benchmarks/bigmodel_round.py``: d_model 1024, vocab 8192, 4 layers,
     P = 16, bf16, n = 58 724 352) through the streamed engine: its round
     time, the accumulate pass beside its bound (every one of its 29
     ``stream_stats`` launches on the tensor-core body), the apply beside
     its bound (all 29 ``combine`` launches on ``combine_vec.cu``), with
     its device and host time, the rise of
     allocated memory across ``begin_round``, G and C against the plain
     version and against an f64 product, and the round's delta against the
     fused engine's on the same inputs;
  11. serve  — the continuous-batching ``DecodeEngine`` on the full
     qwen3-14b (40 layers, d_model 5 120, 40/8 heads, bf16, 14.77 B
     parameters from a seeded generator on the card): 4 slots of 256 rows
     serve 8 requests (prompts of 48-200 tokens, 32 or 4 new) with one
     mid-flight publish on the ``ModelBus``.  Every request completes, the
     versions are monotone, ``flash_decode`` launches L x decode steps, all
     on the cluster body, and no plain version runs; tokens/s, one decode
     step and one prefill chunk
     alone (CUDA events) beside the step's byte bound, the device busy time
     per step from ``torch.profiler``, the swap stall; one step's logits
     with the kernel against the plain ``flash_decode``, beside the floor
     two correct attentions show (the plain version in f32 against f64 and
     against SDPA, a yardstick used nowhere in the port); three staggered
     requests equal to each served alone; a reduced f32 qwen3 served on the
     card (on ``decode_attn.cu``'s body) and on the CPU gives the same
     tokens, and one decode step's logits on both within 1e-5.  Then the
     placed part (``serve_placed``): the placed prefill and decode steps
     (``launch.steps``, mode "tp": qwen3-14b "fsdp", zamba2-1.2b "tp") of
     qwen3-14b and then zamba2-1.2b at full width, bf16, on a one-rank
     NCCL (1, 1) mesh — 4 prompts of 200 tokens into a 32 768-row cache,
     then 8 decode steps — beside the unplaced steps (mode "dp") on the
     same params and tokens: every call's logits within SERVE_LOGIT_TOL of
     max |logit| (zamba2-1.2b: within 1.5x its floor, measured in the run
     as the unplaced steps with f32 attention against f64, call by call:
     its SSM states carry each step's rounding into the later steps),
     ``flash_decode`` launched once an attention layer a step
     (the hybrid's shared block: once a group), all on the tensor-core
     body, no plain version; the reduced f32 configs placed and unplaced
     within 1e-5 (TF32 off); ms a decode step (CUDA events) and its busy
     share, placed and unplaced;
  12. moe    — the serve phase again on each MoE config at full width (all
     layers, bf16, seeded; deepseek-moe-16b, 28 layers, 64 experts top-6
     and 2 shared, 16.9 B parameters, then olmoe-1b-7b, 16 layers, top-8,
     qk-norm, 6.9 B), each freed before the next, with the same gates and
     numbers, the logit gate at 1.5x the model's measured floor, the
     (layer, token) top-k sets that the attention's f32 differences moved,
     and the reduced f32 config card vs CPU; then layer 0 alone at T = 4
     and 64 against the dense all-experts formula in f64, once under
     ``set_sync_debug_mode("error")`` (no host sync), bitwise repeatable
     (no atomics), and its device µs split into router/dispatch, expert
     ``bmm``, combine and shared experts;
  13. recurrent — the lockstep loop of ``repro_torch.launch.serve`` (one
     batched ``prefill``, then a greedy ``decode_step`` per token) on
     rwkv6-1.6b (24 RWKV6 layers, 1.59 B parameters) and then zamba2-1.2b
     (38 Mamba2 layers in 6 groups of 6 and 2 remainder layers, one shared
     attention + MLP block after every group, 1.17 B), full width, bf16,
     seeded on the card, each freed before the next: batch 4, prompts of
     200 tokens, 32 new tokens.  No kernel lies on this path (the
     reference's scans are plain ``jnp``, the hybrid's attention the plain
     ``attention_decode``), so every launch counter stays 0, both
     backends; every row yields 32 tokens and the logits are finite.  The
     same weights in f32 (TF32 off): prefill of 200 + t tokens against the
     decode step on token t, t = 1..8, within 2e-3 of max |logit|; the
     bf16 logits against the f32 ones on the same tokens within 1.5x the
     model's measured floor (``RECURRENT_LOGIT_FLOOR``, printed); one
     decode step under ``set_sync_debug_mode("error")``; two steps from
     copies of one cache bitwise equal; the reduced f32 config (zamba2
     with two groups and a remainder layer) served on the card and on the
     CPU: equal tokens, the first decode step's logits within 1e-5.
     Numbers: prefill ms, one decode step alone (CUDA events, median and
     min-max of 5) beside its byte bound (weights, the shared block once
     per group, the states read and written, the shared K/V rows), device
     busy ms and kernel launches a step (``torch.profiler``), tokens/s and
     peak allocated memory, beside the card's name and power limit;
  14. whisper — the same lockstep loop on whisper-large-v3 (32 encoder
     and 32 decoder layers, 1.60 B parameters; the loop's f32 frames
     (4, 1 500, 1 280) run the encoder and the cached cross K/V in f32, as
     jnp promotes f32 @ bf16), at RECURRENT's sizes, with the recurrent
     phase's gates, the f32 one as prefill + decode at t = 0..8 against
     the teacher-forced ``whisper_forward_train`` (within 2e-3) at full
     depth, the bf16 one at 1.5x ``LOCKSTEP_LOGIT_FLOOR``; the step's bound
     counts the decoder's weights, the f32 cross K/V and the self K/V
     (``lockstep_step_bound``);
  15. chameleon — the same on chameleon-34b (48 layers, 34.4 B parameters,
     64.0 GiB of bf16 weights; image embeddings (4, 1 024, 8 192) fused
     ahead of the 200-token prompts, 1 256 cache rows), after every other
     phase has freed its tensors; its f32 checks and bf16 floor run on the
     full-width config cut to its first 4 layers (no f32 copy of the model
     fits the card), printed on every run;
  16. train — the reference's training driver, ``python -m
     repro_torch.launch.train --arch olmoe-1b-7b --steps 3 --batch 8 --seq
     128``, in-process on the host mesh of the card (C = 1, remat "full";
     6.92·10⁹ parameters, three stacked expert leaves of 2³¹ elements):
     finite losses, α = 1/(1+ridge) to 1e-5 every step, the first step's
     new params within one ulp of p + αΔ and (bf16 leaves) of p − lr·g in
     every element, gram once a step (``gram_f32.cu``) and combine once a leaf
     a step, no plain version; then C = 4 cohorts of the full zamba2-1.2b
     on an emulated (4, 1) mesh, 3 contextual steps (Theorem 1's bound
     g(α) < 0 each) and 3 fedavg steps, the first of each held kernel by
     kernel on its own inputs (the gram of the K = 4 scope, and each
     leaf's K = 4 combine, within one ulp of the exact sum on the step's
     α: fedavg's 1/4, against their plain versions); the path's
     kernel shapes timed beside their bounds (the combine at 2³¹ + 8 bf16
     elements, within one ulp of f64; the gram of olmoe's K = 1 scope of
     103 M columns); the reduced f32 zamba2 and olmoe steps on the card
     equal to the CPU's under remat False, "full" and "dots" (TF32 off);
     ``hierarchical_contextual_combine`` on a one-rank NCCL group equal to
     the local math; the placed step (``build_train_step`` mode "tp") of
     olmoe-1b-7b C = 1 on a one-rank NCCL (1, 1) mesh, each leaf's f32
     update within ``TRAIN_UPDATE_TOL`` of its max |update| of the
     unplaced step's (a fault planted in the MoE failing that gate), the
     reduced f32 model at ``TRAIN_TOL``, and gram and combine at the
     placed step's shapes on a 16-wide 'model' axis.  Numbers: ms a step (CUDA events, median of steps 2-3)
     beside the bound of one forward and one backward a cohort plus the
     apply (remat's re-forward beside it), tokens/s, peak allocated (and
     the peak of one step with its inputs resident), device busy and
     launches a step (``torch.profiler``);
  17. roofline — no model on the card: the dry run of ``launch.dryrun``
     (fake tensors, in subprocesses on the CPU) of each train combination
     predicts its step's peak within 10 % of the train phase's measured
     one, its FLOPs within [0.5, 2]x the analytic count; the analytic terms
     of ``launch.analytic`` beside every measured decode and train step,
     the memory term within [0.5, 2]x the phase's byte bound; four
     production combinations traced on fake process groups of 256 / 512
     ranks, each ``ok``: the train step and the decode steps
     placed, fitting, their per-rank FLOPs within [0.5, 2]x the analytic
     per-device FLOPs (olmoe-1b-7b's placed ``decode_32k`` among them,
     against the drop-free count: every expert over all its T slots).

The kernels phase also holds ``stream_stats``, ``gram_block`` and ``sketch``
(U Rᵀ against an explicit R) against their plain versions, bitwise
repeatable, at the paths' (``gram_block``: the robust path's f32 cross
terms, K = 10, 25 and 100 at n = 7 850), the reference benchmark's and
model shapes
(timed rows as the median and min-max of five rounds, with device µs;
``stream_stats``, ``gram_block`` and ``sketch``: which of their bodies
each shape took, and the model rows and the tensor-core bodies' ragged
shapes also against an f64 product; ``gram_block``'s bf16 rows with
aligned rows and n % 8 == 0 take the tensor-core body of
``gram_block_mma.cu``, every other call ``gram_block.cu``; ``sketch``'s
bf16 rows with K <= 64, aligned rows and n % 8 == 0 take
``sketch_mma.cu``, its other bf16 rows with K <= 64 (odd n, unaligned
views) ``sketch_realign.cu`` (bitwise equal to ``sketch_mma.cu`` on
shifted views), its f32 rows ``cross_f32.cu`` (one kernel a call), each
timed beside ``sketch.cu`` in turn, every other call ``sketch.cu``), and ``flash_decode``
(o and lse) at the serve path's shape, the MoE serve path's (KV 16, G 1,
hd 128), the placed serve part's (qwen3-14b's and zamba2-1.2b's heads, B
4 on a 32 768-row cache), a decode_32k-like cache, gemma-7b's
and starcoder2-15b's heads (the latter windowed), few heads on a
131 072-row cache (where the cluster body's cap binds), the decode_32k-like
cache cut into 16 seq blocks of 2 048 rows as the placed decode step calls
it on each rank's block (each body launched per block with local lengths,
the partials merged by ``ops.lse_merge``, gated against one whole-cache
call and the plain version with later blocks empty and a window across
block edges; the 16 calls plus the merge timed beside the whole call),
with ragged, strided, soft-capped and f32 caches, timed beside SDPA (bf16
q, k and v at hd 64 or 128 take the cluster body of
``decode_attn_cluster.cu``, one kernel a call, timed in turn with the
two-launch body of ``decode_attn_mma.cu`` (bitwise equal where the two
split plans agree) and ``decode_attn.cu``'s body on the same inputs, by
events, device µs and host µs to issue; every other call
``decode_attn.cu``; the ctypes call's own cost, 27 arguments against the
cluster body's plan by pointer).

The last lines are one ``{"kernels": [...]}`` JSON object, the
``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device": ...}``.
Matmuls run in full f32 (TF32 off) so the plain ``gram`` is a fair reference.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W power limit),
# from the port's one source of them; outside a checkout main() says so and
# exits before any is read
try:
    from repro_torch.launch import hlo_analysis as _rates
except ImportError:
    _rates = None
_F32 = _rates.PEAK_FLOPS_F32 if _rates else math.nan
HBM_BYTES_PER_S = _rates.HBM_BW if _rates else math.nan
PEAK_FLOPS = {"float32": _F32,
              "bfloat16": _rates.PEAK_FLOPS if _rates else math.nan}
F32_CUDA_CORE_FLOPS = _F32
# Instruction rates of the pipes the sign hash runs on.  The Hopper SM has
# 64 INT32 lanes beside its 128 FP32 lanes (NVIDIA H100 architecture white
# paper); the FP32 lanes' 67 TFLOP/s counts an FMA as 2 operations:
INT32_OPS = _F32 / 2 / 2       # shifts and logic ops, per second
FMA_PIPE_OPS = _F32 / 2        # FADD, FFMA and integer multiplies (IMAD)
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
# the train path's gram scopes (f32): olmoe-1b-7b's lm_head + final_norm at
# K = 1, and one placed rank's scope columns at K = 16 and 32
GRAM_TRAIN_SCOPES = [(1, 103_024_640), (16, 6_440_960), (32, 6_440_960)]
# gram's tensor-core body (bf16, K <= 127, n % 8 == 0): every 16-row tile
# count of [U; g] and its edges, with ragged last staged tiles; the model
# rows K = 10, 64 (MODEL) and 100 (GRAM_WIDE) at n = 2^24 take it timed
GRAM_MMA_K = (1, 15, 16, 17, 31, 32, 63, 64, 65, 100, 127)
GRAM_MMA_N = (8, 72, 4104)
# the bf16 MODEL rows at n = 2^20 + 3 take the realigning body
# (gram_realign.cu), each beside an aligned twin at this n on gram_mma.cu
GRAM_TWIN_N = 1 << 20
# bodies that had no timed row, one row each at a model width, 50 warm calls
# of each function timed (TIMED_ONCE_REPS a round): gram.cu at bf16
# K = 128 and at a bf16 U with an f32 g; cross.cuh for bf16 gram_block at
# an odd n, bf16 stream_stats at P > 32 and bf16 sketch at K > 64
GRAM_CUDA_CORE_TIMED = [(128, 1 << 20, "bfloat16"), (64, 1 << 20, "float32")]
GRAM_BLOCK_CROSS_TIMED = (25, 25, (1 << 20) + 3)
STREAM_CROSS_TIMED = (64, 1 << 20)
SKETCH_CROSS_TIMED = (100, 1 << 20, 256)
TIMED_ONCE_REPS = 10
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
# sketch (K, n, m): kernel_bench's shape (f32), ragged, and n = 2^20 + 3
# (bf16 and f32: a bf16 row of odd n starts only 2-byte aligned); f32 rows
# take cross_f32.cu, bf16 rows with K <= 64 the tensor-core bodies (the
# aligned (11, 1 000, 129) sketch_mma.cu, the others sketch_realign.cu),
# the bf16 (100, 777, 65) cross.cuh; then the realigning body's second
# model row, K = 64 against m = 256 at an odd n
SKETCH_APPLY_BENCH = [(8, 1 << 16, 1024)]
SKETCH_APPLY_RAGGED = [(1, 1, 1), (3, 130, 17), (11, 1000, 129),
                       (100, 777, 65)]
SKETCH_APPLY_MODEL = [(8, (1 << 20) + 3, 1024)]
SKETCH_REALIGN_MODEL = [(64, (1 << 22) + 3, 256)]
# the f32 model row's aligned twin (16-byte copies) on cross_f32.cu
SKETCH_F32_TWIN = [(8, 1 << 20, 1024)]
# the realigning body against sketch_mma.cu bit for bit: U and R viewed
# 2·s bytes into their buffers (s = 1..7, R at 3s mod 8), n % 8 == 0
SKETCH_REALIGN_M = (1, 129, 1024)
SKETCH_REALIGN_N = (8, 4104)
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
# the MoE serve path's shape: both MoE configs have 16 KV heads of hd 128
# and no grouping (G = 1), on the serve cache and lengths
DECODE_MOE = (4, 256, 16, 1, 128, None, [1, 97, 200, 256])
# few heads on a long cache, where the cluster body's cap of 16 splits a
# head binds (the two-launch body takes 33): 537 MB of K and V
DECODE_LONG = (1, 131072, 8, 5, 128, None, None)
# the serve phase's placed part's own shapes (SERVE_PLACED: 4 rows of a
# 32 768-row cache on a one-rank mesh, so a rank's block is the whole
# cache): qwen3-14b's heads, and zamba2-1.2b's shared block (KV 32, G 1,
# hd 64, the tensor-core body); the lengths of the part's first and last
# decode steps (201, 208) beside longer ones
DECODE_PLACED = [(4, 32768, 8, 5, 128, None, [201, 208, 16384, 32768]),
                 (4, 32768, 32, 1, 64, None, [201, 208, 16384, 32768])]
# the placed decode step's view of a decode_32k-like cache: 16 seq blocks
# of 2 048 rows (one a 'model' rank), each launched with local lengths at
# its offset, the partials merged by ops.lse_merge; gated against one
# whole-cache call and the plain version on lengths that leave later blocks
# empty and a window across block edges, timed on full lengths
DECODE_BLOCKS = dict(B=8, S=32768, KV=8, G=5, hd=128, blocks=16,
                     lengths=[1, 2048, 2049, 9000, 16384, 20000, 32767,
                              32768], window=3000)
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
# the serve phase's placed part: the placed prefill and decode steps
# (launch.steps, mode "tp") of each model at full width, bf16, on a one-rank
# NCCL (1, 1) mesh, beside the unplaced steps (mode "dp") on the same params
# and tokens: 4 prompts of 200 tokens into a 32 768-row cache, then 8 decode
# steps; every logits row within SERVE_LOGIT_TOL of max |logit|, the reduced
# f32 configs at SERVE_LOGIT_TOL_F32 (TF32 off).  A hybrid's SSM states
# carry each step's attention rounding into every later step, so its gap
# grows step by step and qwen3-14b's one-step floor does not bound it: its
# floor is measured in the run, the unplaced steps with their plain
# attention in f32 against the same in f64 over the same calls, and its
# gate is SERVE_PLACED_FLOOR_RATIO x that floor's largest call
SERVE_PLACED_FLOOR_RATIO = 1.5
SERVE_PLACED = dict(archs=("qwen3-14b", "zamba2-1.2b"), batch=4, prompt=200,
                    max_seq=32768, steps=8, small_prompt=20, small_seq=64)
# the moe phase: both MoE configs at full width (all layers, bf16, seeded)
# on SERVE's traffic, deepseek-moe-16b (33.8 GB) first, each freed before
# the next.  Their logit floor is measured per model, as SERVE_LOGIT_FLOOR
# was for qwen3-14b: the plain flash_decode in f32 against the same
# arithmetic in f64 in one full-width decode step, max |dlogit| / max
# |logit|, on an H100 (5.639e-2 and 6.258e-2; against SDPA 6.203e-2 and
# 6.757e-3).  Routing is discrete: the attention's f32 differences move
# 7-12 of the step's (layer, token) top-k sets at near ties, and a moved
# set moves the logits far more than the rounding alone, so the floor is
# ~3x qwen3-14b's.  The gate is 1.5x it.
MOE_ARCHS = ("deepseek-moe-16b", "olmoe-1b-7b")
MOE_LOGIT_FLOOR = {"deepseek-moe-16b": 5.639e-2, "olmoe-1b-7b": 6.258e-2}
# one full-width bf16 MoE layer against the reference test's dense
# all-experts formula (tests/test_model_numerics.py) in f64, max |err| /
# max |ref|: the layer rounds its buffer products, activations, gate
# weights, weighted contributions and each of the k adds to bf16 (~1e-2
# on the CPU at olmoe and deepseek widths with 16 experts)
MOE_LAYER_TOL = 3e-2
MOE_LAYER_TOKENS = (4, 64)       # a decode step, a prefill chunk
# the recurrent phase: rwkv6-1.6b, then zamba2-1.2b, at full width (all
# layers, bf16, seeded) through the lockstep loop of repro_torch.launch.serve
# (batch 4, prompts of 200 tokens, 32 new tokens, greedy), each freed before
# the next; small is the reduced f32 config served on the card and the CPU
# (zamba2 with two groups and a remainder layer)
RECURRENT_ARCHS = ("rwkv6-1.6b", "zamba2-1.2b")
RECURRENT = dict(batch=4, prompt=200, new=32, given=8, small_prompt=40,
                 small_new=8, timed_steps=5)
RECURRENT_SMALL = {"rwkv6-1.6b": {}, "zamba2-1.2b": {"num_layers": 5}}
# chunked prefill against the recurrent decode in f32 (TF32 off), max
# |dlogit| / max |logit|: the reference's tolerance for this invariant
# (tests/test_model_numerics.py)
RECURRENT_CHUNK_TOL = 2e-3
# the bf16 model's lockstep logits against the same weights in f32 on the
# same tokens, max |dlogit| / max |logit| over the 32 steps (prefill's and
# 31 teacher-forced decode steps'), measured on an H100 per model: every
# projection, mix, gate and norm output rounds to bf16 through 24 / 38
# layers, where the states and scans stay in f32; the gate is 1.5x it
RECURRENT_LOGIT_FLOOR = {"rwkv6-1.6b": 5.153e-2, "zamba2-1.2b": 7.160e-2}
# the whisper and chameleon phases: whisper-large-v3, then chameleon-34b,
# at full width (all layers, bf16, seeded) through the same lockstep loop
# at RECURRENT's sizes (batch 4, prompts of 200, 32 new tokens), each
# freed before the next.  The loop's f32 frames run whisper's encoder in
# f32 (jnp's promotion, as the reference's loop does).  The f32 checks run
# whisper at full depth and chameleon on its first CHAMELEON_CUT layers at
# full width (no f32 copy of the 34.4 B parameters fits the card).
LOCKSTEP_PHASES = {"whisper": ("whisper-large-v3", None),
                   "chameleon": ("chameleon-34b", 4)}
# the bf16 model's lockstep logits against the same weights in f32 on the
# same tokens, max |dlogit| / max |logit| over the 32 steps, measured on an
# H100 per model as RECURRENT_LOGIT_FLOOR was: whisper's 32 decoder layers
# round every projection and residual to bf16 (its encoder and cross K/V
# are f32 in both runs), chameleon's 4-layer cut the same with qk-norm and
# RoPE; the gate is 1.5x it
LOCKSTEP_LOGIT_FLOOR = {"whisper-large-v3": 1.649e-2,
                        "chameleon-34b": 2.153e-2}
# the train phase: the reference's training driver (launch.train) on the
# full olmoe-1b-7b at its defaults (the one card's host mesh: C = 1, remat
# "full"), then C = 4 cohorts of the full zamba2-1.2b on an emulated (4, 1)
# mesh (3 contextual steps, then 3 fedavg), the reduced f32 configs card =
# CPU under each remat policy, and the collectives on a one-rank NCCL group
TRAIN = dict(arch="olmoe-1b-7b", steps=3, batch=8, seq=128, lr=0.02,
             ridge=1e-6)
TRAIN_COHORTS = dict(arch="zamba2-1.2b", mesh=(4, 1), batch=8, seq=128,
                     steps=3, lr=0.02)
TRAIN_SMALL = ("zamba2-1.2b", "olmoe-1b-7b")
TRAIN_SMALL_SHAPE = dict(batch=8, seq=32)
TRAIN_REMATS = (False, "full", "dots")
TRAIN_TOL = 1e-5            # relative to max(1, max |p|), as the CPU tests
TRAIN_ALPHA_TOL = 1e-5      # α = 1/(1 + ridge) at C = 1
# the placed full-width bf16 step against the unplaced one: each leaf's f32
# combined update, max |a - b| over the leaf's max |b|.  Δ = bf16(-lr·g):
# two correct steps whose bf16 grads round apart differ by one bf16 ulp of
# an element (at most 2^-7 of it) a rounding, a few roundings deep; a grad
# that is wrong or missing moves a leaf's update by its own scale
TRAIN_UPDATE_TOL = 2.0 ** -5
# faults planted in the placed step's MoE (models.moe.combine), each run
# through the gate: "router": the combine weights detached (the router's
# grad from the aux loss alone), gated to fail it; "last": each token's
# last, smallest-weighted expert dropped, reported
TRAIN_FAULTS = ("router", "last")
# the placed step's kernel shapes on a 16-wide 'model' axis: olmoe-1b-7b's
# scope on one rank (lm_head's 2048 x 50304/16 columns + final_norm's 2048)
# at K = 16 (one pod) and 32 (two), and an expert leaf's block (2^31 / 16
# bf16 elements) taking its f32 combined update
TRAIN_SHARDED = dict(model=16, n_scope=2048 * 50304 // 16 + 2048,
                     Ks=(16, 32), n_expert=(1 << 31) // 16)
# the roofline phase (after train): the port's dry run (launch.dryrun, on
# fake tensors, in subprocesses that never touch the card) against the train
# phase's measured steps, the analytic terms (launch.analytic) beside every
# measured step, and three production combinations on a fake process group
ROOFLINE_PEAK_TOL = 0.10                 # |predicted - measured| / measured
ROOFLINE_FLOPS_RANGE = (0.5, 2.0)        # trace / analytic train FLOPs
ROOFLINE_BYTES_RANGE = (0.5, 2.0)        # analytic memory term / byte bound
ROOFLINE_PRODUCTION = (("olmoe-1b-7b", "train_4k", "single"),
                       ("olmoe-1b-7b", "decode_32k", "single"),
                       ("qwen3-14b", "decode_32k", "single"),
                       ("rwkv6-1.6b", "decode_32k", "multi"))
ROOFLINE_TIMEOUT_S = 600                 # for all six dry runs together
# the placed train trace (olmoe-1b-7b|train_4k|single): its per-rank FLOPs
# at most this many times the analytic per-device FLOPs (the replicated
# step's were 19.8x), its arguments within this share of the specs' blocks
ROOFLINE_PLACED_FLOPS_MAX = 2.0
ROOFLINE_PLACED_ARGS_TOL = 0.01
# the placed decode traces: placed, fitting, their per-rank FLOPs
# within this range of the analytic per-device FLOPs (the replicated steps'
# were 241-1 459x).  For a MoE model that analytic is the drop-free one:
# at T <= 256 tokens moe.capacity gives every expert T slots, so each of a
# rank's E/m experts runs its product over all T (E·T slot products where
# the k-active count has k·T): launch.analytic with experts_per_token = E
# (olmoe-1b-7b 3.50x, deepseek-moe-16b 4.12x the k-active count)
ROOFLINE_DECODE_FLOPS_RANGE = (0.5, 2.0)
HIER_ROUNDS = 6
# the reference's recorded streamed-vs-fused loss gap (BENCH_bigmodel.json)
STREAMED_LOSS_GAP = 1.4e-3
# the streamed pass split by the engine's window plan over this many places
# (one rank each on a mesh of ranks), on the big-model round's slabs: the
# eight partials summed in place order against the whole pass and the plain
# version, relative to max |whole| (CROSS_TOL: the bigmodel G/C gate)
STREAM_SPLIT_RANKS = 8
# the split round's materialize and apply on the whole round's weights
# against the whole round's and the plain version's, relative to max
# |whole|: the same f32 sums per column, in another order where a narrow
# window splits its rows across warps (combine_vec.cu's W_k)
SPLIT_COMBINE_TOL = 1e-5
# the split round's weights against the whole round's: the α bound of
# tests/test_distributed_spmd.py (a split sums (G, C) in another order)
ALPHA_RTOL, ALPHA_ATOL = 1e-3, 1e-4
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
# the fleet phase (benchmarks/torch_fleet_scale.py): its sizes, the rounds of
# the 10^3-10^5 records and of the 10^6 one, and its gates against
# BENCH_fleet.json (loss: the port's shards are the same family, not the
# same bits)
FLEET_DIM, FLEET_CLASSES = 16, 4
FLEET_SIZES = (1_000, 10_000, 100_000, 1_000_000)
FLEET_ROUNDS = 3
FLEET_1M_ROUNDS = 2
FLEET_T_RTOL = 1e-12
FLEET_LOSS_RTOL = 0.02
FLEET_CPU_DEVICES = 4096
FLEET_GEN_RTOL = 1e-5     # card vs CPU generation, x max |x| (ulp-level
                          # differences of the transcendentals)
SCAFFOLD_ROUNDS = 8
# gram at the fleet's shapes: a gateway of 500 devices, the cloud over 200
# (10^5) and 2 000 (10^6) gateways, each at n = 16 x 4 + 4 = 68 f32
GRAM_FLEET = [(500, 68), (200, 68), (2000, 68)]


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
# Late in a long run the first launch of a window was lost in every one of
# the five attempts (the sign_sketch_adjoint row: 2 of 3 launches each
# time), as the profiler drops device activity whose converted time stamp
# falls outside the window's host-clock bounds.  So the recorded calls sit
# this many seconds of idle inside each edge of the window.  A window has
# also shown one launch more than its calls made (4 of 3 calls of one
# gram_block row: the warm-up call's, counted in the recorded cycle).  So
# an attempt whose every count is a multiple of the calls stands as it is;
# otherwise the attempts are merged kernel by kernel, a count that is a
# multiple of the calls kept before one that is not, the larger of two
# alike.
PROFILE_PAD_S = 0.005


def _better_count(new: int, old: int, calls: int) -> bool:
    """Whether a kernel's launch count ``new`` from one profiler attempt
    replaces ``old`` from another: a multiple of ``calls`` before one that
    is not, else the larger."""
    return (new % calls == 0, new) > (old % calls == 0, old)


def _profile_window(fn, calls: int) -> list:
    """The ``key_averages()`` entries with device time (kernels, not aten
    ops, runtime calls, the step markers or CUPTI's own buffer activity,
    which a window of thousands of launches shows once) of ``calls`` calls
    of ``fn``, recorded after one call in the profiler's warm-up cycle."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_PAD_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        prof.step()
    return [e for e in prof.key_averages() if _device_us(e) > 0
            and not e.key.startswith(("aten::", "cuda", "ProfilerStep",
                                      "Activity Buffer", "Buffer Flush"))]


def _device_rows(fn, calls: int) -> list:
    """:func:`_profile_window` of ``calls`` calls of ``fn`` after a warm-up
    call; an incomplete trace is taken again (``PROFILE_ATTEMPTS``): an
    attempt complete by itself is the result, else each kernel is kept from
    the attempt that saw it a multiple of ``calls`` times (the most such),
    or else most often, until the merged rows are complete or the attempts
    are spent."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(PROFILE_ATTEMPTS):
        rows = _profile_window(fn, calls)
        if rows and all(e.count % calls == 0 for e in rows):
            return rows
        for e in rows:
            if e.key not in best or _better_count(e.count, best[e.key].count,
                                                  calls):
                best[e.key] = e
        if best and all(e.count % calls == 0 for e in best.values()):
            return list(best.values())
        log(f"profiler: incomplete trace of {calls} calls "
            f"{ {e.key[:40]: e.count for e in rows} }, profiled again")
    return list(best.values())


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


def host_ms_in_turn(fns: dict, reps: int, repeats: int = 5) -> dict:
    """``{name: median host ms per call}``: :func:`host_ms` of every fn,
    the fns taken in turn within each of ``repeats`` rounds, so that drift
    of the host hits all alike."""
    import torch
    runs = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            runs[name].append((time.perf_counter() - t0) / reps * 1e3)
    torch.cuda.synchronize()
    return {name: statistics.median(r) for name, r in runs.items()}


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


def gram_bound(K: int, n: int, dt, g_dt=None) -> dict:
    import torch
    size = torch.finfo(dt).bits // 8
    g_size = torch.finfo(g_dt or dt).bits // 8
    nbytes = K * n * size + n * g_size + (K * K + K) * 4
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
               f64: bool = False, U=None, g=None, realign_in_turn: bool = False,
               reps: int = None) -> dict:
    """gram against its plain version: two calls bitwise equal, G symmetric,
    within the tolerance, and the body both took (``f32``: gram_f32.cu,
    ``mma``: gram_mma.cu, ``realign``: gram_realign.cu, ``cuda_core``:
    gram.cu; ``body``, if given, must be it); with ``timed`` the spread of
    kernel, plain and ``torch.matmul`` times (``reps`` calls a round, else
    by size) and the device kernels, and on an ``f32`` or ``realign`` row
    gram.cu (``body="cuda_core"``) on the same inputs too: within the
    tolerance, timed in turn, its device kernels; an ``f32`` row one
    device kernel a call and both bodies' host µs to issue a call, a
    ``realign`` row its two kernels (partial and finish) a call; with
    ``realign_in_turn`` (an ``mma`` row) the realigning body forced on the
    same rows, bitwise equal to it and timed in turn; with ``f64`` the
    kernel's and the plain version's error against an f64 product (the
    kernel's within the tolerance)."""
    import torch
    from repro_torch.kernels import gram, ops, ref
    if U is None:
        U = torch.randn((K, n), generator=gen, device="cuda").to(dt)
        g = torch.randn((n,), generator=gen, device="cuda").to(dt)
    dt = U.dtype
    took = gram._body(U, g)
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
    if g.dtype != dt:
        rec["g_dtype"] = _dtype_name(g.dtype)
    if f64:
        rec["f64_rel_err"] = _gram_f64_err((G, c), U, g)
        rec["plain_f64_rel_err"] = _gram_f64_err((Gr, cr), U, g)
        log(f"{what} against an f64 product: kernel "
            f"{rec['f64_rel_err']:.3e}, plain {rec['plain_f64_rel_err']:.3e} "
            f"(tolerance {tol})")
        need(rec["f64_rel_err"] <= tol,
             f"{what}: {rec['f64_rel_err']:.3e} off an f64 product")
    fns = {"ms": lambda: ops.gram_and_cross(U, g, backend="cuda")}
    if took in ("f32", "realign"):
        fns["cuda_core_ms"] = lambda: gram.gram_cuda(U, g, body="cuda_core")
        Gc, cc = fns["cuda_core_ms"]()
        rec["cuda_core_rel_err"] = max(_max_err(Gc, Gr) / _scale(Gr),
                                       _max_err(cc, cr) / _scale(cr))
        need(rec["cuda_core_rel_err"] <= tol,
             f"{what}: gram.cu {rec['cuda_core_rel_err']:.3e} off plain")
        del Gc, cc
    if realign_in_turn:
        need(took == "mma", f"{what}: realign in turn on a {took} row")
        fns["realign_ms"] = lambda: gram.gram_cuda(U, g, body="realign")
        Gf, cf = fns["realign_ms"]()
        need(torch.equal(Gf, G) and torch.equal(cf, c),
             f"{what}: the realigning body forced on aligned rows differs "
             "from gram_mma.cu bitwise")
        del Gf, cf
    if timed:
        reps = reps or reps_for(U.numel() * U.element_size())
        g_lib = g if g.dtype == dt else g.to(dt)
        _time_record(rec, dict(fns, **{
            "plain_ms": lambda: ref.gram_ref(U, g),
            "library_ms": lambda: (U @ U.T, U @ g_lib)}), reps)
        rec.update(gram_bound(K, n, dt, g.dtype))
        log(f"{what}: device kernels (launches in 3 calls, us per launch) "
            + _kernel_names(rec))
        kern = rec["device_kernels"]
        if took == "mma":
            need(any("gram_mma_partial<" in k and ", false>" in k
                     for k in kern), f"{what}: device kernels {kern}")
        if took == "realign":
            need(_realign_kernels(kern, "gram")
                 and all(cnt % 3 == 0 for cnt, _ in kern.values()),
                 f"{what}: want the realigning partial and the finish a "
                 f"call, got {kern}")
        if took == "f32":
            need(len(kern) == 1 and all("gram_f32" in name and cnt % 3 == 0
                                        for name, (cnt, _) in kern.items()),
                 f"{what}: want one gram_f32 kernel a call, got {kern}")
        if took in ("f32", "realign"):
            cck = device_kernel_means(fns["cuda_core_ms"])
            rec["cuda_core_device_kernels"] = cck
            rec["cuda_core_device_ms"] = sum(ms for _, ms in cck.values())
            log(f"{what}: gram.cu in turn {_fmt_spread(rec, 'cuda_core_ms')}"
                f"us, device {rec['cuda_core_device_ms'] * 1e3:.1f}us in "
                f"{len(cck)} kernels; the {took} body "
                f"{rec['ms'] / rec['bound_ms']:.2f}x its bound, "
                f"torch.matmul {rec['library_ms'] / rec['ms']:.2f}x it")
        if realign_in_turn:
            rk = device_kernel_means(fns["realign_ms"])
            need(_realign_kernels(rk, "gram"),
                 f"{what}: forced realign device kernels {rk}")
            rec["realign_device_kernels"] = rk
            rec["realign_device_ms"] = sum(ms for _, ms in rk.values())
            log(f"{what}: realign forced in turn "
                f"{_fmt_spread(rec, 'realign_ms')}us, device "
                f"{rec['realign_device_ms'] * 1e3:.1f}us (mma device "
                f"{rec['device_ms'] * 1e3:.1f}us)")
    if timed and took == "f32":
        rec["host_ms"] = host_ms(fns["ms"], 50)
        rec["cuda_core_host_ms"] = host_ms(fns["cuda_core_ms"], 50)
        log(f"{what}: host us to issue a call: f32 body "
            f"{rec['host_ms'] * 1e3:.1f}, gram.cu "
            f"{rec['cuda_core_host_ms'] * 1e3:.1f}")
    return rec


def gram_realign_bitwise_row(gen) -> dict:
    """The realigning body against gram_mma.cu bit for bit, and the two
    instances' occupancy: for every K of GRAM_MMA_K the realigning partial
    kernel is as resident as the aligned one (whose occupancy sizes both
    grids), and for s = 1..7 and n in GRAM_MMA_N (n % 8 == 0, n = 4 104
    with a ragged last tile) U viewed 2·s bytes into its buffer and g
    2·(3s mod 8) bytes into its own take ``realign``, their aligned copies
    ``mma``, and the two results are equal; ``body="realign"`` on the
    aligned copies too."""
    import torch
    from repro_torch.kernels import gram
    bf16 = torch.bfloat16
    occupancy = {}
    for K in GRAM_MMA_K:
        occupancy[K] = (gram.mma_launch_config(K, 0),
                        gram.realign_launch_config(K, 0))
        need(occupancy[K][0][0] == occupancy[K][1][0],
             f"gram realign K={K}: (blocks an SM, shared memory) "
             f"{occupancy[K][1]}, the aligned instance's {occupancy[K][0]}")
    cases = 0
    gram.reset_body_launches()
    for K in GRAM_MMA_K:
        for s in range(1, 8):
            for n in GRAM_MMA_N:
                views = []
                for rows, skip in ((K, s), (1, 3 * s % 8)):
                    buf = torch.randn((rows * n + 8,), generator=gen,
                                      device="cuda").to(bf16)
                    views.append(buf[skip:skip + rows * n])
                U, g = views[0].view(K, n), views[1]
                what = f"gram realign K={K} n={n} shift {s}"
                need(gram._body(U, g) == "realign"
                     and gram._body(U.clone(), g.clone()) == "mma",
                     f"{what}: bodies")
                got = gram.gram_cuda(U, g)
                want = gram.gram_cuda(U.clone(), g.clone())
                forced = gram.gram_cuda(U.clone(), g.clone(), body="realign")
                need(all(torch.equal(a, b) and torch.equal(b, f)
                         for a, b, f in zip(got, want, forced)),
                     f"{what}: differs from gram_mma.cu bitwise")
                cases += 1
    tally = gram.body_launches()
    need(tally == {"mma": cases, "realign": 2 * cases, "f32": 0,
                   "cuda_core": 0},
         f"gram realign bitwise: body launches {tally}")
    log(f"gram realign = gram_mma.cu bitwise on {cases} shifted views (K "
        f"{GRAM_MMA_K}, s 1..7, n {GRAM_MMA_N}); blocks an SM equal for "
        f"both instances, (blocks, shared bytes) aligned / realigning: "
        f"{ {K: (o[0], o[1][1]) for K, o in occupancy.items()} }")
    return {"K": list(GRAM_MMA_K), "n": list(GRAM_MMA_N),
            "shifts": list(range(1, 8)), "cases": cases, "dtype": "bfloat16",
            "body": "realign", "bitwise_vs_mma": True,
            "occupancy": {K: [*o[0], o[1][1]] for K, o in occupancy.items()},
            "max_abs_err": 0.0, "rel_err": 0.0,
            "tolerance": TOL[("gram", "bfloat16")],
            "bitwise_repeatable": True, "gated_on": "plain"}


def gram_realign_targets(recs: list) -> dict:
    """The realigning body's speed targets at each MODEL row it takes
    (bf16, n = 2^20 + 3), recorded as met or not (no gate): faster than
    ``torch.matmul``; device time at most 1.3x the aligned twin's (n =
    2^20, gram_mma.cu); at least 4x faster than gram.cu in turn."""
    out = {}
    for rec in recs:
        if rec.get("body") != "realign" or rec["set"] != "model":
            continue
        twin = next(r for r in recs if r["set"] == "model"
                    and r["body"] == "mma" and r["K"] == rec["K"]
                    and r["n"] == GRAM_TWIN_N)
        got = {"below_library": rec["ms"] < rec["library_ms"],
               "device_vs_twin": rec["device_ms"] / twin["device_ms"],
               "vs_cuda_core": rec["cuda_core_ms"] / rec["ms"]}
        got["within_1.3x_twin"] = got["device_vs_twin"] <= 1.3
        got["4x_cuda_core"] = got["vs_cuda_core"] >= 4.0
        rec["targets"] = got
        out[rec["K"]] = got
        log(f"gram realign K={rec['K']} n={rec['n']} targets: "
            f"{rec['ms'] * 1e3:.1f}us by events, torch.matmul "
            f"{rec['library_ms'] * 1e3:.1f}us ("
            f"{'met' if got['below_library'] else 'not met'}); device "
            f"{rec['device_ms'] * 1e3:.1f}us, {got['device_vs_twin']:.3f}x "
            f"the aligned twin's {twin['device_ms'] * 1e3:.1f}us (<= 1.3x "
            f"{'met' if got['within_1.3x_twin'] else 'not met'}); gram.cu "
            f"{rec['cuda_core_ms'] * 1e3:.1f}us, {got['vs_cuda_core']:.2f}x "
            f"it (>= 4x {'met' if got['4x_cuda_core'] else 'not met'})")
    return out


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
                plain_gate: bool = True, extra: dict = None,
                reps: int = None) -> dict:
    """One of the cross-product kernels (``stream_stats``, ``gram_block``,
    ``sketch``) against its plain version on ``args``: bitwise equal over
    two calls and within CROSS_TOL of max |plain| (unless ``plain_gate`` is
    False: then the caller gates on an f64 product and the distance from
    the plain version is only recorded); with ``timed``, CUDA-event times
    of the kernel, the plain version, ``library`` and the ``extra`` calls
    (the median and min-max of ``TOPK_REPEATS`` rounds taken in turn) and
    the kernel's device kernels and device time per call (``reps`` calls a
    round, else by size)."""
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
        reps = reps or reps_for(args[0].numel() * args[0].element_size()
                                + args[1].numel() * args[1].element_size())
        _time_record(rec, dict({
            "ms": lambda: registry.dispatch(op, *args, backend="cuda"),
            "plain_ms": lambda: registry.dispatch(op, *args, backend="torch"),
            "library_ms": library}, **(extra or {})), reps)
        rec.update(bound_rec)
    return rec


def _realign_kernels(kern: dict, op: str = "sketch") -> bool:
    """Whether a call's device kernels are a realigning tensor-core body's
    two: ``<op>_mma_partial<..., true>`` (sketch_realign.cu's or
    gram_realign.cu's instance) and ``<op>_mma_finish``."""
    return (len(kern) == 2
            and any(f"{op}_mma_partial<" in k and ", true>" in k
                    for k in kern)
            and any(f"{op}_mma_finish" in k for k in kern))


def _f32_body_checks(rec: dict, what: str, call, cross_call, want,
                     timed: bool, body: str = "f32") -> None:
    """An f32 row of gram_block, stream_stats or sketch
    (``csrc/cross_f32.cu``): one device kernel a call, ``cross_f32_tiles``
    (the timed rows' kernels, else one profiled call); or, with
    ``body="realign"``, a realigned bf16 row of sketch: the partial kernel
    of sketch_realign.cu and the finish.  On a timed row cross.cuh's body
    on the same inputs (``cross_call``: ``body="cross"``, timed in turn by
    :func:`check_cross`) within CROSS_TOL of the plain version ``want``,
    its device kernels, and both bodies' host µs to issue a call (taken in
    turn)."""
    calls = 3 if timed else 1
    kern = rec["device_kernels"] if timed else device_kernel_means(call, 1)
    if body == "f32":
        need(len(kern) == 1 and all("cross_f32" in name and cnt % calls == 0
                                    for name, (cnt, _) in kern.items()),
             f"{what}: want one cross_f32 kernel a call, got {kern}")
        rec["one_kernel_a_call"] = True
    else:
        need(_realign_kernels(kern),
             f"{what}: want the realigning partial and the finish, got {kern}")
    if not timed:
        return
    got = _outs(cross_call())
    rec["cross_rel_err"] = max(_max_err(a, b) / _scale(b)
                               for a, b in zip(got, _outs(want)))
    need(rec["cross_rel_err"] <= CROSS_TOL,
         f"{what}: cross.cuh's body {rec['cross_rel_err']:.3e} off plain")
    cck = device_kernel_means(cross_call)
    rec["cross_device_kernels"] = cck
    rec["cross_device_ms"] = sum(ms for _, ms in cck.values())
    host = host_ms_in_turn({body: call, "cross": cross_call}, 50)
    rec["host_ms"], rec["cross_host_ms"] = host[body], host["cross"]
    log(f"{what}: cross.cuh in turn {_fmt_spread(rec, 'cross_ms')}us, device "
        f"{rec['cross_device_ms'] * 1e3:.1f}us in {len(cck)} kernels, host "
        f"{rec['cross_host_ms'] * 1e3:.1f}us; the {body} body device "
        f"{rec['device_ms'] * 1e3:.1f}us, host {rec['host_ms'] * 1e3:.1f}us, "
        f"{rec['ms'] / rec['bound_ms']:.2f}x its bound, the library "
        f"{rec['library_ms'] / rec['ms']:.2f}x it")


def _f64_err(got, d64, g64) -> float:
    """max |got - (D Dᵀ, D GMᵀ) in f64| / max(1, max |f64|) over G and C."""
    want = (d64 @ d64.T, d64 @ g64.T)
    return max(float((a.double() - b).abs().max())
               / max(1.0, float(b.abs().max())) for a, b in zip(got, want))


def check_stream_stats(P: int, n: int, dt, gen, timed: bool = True,
                       D=None, GM=None, body: str = None,
                       f64: bool = False, reps: int = None) -> dict:
    """``check_cross`` for stream_stats, plus the body the calls took
    (``body``, if given, must be it: ``mma`` for the tensor-core body,
    ``f32`` for cross_f32.cu's, ``cross`` for cross.cuh's; an ``f32`` row
    also as :func:`_f32_body_checks`) and, with ``f64``, the kernel's and
    the plain version's error against an f64 product (the kernel's within
    CROSS_TOL)."""
    import torch
    from repro_torch.kernels import ops, ref, stream
    if D is None:
        D = torch.randn((P, n), generator=gen, device="cuda").to(dt)
        GM = torch.randn((P, n), generator=gen, device="cuda").to(dt)
    took = stream._body(D, GM)
    what = f"stream_stats P={P} n={n} {_dtype_name(D.dtype)}/" \
        f"{_dtype_name(GM.dtype)}"
    need(body is None or took == body,
         f"{what}: takes the {took} body, want {body}")
    cross_call = lambda: stream.stream_stats_cuda(D, GM, body="cross")  # noqa: E731
    stream.reset_body_launches()
    rec = check_cross(
        "stream_stats", (D, GM), {"P": P, "n": n}, dt,
        cross_bound(2 * P, n, P * (P + 1) // 2 + P * P, 2 * P * P, dt),
        timed, library=lambda: (D @ D.T, D @ GM.T),
        extra={"cross_ms": cross_call} if took == "f32" else None, reps=reps)
    tally = stream.body_launches()
    need(tally[took] >= 2 and tally[took] + (tally["cross"] if took == "f32"
                                             else 0) == sum(tally.values()),
         f"{what}: body launches {tally}, want only {took}")
    rec["body"] = took
    if took == "f32":
        _f32_body_checks(rec, what, lambda: ops.stream_stats(
            D, GM, backend="cuda"), cross_call, ref.stream_stats_ref(D, GM),
            timed)
    if timed:
        log(f"{what}: device kernels "
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
                     g=None, reps: int = None) -> dict:
    """``check_cross`` for gram_block (U_a and U_b row blocks of one matrix
    unless given), plus the body the calls took (``body``, if given, must
    be it: ``mma`` for gram_block_mma.cu, ``f32`` for cross_f32.cu,
    ``cross`` for gram_block.cu; an ``f32`` row also as
    :func:`_f32_body_checks`) and, with ``f64``, the kernel's and the plain
    version's error against an f64 product (the kernel's within CROSS_TOL).  ``plain_gate=False``
    (with ``f64``) gates on the f64 product alone: at n = 4 104 a c_a that
    cancels below 1 leaves the plain f32 version itself beyond CROSS_TOL of
    it."""
    import torch
    from repro_torch.kernels import gram, ops, ref
    if ua is None:
        U = torch.randn((Ka + Kb, n), generator=gen, device="cuda").to(dt)
        ua, ub = U[:Ka], U[Ka:]              # row blocks of one matrix
        g = torch.randn((n,), generator=gen, device="cuda").to(dt)
    took = gram._block_body(ua, ub, g)
    what = (f"gram_block Ka={Ka} Kb={Kb} n={n} {_dtype_name(ua.dtype)}/"
            f"{_dtype_name(ub.dtype)}/{_dtype_name(g.dtype)}")
    need(body is None or took == body,
         f"{what}: takes the {took} body, want {body}")
    cross_call = lambda: gram.gram_block_cuda(ua, ub, g, body="cross")  # noqa: E731
    gram.reset_block_body_launches()
    rec = check_cross(
        "gram_block", (ua, ub, g), {"Ka": Ka, "Kb": Kb, "n": n}, dt,
        cross_bound(Ka + Kb + 1, n, Ka * (Kb + 1), Ka * Kb + Ka, dt),
        timed, library=lambda: (ua @ ub.T, ua @ g),
        plain_gate=plain_gate or not f64,
        extra={"cross_ms": cross_call} if took == "f32" else None, reps=reps)
    tally = gram.block_body_launches()
    need(tally[took] >= 2 and tally[took] + (tally["cross"] if took == "f32"
                                             else 0) == sum(tally.values()),
         f"{what}: body launches {tally}, want only {took}")
    rec["body"] = took
    if took == "f32":
        _f32_body_checks(rec, what, lambda: ops.gram_block_and_cross(
            ua, ub, g, backend="cuda"), cross_call,
            ref.gram_block_ref(ua, ub, g), timed)
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
                       plain_gate: bool = True, U=None, R=None,
                       reps: int = None) -> dict:
    """``check_cross`` for sketch, plus the body the calls took (``body``,
    if given, must be it: ``mma`` for sketch_mma.cu, ``realign`` for
    sketch_realign.cu, ``f32`` for cross_f32.cu, ``cross`` for sketch.cu;
    ``f32`` and ``realign`` rows also as :func:`_f32_body_checks`, timed
    beside cross.cuh's body in turn) and, with ``f64``, the kernel's and
    the plain version's error against an f64 product (the kernel's within
    CROSS_TOL).  ``plain_gate=False`` (with ``f64``) gates on the f64
    product alone, as gram_block's sweep does."""
    import torch
    from repro_torch.kernels import ops, ref, sketch
    if U is None:
        U = torch.randn((K, n), generator=gen, device="cuda").to(dt)
        R = torch.randn((m, n), generator=gen, device="cuda").to(dt)
    took = sketch._body(U, R)
    what = (f"sketch K={K} n={n} m={m} {_dtype_name(U.dtype)}/"
            f"{_dtype_name(R.dtype)}")
    need(body is None or took == body,
         f"{what}: takes the {took} body, want {body}")
    beside = took in ("f32", "realign")
    cross_call = lambda: sketch.sketch_apply_cuda(U, R, body="cross")  # noqa: E731
    # a timed aligned row also times the realigning body forced on it, in
    # turn: its landing and loop without a shift to undo
    extra = ({"cross_ms": cross_call} if beside
             else {"realign_ms": lambda: sketch.sketch_apply_cuda(
                 U, R, body="realign")} if took == "mma" and timed else None)
    sketch.reset_body_launches()
    rec = check_cross(
        "sketch", (U, R), {"K": K, "n": n, "m": m}, dt,
        cross_bound(K + m, n, K * m, K * m, dt), timed,
        library=lambda: U @ R.T, plain_gate=plain_gate or not f64,
        extra=extra, reps=reps)
    tally = sketch.body_launches()
    also = {"cross_ms": "cross", "realign_ms": "realign"}
    need(tally[took] >= 2 and tally[took] + sum(
        tally[also[k]] for k in (extra or {})) == sum(tally.values()),
         f"{what}: body launches {tally}, want only {took}")
    rec["body"] = took
    if beside:
        _f32_body_checks(rec, what, lambda: ops.sketch_apply(
            U, R, backend="cuda"), cross_call, ref.sketch_ref(U, R), timed,
            body=took)
    if timed:
        log(f"{what}: device kernels (launches in 3 calls, us per launch) "
            + _kernel_names(rec))
        if took == "mma":
            need(any("sketch_mma_partial<" in k and ", false>" in k
                     for k in rec["device_kernels"])
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


def sketch_realign_bitwise_row(gen) -> dict:
    """The realigning body against sketch_mma.cu bit for bit: for every
    K of SKETCH_MMA_K, s = 1..7, m in SKETCH_REALIGN_M and n in
    SKETCH_REALIGN_N (n % 8 == 0, n = 4 104 with a ragged last tile), U
    viewed 2·s bytes into its buffer and R 2·(3s mod 8) bytes into its own
    take ``realign``, their aligned copies ``mma``, and the two results
    are equal; ``body="realign"`` on the aligned copies too."""
    import torch
    from repro_torch.kernels import sketch
    bf16 = torch.bfloat16
    cases = 0
    sketch.reset_body_launches()
    for K in SKETCH_MMA_K:
        for s in range(1, 8):
            for m in SKETCH_REALIGN_M:
                for n in SKETCH_REALIGN_N:
                    views = []
                    for rows, skip in ((K, s), (m, 3 * s % 8)):
                        buf = torch.randn((rows * n + 8,), generator=gen,
                                          device="cuda").to(bf16)
                        views.append(buf[skip:skip + rows * n].view(rows, n))
                    U, R = views
                    what = f"sketch realign K={K} m={m} n={n} shift {s}"
                    need(sketch._body(U, R) == "realign"
                         and sketch._body(U.clone(), R.clone()) == "mma",
                         f"{what}: bodies")
                    got = sketch.sketch_apply_cuda(U, R)
                    want = sketch.sketch_apply_cuda(U.clone(), R.clone())
                    forced = sketch.sketch_apply_cuda(U.clone(), R.clone(),
                                                      body="realign")
                    need(torch.equal(got, want) and torch.equal(forced, want),
                         f"{what}: differs from sketch_mma.cu bitwise")
                    cases += 1
    tally = sketch.body_launches()
    need(tally == {"mma": cases, "realign": 2 * cases, "f32": 0, "cross": 0},
         f"sketch realign bitwise: body launches {tally}")
    log(f"sketch realign = sketch_mma.cu bitwise on {cases} shifted views "
        f"(K {SKETCH_MMA_K}, s 1..7, m {SKETCH_REALIGN_M}, n "
        f"{SKETCH_REALIGN_N})")
    return {"K": list(SKETCH_MMA_K), "m": list(SKETCH_REALIGN_M),
            "n": list(SKETCH_REALIGN_N), "shifts": list(range(1, 8)),
            "cases": cases, "dtype": "bfloat16", "body": "realign",
            "bitwise_vs_mma": True, "max_abs_err": 0.0, "rel_err": 0.0,
            "tolerance": CROSS_TOL, "bitwise_repeatable": True,
            "gated_on": "plain"}


def stream_stats_out_row(gen) -> dict:
    """The streamed engine's use of ``out=``: the paper path's two leaf
    slabs (P = 100: the 100 x 7 840 weights, the 100 x 10 biases) added in
    turn into running (G, C) from zero, on the f32 body, twice: bitwise
    equal, G exactly symmetric, within CROSS_TOL of the plain versions'
    sum, one cross_f32 kernel a slab."""
    import torch
    from repro_torch.kernels import ref, stream
    P = STREAM_PATH[0][0]
    slabs = [(torch.randn((P, n), generator=gen, device="cuda"),
              torch.randn((P, n), generator=gen, device="cuda"))
             for _, n in STREAM_PATH]

    def run():
        G = torch.zeros((P, P), device="cuda")
        C = torch.zeros((P, P), device="cuda")
        for D, GM in slabs:
            stream.stream_stats_cuda(D, GM, out=(G, C))
        return G, C

    stream.reset_body_launches()
    got, again = run(), run()
    tally = stream.body_launches()
    want = [sum(parts) for parts in zip(*(ref.stream_stats_ref(D, GM)
                                          for D, GM in slabs))]
    torch.cuda.synchronize()
    what = f"stream_stats out= P={P} slabs {[n for _, n in STREAM_PATH]}"
    need(tally == {"mma": 0, "f32": 2 * len(slabs), "cross": 0},
         f"{what}: body launches {tally}")
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    need(bitwise, f"{what}: two runs differ bitwise")
    need(torch.equal(got[0], got[0].T), f"{what}: G is not symmetric")
    err = max(_max_err(a, b) / _scale(b) for a, b in zip(got, want))
    need(err <= CROSS_TOL, f"{what}: relative err {err:.3e} > {CROSS_TOL}")
    kern = {k: c for k, (c, _) in device_kernel_means(run, 1).items()
            if "cross" in k or "stream_stats" in k}
    need(all("cross_f32" in k for k in kern)
         and sum(kern.values()) == len(slabs),
         f"{what}: want one cross_f32 kernel a slab, got {kern}")
    log(f"{what}: added into running (G, C), relative err {err:.3e} "
        f"(tolerance {CROSS_TOL}), bitwise over two runs, one kernel a slab")
    return {"P": P, "n": sum(n for _, n in STREAM_PATH), "out": True,
            "dtype": "float32", "body": "f32",
            "max_abs_err": max(_max_err(a, b) for a, b in zip(got, want)),
            "rel_err": err, "tolerance": CROSS_TOL,
            "bitwise_repeatable": bitwise, "gated_on": "plain"}


def sketch_records(gen) -> list:
    """sketch's rows of the kernels phase: every body at its shapes."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    out = []
    for K, n, m in SKETCH_APPLY_BENCH:
        out.append(dict(check_sketch_apply(K, n, m, f32, gen, body="f32"),
                        set="bench"))
    for K, n, m in SKETCH_APPLY_RAGGED:
        for dt in (f32, bf16):
            body = ("f32" if dt == f32 else "cross" if K > 64
                    else "mma" if n % 8 == 0 else "realign")
            out.append(dict(
                check_sketch_apply(K, n, m, dt, gen, timed=False, body=body),
                set="ragged"))
    # the tensor-core body at every instance's and slice's edges, U and R
    # row blocks of one matrix, held to an f64 product (the plain version's
    # distance recorded); row blocks at an odd n and a bf16 U starting 2
    # bytes into its buffer take the realigning body, a mixed f32/bf16 pair
    # cross.cuh's; the realigning body on shifted views equals sketch_mma.cu
    for K in SKETCH_MMA_K:
        for m in SKETCH_MMA_M:
            for n in SKETCH_MMA_N:
                M = torch.randn((K + m, n), generator=gen,
                                device="cuda").to(bf16)
                out.append(dict(check_sketch_apply(
                    K, n, m, bf16, gen, timed=False, body="mma", f64=True,
                    plain_gate=False, U=M[:K], R=M[K:]), set="ragged"))
    M = torch.randn((8 + 129, 1001), generator=gen, device="cuda").to(bf16)
    shifted = torch.randn((8 * 1024 + 1,), generator=gen,
                          device="cuda").to(bf16)[1:].view(8, 1024)
    r1024 = torch.randn((129, 1024), generator=gen, device="cuda").to(bf16)
    for U, R, body in ((M[:8], M[8:], "realign"), (shifted, r1024, "realign"),
                       (shifted.float(), r1024, "cross")):
        out.append(dict(check_sketch_apply(
            8, U.shape[1], 129, U.dtype, gen, timed=False, body=body, U=U,
            R=R, f64=body == "realign"), set="ragged"))
    out.append(dict(sketch_realign_bitwise_row(gen), set="ragged"))
    # the model rows: bf16 at an odd n on the realigning body first (the
    # kernels line's row), f32 on cross_f32.cu, both beside cross.cuh's body
    # in turn and held to an f64 product; then the aligned twins on
    # sketch_mma.cu
    for K, n, m in SKETCH_APPLY_MODEL:
        for dt in (bf16, f32):
            out.append(dict(check_sketch_apply(
                K, n, m, dt, gen, body="realign" if dt == bf16 else "f32",
                f64=True), set="model"))
            torch.cuda.empty_cache()
    for K, n, m in SKETCH_REALIGN_MODEL:
        out.append(dict(check_sketch_apply(
            K, n, m, bf16, gen, body="realign", f64=True), set="model"))
        torch.cuda.empty_cache()
    for K, n, m in SKETCH_F32_TWIN:
        out.append(dict(check_sketch_apply(
            K, n, m, f32, gen, body="f32", f64=True), set="model"))
        torch.cuda.empty_cache()
    for K, n, m in SKETCH_MMA_MODEL:
        out.append(dict(check_sketch_apply(
            K, n, m, bf16, gen, body="mma", f64=True), set="model"))
        torch.cuda.empty_cache()
    return out


def cross_phase_records(gen) -> dict:
    """The three cross-product kernels at their shapes (kernels phase)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    out = {"stream_stats": [], "gram_block": [], "sketch": []}
    # every f32 row takes cross_f32.cu (one kernel a call, bitwise twice);
    # the timed ones beside cross.cuh's body in turn on the same inputs
    for P, n in STREAM_PATH:
        out["stream_stats"].append(dict(
            check_stream_stats(P, n, f32, gen, body="f32"), set="path"))
    for P, n in STREAM_RAGGED:
        for dt in (f32, bf16):
            out["stream_stats"].append(dict(
                check_stream_stats(P, n, dt, gen, timed=False,
                                   body="f32" if dt == f32 else "cross"),
                set="ragged"))
    # slab views of a stacked leaf, and a strided column window (row stride
    # 400): taken as they lie
    leaf = torch.randn((3, 43, 7), generator=gen, device="cuda")
    gleaf = torch.randn((3, 43, 7), generator=gen, device="cuda")
    wide = torch.randn((5, 400), generator=gen, device="cuda")
    for D, GM in ((leaf.reshape(3, -1), gleaf.reshape(3, -1)),
                  (wide[:, 5:305], wide[:, 90:390])):
        out["stream_stats"].append(dict(check_stream_stats(
            D.shape[0], D.shape[1], f32, gen, timed=False, D=D, GM=GM,
            body="f32"), set="ragged"))
    out["stream_stats"].append(dict(stream_stats_out_row(gen), set="ragged"))
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
    # the window a split pass reads (one of 8 ranks): the 2^20 columns at
    # 3 * 2^20 of a 2^23-column bf16 embedding slab, row stride 2^23
    P, n, wide = 16, 1 << 20, 1 << 23
    D = torch.randn((P, wide), generator=gen, device="cuda").to(bf16)
    GM = torch.randn((P, wide), generator=gen, device="cuda").to(bf16)
    out["stream_stats"].append(dict(check_stream_stats(
        P, n, bf16, gen, D=D[:, 3 * n:4 * n], GM=GM[:, 3 * n:4 * n],
        body="mma", f64=True), set="window", row_stride=wide))
    del D, GM
    torch.cuda.empty_cache()
    for Ka, Kb, n in GRAM_BLOCK_PATH:
        ua = torch.randn((Ka, n), generator=gen, device="cuda")
        ub = torch.randn((Kb, n), generator=gen, device="cuda")
        g = torch.randn((n,), generator=gen, device="cuda")
        out["gram_block"].append(dict(
            check_gram_block(Ka, Kb, n, f32, gen, body="f32", ua=ua, ub=ub,
                             g=g), set="path"))
    for Ka, Kb, n in GRAM_BLOCK_BENCH:
        out["gram_block"].append(dict(
            check_gram_block(Ka, Kb, n, f32, gen, body="f32"), set="bench"))
    for Ka, Kb, n in GRAM_BLOCK_RAGGED:
        for dt in (f32, bf16):
            out["gram_block"].append(dict(
                check_gram_block(Ka, Kb, n, dt, gen, timed=False,
                                 body="f32" if dt == f32 else "cross"),
                set="ragged"))
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
    # the model rows: bf16 on the tensor cores, f32 on cross_f32.cu, both
    # held to an f64 product
    for Ka, Kb, n, dts in GRAM_BLOCK_MODEL:
        for dt in (getattr(torch, name) for name in dts):
            out["gram_block"].append(dict(check_gram_block(
                Ka, Kb, n, dt, gen, body="mma" if dt == bf16 else "f32",
                f64=True), set="model"))
            torch.cuda.empty_cache()
    out["sketch"] = sketch_records(gen)
    # cross.cuh's bf16 calls that had no timed row: gram_block at an odd n,
    # stream_stats at P > 32, sketch at K > 64
    Ka, Kb, n = GRAM_BLOCK_CROSS_TIMED
    out["gram_block"].append(dict(check_gram_block(
        Ka, Kb, n, bf16, gen, body="cross", f64=True, reps=TIMED_ONCE_REPS),
        set="model"))
    torch.cuda.empty_cache()
    P, n = STREAM_CROSS_TIMED
    out["stream_stats"].append(dict(check_stream_stats(
        P, n, bf16, gen, body="cross", f64=True, reps=TIMED_ONCE_REPS),
        set="model"))
    torch.cuda.empty_cache()
    K, n, m = SKETCH_CROSS_TIMED
    out["sketch"].append(dict(check_sketch_apply(
        K, n, m, bf16, gen, body="cross", f64=True, reps=TIMED_ONCE_REPS),
        set="model"))
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


def decode_plans(q, k, window=None, softcap=None) -> dict:
    """``{body: [splits, rows]}`` of the two tensor-core bodies for a bf16
    call (the cluster body's plan and the two-launch body's)."""
    from repro_torch.kernels import decode_attn
    B, S, KV, hd = k.shape
    key = (B, S, KV, q.shape[2], hd, True, True, k.stride(), k.stride(),
           window, softcap, k.device.index)
    return {body: [p.splits, p.rows] for body, p in (
        (body, decode_attn._plan(body, *key)) for body in ("cluster", "mma"))}


def ctypes_call_us(reps: int = 20000) -> dict:
    """Host µs of the ctypes call alone, each refused by the library at
    once (hd 0): the two-launch body's 27 arguments against the cluster
    body's 7 (its per-plan constants in one ClusterPlan by pointer); median
    of 5 rounds taken in turn."""
    import ctypes
    from repro_torch.kernels import _build, decode_attn
    lib = _build.load_library()
    plan = decode_attn.ClusterPlan()
    addr = ctypes.addressof(plan)
    calls = {
        "args_27": lambda: lib.flash_decode_mma_launch(
            0, 0, 0, 0, 0, 0, 0, 0, 4, 256, 8, 5, 0, 8, 8, 8, 8, 8, 8, 4, 64,
            0.088, 0, 0, 0, 0.0, 0),
        "plan_by_pointer_7": lambda: lib.flash_decode_cluster_launch(
            addr, 0, 0, 0, 0, 0, 0)}
    runs = {name: [] for name in calls}
    for _ in range(5):
        for name, fn in calls.items():
            need(fn() != 0, f"ctypes probe: {name} was not refused")
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            runs[name].append((time.perf_counter() - t0) / reps * 1e6)
    return {name: statistics.median(r) for name, r in runs.items()}


def check_decode(B: int, S: int, KV: int, G: int, hd: int, dt, gen,
                 lengths=None, window=None, softcap=None, timed=True,
                 stacked=False) -> dict:
    """flash_decode against its plain version on the card (o and lse within
    DECODE_TOL, two calls bitwise equal, both on the body the inputs route
    to: ``cluster``, decode_attn_cluster.cu, for bf16 q, k and v at hd 64
    or 128, ``cuda_core``, decode_attn.cu, otherwise); a cluster row also
    runs the two-launch body (``mma``, decode_attn_mma.cu) and the
    CUDA-core body on the same inputs, each within DECODE_TOL, the first
    bitwise equal to the cluster body where the two split plans agree.
    With ``timed``: CUDA-event times of the kernel, the plain version and
    SDPA on the same rows, the device µs of the call's kernels from
    ``torch.profiler`` (a cluster call must be the one ``decode_cluster``
    kernel) and the host µs to issue a call; a cluster row times the three
    bodies in turn (CUDA-core, mma, cluster, cluster, mma, CUDA-core), by
    events, device and host."""
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
    body = "cluster" if decode_attn._mma_eligible(q, k, v) else "cuda_core"
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
    others = ("mma", "cuda_core") if body == "cluster" else ()
    for other in others:
        res = decode_attn.flash_decode_cuda(q, k, v, ln, body=other, **kw)
        rec[f"{other}_rel_err"] = max(_max_err(a, b) / _scale(b)
                                      for a, b in zip(res, want))
        need(rec[f"{other}_rel_err"] <= DECODE_TOL,
             f"{what}: the {other} body {rec[f'{other}_rel_err']:.3e} off "
             "plain")
        if other == "mma":
            rec["plans"] = decode_plans(q, k, window, softcap)
            rec["mma_bitwise"] = all(torch.equal(a, b)
                                     for a, b in zip(got, res))
            need(rec["mma_bitwise"] or rec["plans"]["cluster"]
                 != rec["plans"]["mma"], f"{what}: the cluster and mma "
                 f"bodies differ on one split plan {rec['plans']}")
    if timed:
        b_rec = decode_bound(B, S, KV, G, hd, dt, lengths, window)
        reps = reps_for(b_rec["bytes"])
        kernel = lambda: ops.flash_decode(q, k, v, ln, backend="cuda", **kw)  # noqa: E731
        if others:
            fns = {"cluster": kernel}
            for other in others:
                fns[other] = (lambda other=other: decode_attn.flash_decode_cuda(
                    q, k, v, ln, body=other, **kw))
            order = ("cuda_core", "mma", "cluster", "cluster", "mma",
                     "cuda_core")
            runs = [time_ms(fns[name], reps) for name in order]
            for name in fns:
                mine = [t for t, n in zip(runs, order) if n == name]
                pre = "" if name == "cluster" else f"{name}_"
                rec[f"{pre}ms_runs"] = mine
                rec[f"{pre}ms"] = statistics.median(mine)
            for other in others:
                kernels = device_kernel_means(fns[other])
                rec[f"{other}_device_kernels"] = kernels
                rec[f"{other}_device_ms"] = sum(ms for _, ms in
                                                kernels.values())
            rec["host_ms_in_turn"] = host_ms_in_turn(fns, reps)
        else:
            rec["ms"] = time_ms(kernel, reps)
        rec["plain_ms"] = time_ms(
            lambda: ops.flash_decode(q, k, v, ln, backend="torch", **kw), reps)
        kernels = device_kernel_means(kernel)
        rec["device_kernels"] = kernels
        rec["device_ms"] = sum(ms for _, ms in kernels.values())
        rec["device_kernels_per_call"] = len(kernels)
        rec["host_ms"] = (rec["host_ms_in_turn"]["cluster"] if others
                          else host_ms(kernel, reps))
        if body == "cluster":
            need(len(kernels) == 1 and "decode_cluster" in next(iter(kernels))
                 and not any("merge" in n for n in kernels),
                 f"{what}: device kernels {list(kernels)}, want the one "
                 "decode_cluster kernel a call")
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
        del kh, vh
        rec["library"] = ("scaled_dot_product_attention(enable_gqa, bool "
                          "length mask): o only, no lse; transpose not timed")
        rec.update(b_rec)
        if others:
            log(f"{what} window={window}: plans {rec['plans']}, cluster = "
                f"mma bitwise {rec['mma_bitwise']}; by events cluster "
                f"{' / '.join(f'{t * 1e3:.1f}' for t in rec['ms_runs'])} us, "
                f"mma {' / '.join(f'{t * 1e3:.1f}' for t in rec['mma_ms_runs'])}"
                f" us, CUDA-core "
                f"{' / '.join(f'{t * 1e3:.1f}' for t in rec['cuda_core_ms_runs'])}"
                f" us (in turn: CUDA-core, mma, cluster, cluster, mma, "
                f"CUDA-core); host us to issue, in turn: "
                + ", ".join(f"{n} {t * 1e3:.1f}"
                            for n, t in rec["host_ms_in_turn"].items())
                + "; device kernels (launches in 3 calls, us per launch) "
                "cluster: " + _kernel_names(rec) + "; mma: "
                + _kernel_names({"device_kernels": rec["mma_device_kernels"]})
                + "; CUDA-core: "
                + _kernel_names({"device_kernels":
                                 rec["cuda_core_device_kernels"]})
                + f"; SDPA {_fmt_us(rec['library_ms']).strip()} us, device "
                f"{rec.get('library_device_ms', 0) * 1e3:.1f} us; bound "
                f"{rec['bound_ms'] * 1e3:.1f} us")
        else:
            log(f"{what} window={window}: device kernels (launches in 3 "
                f"calls, us per launch) " + _kernel_names(rec))
    return rec


def check_decode_blocks(gen) -> dict:
    """flash_decode on ``DECODE_BLOCKS``' 16 seq blocks, as the placed
    decode step calls it on each rank's block: each body (``cluster``,
    ``mma``, ``cuda_core``) launched on every block with local lengths
    (position + 1 - the block's first row), the partials merged by
    ``ops.lse_merge``.
    Gates, on lengths that leave later blocks empty, with and without a
    window that crosses block edges, and on full lengths: no NaN, a row
    with no live key in its block o = 0 and lse <= -1e30, the merge within
    DECODE_TOL of one whole-cache call of the same body and of the plain
    version.  Times (full lengths, CUDA events): the 16 calls plus the
    merge, the whole call and one rank's block alone, each body in turn
    (CUDA-core, mma, cluster, cluster, mma, CUDA-core), with the host µs to
    issue them, the plain version on the same blocks plus the merge, SDPA
    on the whole cache, beside the whole call's byte bound."""
    import torch
    from repro_torch.kernels import decode_attn, ops
    D = DECODE_BLOCKS
    B, S, KV, G, hd, n = D["B"], D["S"], D["KV"], D["G"], D["hd"], D["blocks"]
    rows = S // n
    bf16 = torch.bfloat16
    q = torch.randn((B, KV, G, hd), generator=gen, device="cuda").to(bf16)
    k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(bf16)
    v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(bf16)
    blocks = [(k[:, j * rows:(j + 1) * rows], v[:, j * rows:(j + 1) * rows])
              for j in range(n)]
    starts = [j * rows for j in range(n)]
    what = f"flash_decode on {n} blocks of {rows} rows B={B} S={S}"

    def on_blocks(ln, window, body, backend="cuda"):
        parts = []
        for (kb, vb), j0 in zip(blocks, starts):
            local = ln - j0
            if backend == "cuda":
                parts.append(decode_attn.flash_decode_cuda(
                    q, kb, vb, local, window=window, body=body))
            else:
                parts.append(ops.flash_decode(q, kb, vb, local, window=window,
                                              backend="torch"))
        return parts

    def merged(parts):
        return ops.lse_merge(torch.stack([o for o, _ in parts]),
                             torch.stack([lse for _, lse in parts]))

    full = [S] * B
    gates, worst = [], 0.0
    for lengths, window in ((D["lengths"], None), (D["lengths"], D["window"]),
                            (full, None)):
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        want = ops.flash_decode(q, k, v, ln, window=window, backend="torch")
        for body in decode_attn.BODIES:
            parts = on_blocks(ln, window, body)
            empty = 0
            for (o, lse), j0 in zip(parts, starts):
                need(not (torch.isnan(o).any() or torch.isnan(lse).any()),
                     f"{what} {body} window={window}: NaN in a block")
                lo = (ln - window).clamp(min=0) if window else 0 * ln
                dead = (ln - j0 <= 0) | (lo >= j0 + rows)
                empty += int(dead.sum())
                need(bool((o[dead] == 0).all() and (lse[dead] <= -1e30).all()),
                     f"{what} {body} window={window}: a row with no live key "
                     "is not o = 0, lse <= -1e30")
            got = merged(parts)
            whole = decode_attn.flash_decode_cuda(q, k, v, ln, window=window,
                                                  body=body)
            err_whole = max(_max_err(a, b) / _scale(b)
                            for a, b in zip(got, whole))
            err_plain = max(_max_err(a, b) / _scale(b)
                            for a, b in zip(got, want))
            need(err_whole <= DECODE_TOL and err_plain <= DECODE_TOL,
                 f"{what} {body} window={window}: merged {err_whole:.3e} off "
                 f"the whole call, {err_plain:.3e} off plain > {DECODE_TOL}")
            worst = max(worst, err_plain)
            gates.append({"body": body, "window": window,
                          "lengths": lengths if lengths is not full
                          else f"all {S}", "empty_block_rows": empty,
                          "rel_err_vs_whole": err_whole,
                          "rel_err_vs_plain": err_plain,
                          "max_abs_err": max(_max_err(a, b) for a, b in
                                             zip(got, want))})
    torch.cuda.synchronize()
    ln = torch.tensor(full, dtype=torch.int32, device="cuda")
    b_rec = decode_bound(B, S, KV, G, hd, bf16, full, None)
    reps = 20
    bodies = decode_attn.BODIES
    fns = {body: (lambda body=body: merged(on_blocks(ln, None, body)))
           for body in bodies}
    whole = {body: (lambda body=body: decode_attn.flash_decode_cuda(
        q, k, v, ln, body=body)) for body in bodies}
    # one rank's call: block 1 of the 16, every row live
    local = ln - starts[1]
    one = {body: (lambda body=body: decode_attn.flash_decode_cuda(
        q, *blocks[1], local, body=body)) for body in bodies}
    order = ("cuda_core", "mma", "cluster", "cluster", "mma", "cuda_core")
    runs = {}
    for what_, group in (("blocks", fns), ("whole", whole), ("one", one)):
        times = [time_ms(group[body], reps) for body in order]
        runs[what_] = {body: [t for t, b in zip(times, order) if b == body]
                       for body in bodies}
    med = {what_: {body: statistics.median(r) for body, r in by.items()}
           for what_, by in runs.items()}
    one_bound = decode_bound(B, rows, KV, G, hd, bf16, [rows] * B, None)
    plain_ms = time_ms(lambda: merged(on_blocks(ln, None, None, "torch")), 3)
    qh = q.reshape(B, KV * G, 1, hd)
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    import torch.nn.functional as F
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, enable_gqa=True), reps)
    del kh, vh
    kernels = device_kernel_means(fns["cluster"])
    host = host_ms_in_turn(fns, reps)
    one_host = host_ms_in_turn(one, reps)
    rec = {"set": "blocks", "B": B, "S": S, "KV": KV, "G": G, "hd": hd,
           "dtype": "bfloat16", "window": None, "lengths": f"all {S}",
           "blocks": n, "rows_per_block": rows, "body": "cluster",
           "ms": med["blocks"]["cluster"], "ms_runs": runs["blocks"]["cluster"],
           "mma_ms": med["blocks"]["mma"],
           "cuda_core_ms": med["blocks"]["cuda_core"],
           "whole_ms": med["whole"]["cluster"],
           "mma_whole_ms": med["whole"]["mma"],
           "cuda_core_whole_ms": med["whole"]["cuda_core"],
           "block_ms": med["one"]["cluster"],
           "mma_block_ms": med["one"]["mma"],
           "cuda_core_block_ms": med["one"]["cuda_core"],
           "runs_in_turn": runs,
           "block_bound_ms": one_bound["bound_ms"],
           "block_device_kernels": device_kernel_means(one["cluster"]),
           "mma_block_device_kernels": device_kernel_means(one["mma"]),
           "block_host_ms_in_turn": one_host,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "scaled_dot_product_attention(enable_gqa) on the "
                      "whole cache: o only; transpose not timed",
           "device_kernels": kernels,
           "device_ms": sum(ms for _, ms in kernels.values()),
           "device_kernels_per_call": len(kernels),
           "host_ms": host["cluster"], "host_ms_in_turn": host,
           "gates": gates, "rel_err": worst, "tolerance": DECODE_TOL,
           "max_abs_err": max(g["max_abs_err"] for g in gates), **b_rec}

    def us(what_, body):
        return " / ".join(f"{t * 1e3:.1f}" for t in runs[what_][body])
    log(f"{what}: {n} calls + lse_merge, in turn (CUDA-core, mma, cluster, "
        f"cluster, mma, CUDA-core): cluster {us('blocks', 'cluster')} us, mma "
        f"{us('blocks', 'mma')}, CUDA-core {us('blocks', 'cuda_core')}; one "
        f"whole-cache call cluster {us('whole', 'cluster')}, mma "
        f"{us('whole', 'mma')}, CUDA-core {us('whole', 'cuda_core')}; bound "
        f"{b_rec['bound_ms'] * 1e3:.1f} us; one rank's block alone cluster "
        f"{us('one', 'cluster')}, mma {us('one', 'mma')}, CUDA-core "
        f"{us('one', 'cuda_core')}, its bound "
        f"{one_bound['bound_ms'] * 1e3:.1f} us (device cluster "
        + _kernel_names({"device_kernels": rec["block_device_kernels"]})
        + "; mma "
        + _kernel_names({"device_kernels": rec["mma_block_device_kernels"]})
        + "; host to issue, in turn: "
        + ", ".join(f"{b} {t * 1e3:.1f}" for b, t in one_host.items())
        + f"); host to issue the 16 calls + merge: "
        + ", ".join(f"{b} {t * 1e3:.1f}" for b, t in host.items())
        + f"; plain on the blocks {plain_ms * 1e3:.1f} us, SDPA whole "
        f"{library_ms * 1e3:.1f} us; device kernels (launches in 3 calls, "
        f"us per launch) " + _kernel_names(rec)
        + "; gates (rel err merged vs whole, vs plain): "
        + "; ".join(f"{g['body']} window={g['window']} "
                    f"{g['rel_err_vs_whole']:.2e}/{g['rel_err_vs_plain']:.2e}"
                    f" ({g['empty_block_rows']} empty block rows)"
                    for g in gates))
    return rec


def decode_phase_records(gen) -> list:
    """flash_decode at the serve path's shape, the MoE serve path's (KV 16,
    G 1), the placed serve part's (qwen3-14b's and zamba2-1.2b's heads on
    a 32 768-row cache), model shapes, few heads on a 131 072-row cache
    (``DECODE_LONG``: the cluster body's cap binds), and ragged, strided,
    windowed, soft-capped and f32 shapes (kernels phase); the bf16 rows at
    hd 64 and 128 take the cluster body, the rest the CUDA-core body."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    B, S, KV, G, hd, window, lengths = DECODE_PATH
    recs = [dict(check_decode(B, S, KV, G, hd, bf16, gen, lengths, window),
                 set="path", ctypes_call_us=ctypes_call_us())]
    log("flash_decode host path: the ctypes call alone, us (refused at once "
        "by the library; median of 5 rounds in turn): " + ", ".join(
            f"{k} {v:.3f}" for k, v in recs[0]["ctypes_call_us"].items()))
    B, S, KV, G, hd, window, lengths = DECODE_MOE
    recs.append(dict(check_decode(B, S, KV, G, hd, bf16, gen, lengths,
                                  window), set="moe"))
    for B, S, KV, G, hd, window, lengths in DECODE_PLACED:
        recs.append(dict(check_decode(B, S, KV, G, hd, bf16, gen, lengths,
                                      window), set="placed"))
        torch.cuda.empty_cache()
    for B, S, KV, G, hd, window, lengths in DECODE_MODEL:
        recs.append(dict(check_decode(B, S, KV, G, hd, bf16, gen, lengths,
                                      window), set="model"))
        torch.cuda.empty_cache()
    B, S, KV, G, hd, window, lengths = DECODE_LONG
    recs.append(dict(check_decode(B, S, KV, G, hd, bf16, gen, lengths,
                                  window), set="long"))
    torch.cuda.empty_cache()
    recs.append(check_decode_blocks(gen))
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
            dict(f64=True) if name == "combine" else {})),
            set="path"))
        for Kr, nr in RAGGED:
            for dt in (f32, bf16):
                # gram's bf16 rows (n = 1, 130, 7 850) take the realigning
                # body, held to an f64 product too
                kw = (dict(body="f32" if dt == f32 else "realign",
                           f64=dt == bf16) if name == "gram" else {})
                out[name].append(dict(check(Kr, nr, dt, gen, timed=False,
                                            **kw), set="ragged"))
        for Km, nm in MODEL:
            for dt in (f32, bf16):
                # gram's bf16 rows take the tensor-core body at n = 2^24
                # and the realigning one at n = 2^20 + 3 (gram.cu timed
                # in turn), its f32 rows the f32 body, all held to an f64
                # product; combine's f32 rows are held to an f64 sum too
                kw = (dict(body="f32" if dt == f32 else "mma" if nm % 8 == 0
                           else "realign", f64=True)
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
    # the aligned twins of the realigning MODEL rows, the realigning body
    # forced on the same rows in turn (bitwise equal to gram_mma.cu), then
    # the realigning rows' speed targets
    for Km in sorted({Km for Km, _ in MODEL}):
        out["gram"].append(dict(check_gram(Km, GRAM_TWIN_N, bf16, gen,
                                           body="mma", f64=True,
                                           realign_in_turn=True),
                                set="model"))
        torch.cuda.empty_cache()
    gram_realign_targets(out["gram"])
    for Kw, nw in GRAM_GATEWAY + GRAM_WIDE:
        for dt in (f32, bf16):
            mma = dt == bf16 and nw % 8 == 0
            path = nw == N_PATH
            out["gram"].append(dict(
                check_gram(Kw, nw, dt, gen, f64=dt == bf16 or not path,
                           body="mma" if mma else "f32" if dt == f32
                           else "realign"),
                set="path" if path else "model"))
            torch.cuda.empty_cache()
    # the f32 body at the train path's scopes: olmoe-1b-7b's lm_head +
    # final_norm (K = 1) and one placed rank's columns at K = 16 and 32
    for Kt, nt in GRAM_TRAIN_SCOPES:
        out["gram"].append(dict(check_gram(Kt, nt, f32, gen, body="f32",
                                           f64=True), set="model"))
        torch.cuda.empty_cache()
    # gram's tensor-core body at every tile count with ragged last tiles
    # (against f64 too), the realigning body bitwise equal to it on shifted
    # views (and as resident), and the calls around them: bf16 at
    # n % 8 != 0 and a bf16 U starting 2 bytes into its buffer take the
    # realigning body, bf16 K = 128 and an f32 U with a bf16 g gram.cu's
    for Km in GRAM_MMA_K:
        for nm in GRAM_MMA_N:
            out["gram"].append(dict(check_gram(Km, nm, bf16, gen, timed=False,
                                               body="mma", f64=True),
                                    set="ragged"))
    out["gram"].append(dict(gram_realign_bitwise_row(gen), set="ragged"))
    shifted = torch.randn((10 * 1024 + 1,), generator=gen,
                          device="cuda").to(bf16)[1:].view(10, 1024)
    g1024 = torch.randn((1024,), generator=gen, device="cuda").to(bf16)
    for Km, nm, U_, g_, body in ((128, 1024, None, None, "cuda_core"),
                                 (10, 1001, None, None, "realign"),
                                 (10, 1024, shifted, g1024, "realign"),
                                 (10, 1024, shifted.float(), g1024,
                                  "cuda_core")):
        out["gram"].append(dict(check_gram(Km, nm, bf16, gen, timed=False,
                                           body=body, U=U_, g=g_,
                                           f64=body == "realign"),
                                set="ragged"))
    # gram.cu's bodies with no timed row before: bf16 at K = 128, and a
    # bf16 U with an f32 g
    for Kc, nc, g_name in GRAM_CUDA_CORE_TIMED:
        U_ = torch.randn((Kc, nc), generator=gen, device="cuda").to(bf16)
        g_ = torch.randn((nc,), generator=gen,
                         device="cuda").to(getattr(torch, g_name))
        out["gram"].append(dict(check_gram(Kc, nc, bf16, gen,
                                           body="cuda_core", U=U_, g=g_,
                                           reps=TIMED_ONCE_REPS),
                                set="model"))
        del U_, g_
        torch.cuda.empty_cache()

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
    out["gram"].append(dict(check_gram(5, N_PATH, f32, gen, body="f32"),
                            set="async"))
    for n_leaf in (784 * 10, 10):
        out["combine"].append(dict(check_combine(5, n_leaf, f32, gen),
                                   set="async"))
    # gram at the fleet path's shapes (n = 68 f32: the f32 body, one block
    # a slice, no scratch), a gateway's 500 members and the cloud over 200
    # and 2 000 gateways, with the host time to issue a call beside the
    # event times
    for Kf, nf in GRAM_FLEET:
        out["gram"].append(dict(check_gram(Kf, nf, f32, gen, body="f32"),
                                set="fleet"))
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
                "gram" if "gram_partial" in key or "gram_f32" in key
                else None)
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


def streamed_runs(ds) -> tuple:
    """The streamed phase's two tiers of 4 gateways over ``ds``'s fleet and
    its three configurations ``(name, HierConfig, compress ops)``."""
    from repro_torch.compress import CompressConfig
    from repro_torch.edge import bimodal_fleet
    from repro_torch.hier import HierConfig, two_tier_topology
    fleet = bimodal_fleet(ds.num_devices, slowdown=10.0, dropout_slow=0.05,
                          seed=0)
    sketch = dict(aggregator="hier_contextual_sketch", **HIER_CFG)
    return two_tier_topology(fleet, 4), [
        ("two_tier", HierConfig(**HIER_CFG), ()),
        ("topk", HierConfig(compress=CompressConfig(
            scheme="topk", ratio=3.4, u_frac=0.75), **sketch), ("topk",)),
        ("sign_sketch", HierConfig(compress=CompressConfig(
            scheme="sign_sketch", ratio=4.0), **sketch),
         ("sign_sketch", "sign_sketch_adjoint")),
    ]


def streamed_phase(ds, params) -> dict:
    """The two-tier paper-logreg runs on the streamed engine beside the
    fused engine, on the same mini-batches; returns the streamed runs'
    launch counts, summed."""
    import numpy as np
    import torch
    from repro_torch.fl import run_hier_simulation
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

    tiers, runs = streamed_runs(ds)
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
                # the paper path's P = 100 f32 slabs take the f32 body
                bodies = stream.body_launches()
                need(bodies == {"mma": 0, "f32": counts["stream_stats/cuda"],
                                "cross": 0},
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


def streamed_mesh_phase(smi_line: str, ds, params,
                        device: str = "cuda") -> dict:
    """The streamed phase's mesh part.  (a) One round of each of the
    streamed phase's configurations on the engine's mesh path — a one-rank
    NCCL group (a ``FileStore`` in a temporary directory; gloo on the CPU)
    and a ('data',) mesh of ranks: each slab's window (here the whole slab),
    the all-reduce of the stacked (G, C), the windows' gathers — against
    the same round without a mesh on the same mini-batches: the new
    parameters bitwise equal, the same launches, each counted from 0 just
    before the mesh round.  (b) :func:`streamed_split_round`.  Returns the
    mesh rounds' launch counts, summed, and the records."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core.flatten import tree_to_vector
    from repro_torch.fl import run_hier_simulation
    from repro_torch.kernels import launch_counts, reset_launch_counts, stream
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.logistic import logistic_apply, logistic_loss
    tiers, runs = streamed_runs(ds)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    total, rounds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        try:
            mesh = make_mesh((1,), ("data",))
            for name, cfg, compress_ops in runs:
                got = {}
                for tag, m in (("mesh", mesh), ("no mesh", None)):
                    batches = torch.Generator(device=device)
                    batches.manual_seed(42)
                    new = []
                    torch.cuda.synchronize()
                    reset_launch_counts()
                    stream.reset_body_launches()
                    run_hier_simulation(
                        f"{name}_{tag}", logistic_loss, logistic_apply,
                        params, ds, cfg, tiers, 1, selection_seed=42,
                        device=device, engine="streamed", mesh=m,
                        batch_generator=batches,
                        publish_fn=lambda t, p: new.append(
                            tree_to_vector(p).clone()))
                    torch.cuda.synchronize()
                    got[tag] = (new, launch_counts())
                    # the P = 100 f32 slabs (a rank's windows) on f32
                    bodies = stream.body_launches()
                    need(torch.device(device).type != "cuda" or bodies == {
                        "mma": 0, "f32": got[tag][1]["stream_stats/cuda"],
                        "cross": 0},
                         f"streamed mesh {name} ({tag}): stream_stats "
                         f"bodies {bodies}")
                new, counts = got["mesh"]
                need(len(new) == 1 == len(got["no mesh"][0]),
                     f"streamed mesh {name}: a round was skipped")
                launched = {k: v for k, v in counts.items() if v}
                for op in ("stream_stats", "combine") + compress_ops:
                    need(counts[f"{op}/cuda"] > 0, f"streamed mesh {name}: "
                         f"no {op}/cuda launch: {launched}")
                plain = {k: v for k, v in launched.items()
                         if k.endswith("/torch")}
                need(not plain, f"streamed mesh {name}: plain versions ran "
                     f"on the path: {plain}")
                need(counts == got["no mesh"][1], f"streamed mesh {name}: "
                     f"launches {launched} vs without a mesh "
                     f"{ {k: v for k, v in got['no mesh'][1].items() if v} }")
                equal = torch.equal(new[0], got["no mesh"][0][0])
                gap = _max_err(new[0], got["no mesh"][0][0])
                log(f"streamed mesh {name}: one round on a one-rank {backend} "
                    f"group, mesh {dict(mesh.shape)}, against the round "
                    f"without a mesh: new params bitwise equal {equal} (max "
                    f"|diff| {gap:.3e}); launches {launched}")
                need(equal, f"streamed mesh {name}: the mesh round's params "
                     f"differ from the mesh-free round's by {gap:.3e}")
                rounds[name] = {"bitwise_equal": equal, "launches": launched}
                for key, v in counts.items():
                    total[key] = total.get(key, 0) + v
        finally:
            dist.destroy_process_group()
    need(not dist.is_initialized(), "streamed mesh: the process group was "
         "not destroyed")
    return {"counts": total, "backend": backend, "rounds": rounds,
            "split": streamed_split_round(smi_line, device)}


class _PlaceDeviceMesh:
    """The ``DeviceMesh`` of one place of a mesh whose places one process
    drives in turn: its coordinate on every axis is the place."""

    def __init__(self, place: int):
        self.place = place

    def get_local_rank(self, axis: str) -> int:
        return self.place


class _InProcessCollectives:
    """The streamed engine's two collectives for places that one process
    drives in turn (patched into ``repro_torch.hier.streamed``): each call
    is recorded, and :meth:`complete` finishes every recorded call once
    every place has made it — the all-reduce a sum in place order, the
    gather each place's window in place order.  The engine reads no
    collective's result within the pass that makes it, so a pass run for
    every place and then completed is the pass the ranks of a mesh run
    together."""

    def __init__(self, places: int):
        self.places = places
        self.drop()

    def drop(self) -> None:
        self.reduces = [[] for _ in range(self.places)]
        self.gathers = [[] for _ in range(self.places)]

    def all_reduce_sum(self, mesh, t, axes):
        self.reduces[mesh.device_mesh.place].append(t)
        return t

    def all_gather_windows(self, mesh, t, wide, axes, out):
        self.gathers[mesh.device_mesh.place].append((t, wide, out))
        return out

    def complete(self) -> dict:
        """Finish the recorded calls; returns how many of each there were
        (every place made the same calls)."""
        import torch
        for calls in (self.reduces, self.gathers):
            need(len({len(c) for c in calls}) == 1, f"streamed split: the "
                 f"places made {[len(c) for c in calls]} collective calls")
        for calls in zip(*self.reduces):
            total = calls[0].clone()
            for t in calls[1:]:
                total += t
            for t in calls:
                t.copy_(total)
        for calls in zip(*self.gathers):
            got = torch.cat([torch.nn.functional.pad(t, (0, wide - len(t)))
                             for t, wide, _ in calls])
            for _, _, out in calls:
                out.copy_(got[:len(out)])
        made = {"all_reduce": len(self.reduces[0]),
                "gather": len(self.gathers[0])}
        self.drop()
        return made


def streamed_split_round(smi_line: str, device: str = "cuda") -> dict:
    """(b) The big-model round (``transformer_stacked``: 29 bf16 slabs,
    P = 16, n = 58 724 352) through ``StreamedRoundEngine`` on each of
    ``STREAM_SPLIT_RANKS`` places of a ('data',) mesh, as its ranks run
    it: one process drives every place's ``begin_round``, stages,
    ``materialize`` and ``apply`` in turn, with the engine's all-reduce
    and gather done in-process (:class:`_InProcessCollectives`).  Held
    against the same round on the engine without a mesh and on the plain
    versions: (G, C) at ``CROSS_TOL`` of max |whole|, the round's weights
    at the α bound, the materialized vector and the new parameters at
    ``SPLIT_COMBINE_TOL`` of max |whole| with the same weights, and the
    places' new parameters bitwise equal.  Every window launch of
    ``stream_stats`` takes the tensor-core body and every window of
    ``combine`` the 16-byte one; one place's pass time beside its byte
    bound."""
    import torch
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.core.solve import SolveConfig
    from repro_torch.hier import streamed
    from repro_torch.hier.streamed import StreamedRoundEngine
    from repro_torch.kernels import (combine, force_backend, launch_counts,
                                     reset_launch_counts, stream)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.specs import column_windows
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    deltas, grads, template, n = transformer_stacked(gen)
    P, R = BIG["P"], STREAM_SPLIT_RANKS
    cfg = SolveConfig(beta=5.0, ridge=1e-6)
    plan = [column_windows(deltas[k][0].numel(), R) for k in sorted(deltas)]
    windows = sum(b > a for w in plan for a, b in w)
    empty = [sum(w[r][1] == w[r][0] for w in plan) for r in range(R)]
    n0 = sum(w[0][1] - w[0][0] for w in plan)
    engines = [StreamedRoundEngine(
        template, cfg, "contextual", chunk=BIG["chunk"],
        mesh=Mesh((R,), ("data",), device_mesh=_PlaceDeviceMesh(r)))
        for r in range(R)]
    need(all(e.split for e in engines), "streamed split: an engine took "
         "no split")
    whole_eng = StreamedRoundEngine(template, cfg, "contextual",
                                    chunk=BIG["chunk"])

    def rel(got, want) -> float:
        return _max_err(got, want) / float(want.abs().max())

    coll = _InProcessCollectives(R)
    saved = streamed.all_reduce_sum, streamed.all_gather_windows
    streamed.all_reduce_sum = coll.all_reduce_sum
    streamed.all_gather_windows = coll.all_gather_windows
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        stream.reset_body_launches()
        ctxs = [eng.begin_round(deltas, grads) for eng in engines]
        made = {"begin_round": coll.complete()}
        torch.cuda.synchronize()
        counts, bodies = launch_counts(), stream.body_launches()
        need(counts["stream_stats/cuda"] == windows
             and bodies == {"mma": windows, "f32": 0, "cross": 0},
             f"streamed split: {windows} windows, stream_stats launches "
             f"{counts['stream_stats/cuda']} on {bodies}")
        rounds = [_big_stages(ctx) for ctx in ctxs]
        need(all(torch.equal(d.w, rounds[0].w) for d in rounds),
             "streamed split: the places' P-space stages gave different "
             "weights on the same (G, C)")
        reset_launch_counts()
        combine.reset_body_launches()
        vecs = [ctx.materialize(d) for ctx, d in zip(ctxs, rounds)]
        made["materialize"] = coll.complete()
        news = [ctx.apply(template, d) for ctx, d in zip(ctxs, rounds)]
        made["apply"] = coll.complete()
        whole = whole_eng.begin_round(deltas, grads)
        wdelta = _big_stages(whole)
        # the windows' combines against the whole slab's on the same weights
        same_vecs = [ctx.materialize(wdelta) for ctx in ctxs]
        made["materialize, whole-round weights"] = coll.complete()
        same_news = [ctx.apply(template, wdelta) for ctx in ctxs]
        made["apply, whole-round weights"] = coll.complete()
        torch.cuda.synchronize()
        cb = combine.body_launches()
        need(launch_counts()["combine/cuda"] == 4 * windows
             and cb == {"vec": 4 * windows, "scalar": 0},
             f"streamed split: {windows} windows, combine launches "
             f"{launch_counts()['combine/cuda']} on {cb}")
        # one place's accumulate pass alone (its all-reduce dropped)
        place_ms = time_ms(lambda: engines[0].begin_round(deltas, grads), 20)
        kernels = device_kernel_means(
            lambda: engines[0].begin_round(deltas, grads))
        place_device_ms = sum(c * ms for c, ms in kernels.values()) / 3
        place_host_ms = host_ms(lambda: engines[0].begin_round(deltas, grads),
                                5)
        coll.drop()
    finally:
        streamed.all_reduce_sum, streamed.all_gather_windows = saved
    whole_ms = time_ms(lambda: whole_eng.begin_round(deltas, grads), 20)
    wvec = whole.materialize(wdelta)
    wnew = tree_leaves(whole.apply(template, wdelta))
    with force_backend("torch"):
        plain = whole_eng.begin_round(deltas, grads)
        pvec = plain.materialize(wdelta)
        pnew = tree_leaves(plain.apply(template, wdelta))
        # the round itself on the plain versions (for its weights)
        pdelta = _big_stages(plain)
    torch.cuda.synchronize()
    def same(outs) -> bool:
        first = tree_leaves(outs[0])
        return all(all(torch.equal(a, b) for a, b in zip(tree_leaves(o),
                                                         first))
                   for o in outs[1:])
    place_bits = (all(torch.equal(c.G, ctxs[0].G)
                      and torch.equal(c.C, ctxs[0].C) for c in ctxs)
                  and all(torch.equal(v, vecs[0]) for v in vecs)
                  and all(torch.equal(v, same_vecs[0]) for v in same_vecs)
                  and same(news) and same(same_news))
    errs = {
        "G, C against the whole pass": max(rel(ctxs[0].G, whole.G),
                                           rel(ctxs[0].C, whole.C)),
        "G, C against the plain version": max(rel(ctxs[0].G, plain.G),
                                              rel(ctxs[0].C, plain.C)),
        "vector against the whole round": rel(same_vecs[0], wvec),
        "vector against the plain version": rel(same_vecs[0], pvec),
        "params against the whole round": max(
            rel(a, b) for a, b in zip(tree_leaves(same_news[0]), wnew)),
        "params against the plain version": max(
            rel(a, b) for a, b in zip(tree_leaves(same_news[0]), pnew)),
        "the round's own vector against the whole round's":
            rel(vecs[0], wvec),
    }
    weights_ok = all(torch.allclose(rounds[0].w, want.w, rtol=ALPHA_RTOL,
                                    atol=ALPHA_ATOL)
                     for want in (wdelta, pdelta))
    weights_err = max(_max_err(rounds[0].w, want.w)
                      for want in (wdelta, pdelta))
    bound = cross_bound(2 * P, n0, P * (P + 1) // 2 + P * P, 2 * P * P,
                        torch.bfloat16)
    log(f"streamed split: the big-model round (P = {P} bf16, n = {n}, "
        f"{len(plan)} slabs) through the engine on each of {R} places of a "
        f"('data',) mesh, its collectives in-process ({made}): {windows} "
        f"windows, stream_stats all {bodies}, combine (materialize and "
        f"apply, twice) all {cb}; empty windows by place {empty}; the "
        f"places bitwise equal {place_bits}; the round's weights against "
        f"the whole and plain rounds' max |diff| {weights_err:.3e} (rtol "
        f"{ALPHA_RTOL}, atol {ALPHA_ATOL}); "
        + "; ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (max |err| / max |want|: G, C at {CROSS_TOL}, the rest with "
        f"the whole round's weights at {SPLIT_COMBINE_TOL}, the round's own "
        f"at {BIG_DELTA_TOL}); place 0's pass ({n0} columns) "
        f"{place_ms * 1e3:.1f} us against a bound of "
        f"{bound['bound_ms'] * 1e3:.1f} us ({bound['bound_by']}), "
        f"{place_device_ms * 1e3:.1f} us on the device, "
        f"{place_host_ms * 1e3:.1f} us of host time to issue it; the whole "
        f"pass {whole_ms * 1e3:.1f} us; {smi_line}")
    need(place_bits, "streamed split: the places' (G, C), vectors or new "
         "params differ")
    need(weights_ok, f"streamed split: weights off by {weights_err:.3e}")
    need(max(errs[k] for k in list(errs)[:2]) <= CROSS_TOL,
         f"streamed split: {errs}")
    need(max(list(errs.values())[2:6]) <= SPLIT_COMBINE_TOL,
         f"streamed split: {errs}")
    need(list(errs.values())[6] <= BIG_DELTA_TOL, f"streamed split: {errs}")
    del deltas, grads, ctxs, vecs, news, same_vecs, same_news
    torch.cuda.empty_cache()
    return {"places": R, "windows": windows, "stream_stats_bodies": bodies,
            "combine_bodies": cb, "collectives": made,
            "empty_windows_by_place": empty, "places_bitwise_equal":
            place_bits, "weights_max_diff": weights_err, "rel_err": errs,
            "tolerance": {"G, C": CROSS_TOL, "combine": SPLIT_COMBINE_TOL,
                          "own weights": BIG_DELTA_TOL,
                          "weights": [ALPHA_RTOL, ALPHA_ATOL]},
            "place0_columns": n0, "place0_ms": place_ms,
            "place0_device_ms": place_device_ms,
            "place0_host_ms": place_host_ms, "whole_ms": whole_ms,
            "place0_bound_ms": bound["bound_ms"],
            "place0_bound_by": bound["bound_by"]}


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
    from repro_torch.kernels import (gram, launch_counts, reset_launch_counts,
                                     stream)
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
        stream_before = stream.body_launches()
        with use_tracker(tracker):
            res = run(lambda t, p: snaps.append(launch_counts()))
        torch.cuda.synchronize()
        counts = launch_counts()
        bodies = _tally_since(before, gram.block_body_launches())
        stream_bodies = _tally_since(stream_before, stream.body_launches())
        plain = {k: v for k, v in counts.items() if k.endswith("/torch") and v}
        need(not plain, f"robust {name}: plain versions ran: {plain}")
        need(np.isfinite(res.train_loss).all(),
             f"robust {name}: non-finite losses {res.train_loss}")
        need(bodies == {"mma": 0, "f32": counts["gram_block/cuda"],
                        "cross": 0},
             f"robust {name}: gram_block bodies {bodies}, "
             f"{counts['gram_block/cuda']} launches")
        need(stream_bodies == {"mma": 0, "f32": counts["stream_stats/cuda"],
                               "cross": 0},
             f"robust {name}: stream_stats bodies {stream_bodies}, "
             f"{counts['stream_stats/cuda']} launches")
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
            f"{ms[0]:.2f})  launches {launched}  gram_block bodies {bodies}"
            f"  stream_stats bodies {stream_bodies}")
        numbers["runs"][name] = {"loss": res.train_loss, "round_ms": ms,
                                 "launches": launched,
                                 "gram_block_bodies": bodies,
                                 "stream_stats_bodies": stream_bodies}
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


# ------------------------------------------------------------------- fleet

def _fleet_bench():
    """``benchmarks/torch_fleet_scale.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_fleet_scale", ROOT / "benchmarks" / "torch_fleet_scale.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_fleet_record(rec: dict, recorded, params) -> None:
    """The gates of one fleet record: devices a round, the per-tier bytes
    that follow from it, gram on every round on the card and no plain
    version; with a ``BENCH_fleet.json`` record, its devices a round and
    bytes exactly, its virtual end time at rel 1e-12 and its loss within
    2 %."""
    import math
    from repro_torch.edge.wallclock import model_payload_bytes
    from repro_torch.hier.comm import update_bytes
    n_dev, rounds = rec["fleet_size"], rec["rounds"]
    what = f"fleet {n_dev}"
    need(rec["devices_per_round"] == n_dev,
         f"{what}: {rec['devices_per_round']} devices a round")
    need(math.isfinite(rec["final_train_loss"]),
         f"{what}: loss {rec['final_train_loss']}")
    n_model = FLEET_DIM * FLEET_CLASSES + FLEET_CLASSES
    comm = rec["comm"]
    need(comm["tier_0"]["bytes_down"]
         == rounds * n_dev * model_payload_bytes(params)
         and comm["tier_1"]["bytes_up"]
         == rec["arrived"] * update_bytes(n_model)
         and rec["arrived"] + rec["dropped"] == rounds * n_dev,
         f"{what}: device-tier bytes {comm} against {rec['arrived']} "
         f"arrivals of {rounds * n_dev} tasks")
    gws = rec["num_gateways"]
    per_round = [r.get("gram/cuda", 0) for r in rec["launches_by_round"]]
    need(len(per_round) == rounds and all(g == gws + 1 for g in per_round),
         f"{what}: gram/cuda launches by round {per_round}, want "
         f"{gws + 1} each (every gateway and the cloud)")
    plain = {k: v for k, v in rec["launches"].items() if k.endswith("/torch")}
    need(not plain, f"{what}: plain versions ran: {plain}")
    if recorded is None:
        return
    for key in ("devices_per_round", "cloud_uplink_bytes", "total_bytes"):
        need(rec[key] == recorded[key],
             f"{what}: {key} {rec[key]} != BENCH_fleet.json's {recorded[key]}")
    rel_t = abs(rec["t_virtual_end"] - recorded["t_virtual_end"]) / abs(
        recorded["t_virtual_end"])
    need(rel_t <= FLEET_T_RTOL, f"{what}: t_virtual_end {rec['t_virtual_end']}"
         f" vs {recorded['t_virtual_end']} (rel {rel_t:.3e})")
    rel_l = abs(rec["final_train_loss"] - recorded["final_train_loss"]) / abs(
        recorded["final_train_loss"])
    need(rel_l <= FLEET_LOSS_RTOL, f"{what}: loss {rec['final_train_loss']} "
         f"vs {recorded['final_train_loss']} (rel {rel_l:.3e})")


def _log_fleet_record(rec: dict, recorded) -> None:
    sp = rec["spans_ms"]
    ref = ("" if recorded is None else
           f" (BENCH_fleet.json: loss {recorded['final_train_loss']:.6f}, "
           f"cloud uplink {recorded['cloud_uplink_bytes']:.0f} B, total "
           f"{recorded['total_bytes']:.0f} B, t_virtual_end "
           f"{recorded['t_virtual_end']!r})")
    log(f"fleet {rec['fleet_size']:>8d} devices, {rec['num_gateways']} "
        f"gateways, {rec['rounds']} rounds: loss {rec['final_train_loss']:.6f}"
        f", cloud uplink {rec['cloud_uplink_bytes']:.0f} B, total "
        f"{rec['total_bytes']:.0f} B, t_virtual_end {rec['t_virtual_end']!r}"
        f"{ref}")
    log(f"fleet {rec['fleet_size']:>8d}: warm round "
        f"{rec['warm_round_wall_time_ms']:.1f} ms (first "
        f"{rec['compile_wall_time_s'] * 1e3:.1f}), "
        f"{rec['devices_per_s']:.0f} devices/s, peak allocated "
        f"{rec['peak_allocated_gb']:.3f} GB; warm spans ms: client_update "
        f"{sp['client_update']:.1f}, begin_round {sp['begin_round']:.1f}, "
        f"event_loop {sp['event_loop']:.1f} (gateway {sp['gateway']:.1f}, "
        f"merge {sp['merge']:.1f}, cloud {sp['cloud']:.1f}), round "
        f"{sp['round']:.1f}, eval (last round) {sp['eval']:.1f}; "
        f"launches {rec['launches']}")


def fleet_shard_share(bench, n_ids: int, device: str = "cuda") -> dict:
    """CUDA-event ms of generating ``n_ids`` shards and of the local SGD on
    them (``client_update``, the path's step budget and batch), the
    generation's share of the two, median of five."""
    import torch
    from repro_torch.fl.client import client_update, draw_batch_indices
    from repro_torch.models.logistic import logistic_loss
    ds = bench._dataset(FLEET_SIZES[-1])
    shard = ds.shard_fn(device)
    ids = torch.arange(n_ids, device=device) * 7 % ds.num_devices
    params = bench._params(device)
    cfg = bench._cfg()
    steps = cfg.max_epochs * max(ds.samples_per_device // cfg.batch_size, 1)
    x, y, mask = shard(ids)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    idx = draw_batch_indices(mask, steps, cfg.batch_size, gen)
    ns = torch.full((n_ids,), steps, device=device)
    gen_ms = _event_ms(lambda: shard(ids), 5)
    sgd_ms = _event_ms(lambda: client_update(
        logistic_loss, params, x, y, mask, ns, idx, lr=cfg.lr), 5)
    g, s = statistics.median(gen_ms), statistics.median(sgd_ms)
    return {"ids": n_ids, "shard_ms": g, "sgd_ms": s,
            "shard_share": g / (g + s)}


def fleet_idle_share(bench, params, n_dev: int) -> dict:
    """One warm one-round run at ``n_dev`` devices: its host time (a run
    between two synchronisations) against the device busy time of the same
    run under ``torch.profiler`` (``_device_rows``: a warm-up call, then
    one in the profiler's warm-up cycle, then the recorded one)."""
    import torch
    run = lambda: bench.run_fleet(n_dev, 1, params)  # noqa: E731
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(run, 1)
    busy = sum(_device_us(e) for e in rows) / 1e3
    top = sorted(rows, key=_device_us, reverse=True)[:5]
    return {"devices": n_dev, "host_ms": host, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / host,
            "kernels": sum(e.count for e in rows),
            "top_kernels_ms": {e.key[:60]: _device_us(e) / 1e3 for e in top}}


def fleet_round_vs_cpu(bench, params, device: str = "cuda") -> dict:
    """One ``FLEET_CPU_DEVICES``-device cohort round on the card against
    the same round on the CPU: the CPU run takes the card's generated
    shards as a ``FederatedDataset`` and both take the same mini-batch
    indices (a CPU generator through ``batch_indices``).  Beside it, the
    CPU's own generation of the same shards: max |Δx| and flipped labels."""
    import numpy as np
    import torch
    from repro_torch.core.flatten import tree_map, tree_to_vector
    from repro_torch.data import FederatedDataset
    from repro_torch.edge import array_bimodal_fleet
    from repro_torch.fl import run_hier_simulation
    from repro_torch.fl.client import draw_batch_indices
    from repro_torch.hier import stacked_two_tier
    from repro_torch.models.logistic import logistic_apply, logistic_loss
    n_dev = FLEET_CPU_DEVICES
    ds = bench._dataset(n_dev)
    cfg = bench._cfg()
    topo = stacked_two_tier(array_bimodal_fleet(n_dev), max(4, n_dev // 500))
    ids = np.arange(n_dev)
    gx, gy, gm = ds.materialize_arrays(ids, device)
    cx, cy, _ = ds.materialize_arrays(ids, "cpu")
    dx = float(np.abs(gx - cx).max())
    flips = int((gy != cy).sum())
    tx, ty = ds.test_set(device)
    fed = FederatedDataset(gx, gy, gm, tx, ty, ds.num_classes)

    def batch_indices(t, part_dev, max_steps):
        gen = torch.Generator()
        gen.manual_seed(1000 + t)
        return draw_batch_indices(torch.ones((len(part_dev),
                                              ds.samples_per_device)),
                                  max_steps, cfg.batch_size, gen)
    outs = {}
    for dev, data in ((device, ds), ("cpu", fed)):
        got = []
        r = run_hier_simulation(
            "vs_cpu", logistic_loss, logistic_apply,
            tree_map(lambda p: p.to(dev), params), data, cfg, topo, 1,
            selection_seed=bench.SEED, scheduler_mode="cohort",
            rng_stream="v2", device=dev, batch_indices=batch_indices,
            publish_fn=lambda t, p: got.append(tree_to_vector(p).cpu()))
        need(len(got) == 1, "the fleet card-vs-CPU round was skipped")
        outs[dev] = (got[0], r)
    (card, r_card), (cpu, r_cpu) = outs[device], outs["cpu"]
    rel = _max_err(card, cpu) / _scale(cpu)
    loss_rel = abs(r_card.train_loss[0] - r_cpu.train_loss[0]) / abs(
        r_cpu.train_loss[0])
    need(r_card.times == r_cpu.times,
         "fleet card vs CPU: virtual times differ")
    return {"devices": n_dev, "params_rel_err": rel, "loss_rel_err": loss_rel,
            "shard_max_abs_dx": dx, "max_abs_x": float(np.abs(cx).max()),
            "label_flips": flips, "labels": int(cy.size)}


def fleet_phase() -> dict:
    """``benchmarks/torch_fleet_scale.py``'s ``collect()`` on the card,
    held to ``BENCH_fleet.json``; then the shard-generation share, the idle
    share of a warm 10⁵ round and a 4 096-device round card vs CPU.
    Returns the launch counts of the sweep's runs, summed."""
    import torch
    bench = _fleet_bench()
    need((bench.DIM, bench.CLASSES, bench.QUICK_SIZES, bench.COHORT_CHUNK)
         == (FLEET_DIM, FLEET_CLASSES, FLEET_SIZES[:-1], 131_072),
         "benchmarks/torch_fleet_scale.py's sizes moved")
    recorded = {r["fleet_size"]: r for r in json.loads(
        (ROOT / "BENCH_fleet.json").read_text())["records"]
        if r["scenario"] == "fleet"}
    need(set(recorded) == set(FLEET_SIZES[:-1]),
         f"BENCH_fleet.json's fleet sizes {sorted(recorded)}")
    t0 = time.perf_counter()
    out = bench.collect(FLEET_ROUNDS, quick=False, device="cuda",
                        full_rounds=FLEET_1M_ROUNDS)
    log(f"fleet: collect() in {time.perf_counter() - t0:.1f} s")
    eq, recs = out["records"][0], out["records"][1:]
    log(f"fleet equivalence_64: loss gap vs the event path "
        f"{eq['loss_gap_vs_event']!r} (0.0 expected, gate 1e-5), times equal "
        f"{eq['times_equal_event_path']}, bytes equal "
        f"{eq['bytes_equal_event_path']}, arrivals equal "
        f"{eq['counts_equal_event_path']}, final loss "
        f"{eq['final_train_loss']:.6f}, cloud uplink "
        f"{eq['cloud_uplink_bytes']:.0f} B (BENCH_fleet.json: 18896)")
    need(eq["times_equal_event_path"] and eq["bytes_equal_event_path"]
         and eq["counts_equal_event_path"]
         and eq["loss_gap_vs_event"] < 1e-5,
         f"fleet equivalence_64 failed: {eq}")
    need([r["fleet_size"] for r in recs] == list(FLEET_SIZES)
         and recs[-1]["rounds"] == FLEET_1M_ROUNDS,
         f"fleet sweep sizes {[(r['fleet_size'], r['rounds']) for r in recs]}")
    params = bench._params("cuda")
    counts = {}
    for rec in recs:
        ref = recorded.get(rec["fleet_size"])
        _log_fleet_record(rec, ref)
        _check_fleet_record(rec, ref, params)
        for k, v in rec["launches"].items():
            counts[k] = counts.get(k, 0) + v
    shares = [fleet_shard_share(bench, n) for n in (100_000, 131_072)]
    for sh in shares:
        log(f"fleet shard generation: {sh['ids']} shards {sh['shard_ms']:.2f}"
            f" ms, their local SGD {sh['sgd_ms']:.2f} ms: generation "
            f"{sh['shard_share'] * 100:.1f} % of client_update")
    idle = fleet_idle_share(bench, params, 100_000)
    log(f"fleet idle share, one warm 100000-device round (a one-round run: "
        f"round, eval and set-up): host {idle['host_ms']:.1f} ms, device "
        f"busy {idle['device_busy_ms']:.1f} ms over {idle['kernels']} "
        f"kernels: idle {idle['idle_share'] * 100:.1f} %; top kernels ms "
        f"{ {k: round(v, 3) for k, v in idle['top_kernels_ms'].items()} }")
    vs = fleet_round_vs_cpu(bench, params)
    log(f"fleet card vs CPU, one {vs['devices']}-device cohort round on the "
        f"card's shards: params rel err {vs['params_rel_err']:.3e}, loss rel "
        f"err {vs['loss_rel_err']:.3e} (tolerance 1e-4); the two devices' "
        f"generators: max |dx| {vs['shard_max_abs_dx']:.3e} of max |x| "
        f"{vs['max_abs_x']:.3f} (gate {FLEET_GEN_RTOL:g} x max |x|), "
        f"{vs['label_flips']} of {vs['labels']} labels flip")
    need(vs["params_rel_err"] <= 1e-4 and vs["loss_rel_err"] <= 1e-4,
         f"fleet card round disagrees with the CPU round: {vs}")
    need(vs["shard_max_abs_dx"] <= FLEET_GEN_RTOL * vs["max_abs_x"],
         f"fleet shards differ between the card and the CPU: {vs}")
    torch.cuda.empty_cache()
    return {"counts": counts, "numbers": {
        "equivalence_64": eq,
        "records": [{k: v for k, v in r.items() if k not in (
            "spans_ms_by_round", "launches_by_round")} for r in recs],
        "shard_share": shares, "idle": idle, "vs_cpu": vs}}


# ---------------------------------------------------------------- scaffold

def scaffold_round_vs_cpu(ds, params, agg: str = "contextual",
                          device: str = "cuda") -> float:
    """One SCAFFOLD round on the card against the same round on the CPU,
    from the same state (variates drawn from a CPU generator) and with the
    same mini-batch indices; max |Δ| of the new params and c_global,
    relative to their max."""
    import numpy as np
    import torch
    from repro_torch.core.flatten import tree_map, tree_to_vector
    from repro_torch.fl import (ScaffoldState, ServerConfig,
                                build_scaffold_round_fn, sample_round)
    from repro_torch.fl.client import draw_batch_indices
    from repro_torch.models.logistic import logistic_loss
    cfg = ServerConfig(aggregator=agg, **PATH_CFG)
    m = ds.samples_per_device
    spe = max(m // cfg.batch_size, 1)
    sel, _, num_steps = sample_round(np.random.RandomState(7), cfg, spe)
    gen = torch.Generator()
    gen.manual_seed(7)
    idx = draw_batch_indices(torch.as_tensor(ds.mask)[torch.as_tensor(
        sel, dtype=torch.long)], cfg.max_epochs * spe, cfg.batch_size, gen)
    cpu_params = tree_map(lambda p: p.detach().cpu(), params)
    c_g = tree_map(lambda p: 0.01 * torch.randn(p.shape, generator=gen),
                   cpu_params)
    c_l = tree_map(lambda p: 0.01 * torch.randn(
        (cfg.num_devices,) + tuple(p.shape), generator=gen), cpu_params)
    news = []
    for dev in (device, "cpu"):
        to = lambda t: tree_map(lambda a: a.to(dev), t)  # noqa: E731
        data = (torch.as_tensor(ds.x, device=dev),
                torch.as_tensor(ds.y, dtype=torch.long, device=dev),
                torch.as_tensor(ds.mask, device=dev))
        fn = build_scaffold_round_fn(logistic_loss, cfg, m, device=dev)
        new, _ = fn(ScaffoldState(to(cpu_params), to(c_g), to(c_l), 0), data,
                    sel, num_steps, batch_idx=idx.to(dev))
        news.append(torch.cat([tree_to_vector(new.params).cpu(),
                               tree_to_vector(new.c_global).cpu()]))
    return _max_err(news[0], news[1]) / _scale(news[1])


def scaffold_phase(ds, params, device: str = "cuda") -> dict:
    """``run_scaffold`` at paper-logreg width on the path phase's data:
    FedAvg then contextual, ``SCAFFOLD_ROUNDS`` rounds each; returns the
    launch counts, summed."""
    import numpy as np
    import torch
    from repro_torch.fl import ServerConfig, run_scaffold
    from repro_torch.fl.client import draw_batch_indices
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.logistic import logistic_apply, logistic_loss
    from repro_torch.obs import InMemoryTracker, use_tracker
    log(f"scaffold: paper-logreg, {ds.num_devices} devices, K="
        f"{PATH_CFG['clients_per_round']}, {SCAFFOLD_ROUNDS} rounds each")
    total, out = {}, {}
    for agg in ("fedavg", "contextual"):
        cfg = ServerConfig(aggregator=agg, **PATH_CFG)
        gen = torch.Generator(device=device)
        gen.manual_seed(42)
        snaps = []

        def batches(t, sel, max_steps):
            # called as each round starts: the counts so far close the
            # previous round
            snaps.append(launch_counts())
            mask = torch.as_tensor(ds.mask, device=device)[torch.as_tensor(
                sel, dtype=torch.long, device=device)]
            return draw_batch_indices(mask, max_steps, cfg.batch_size, gen)
        tracker = InMemoryTracker()
        torch.cuda.synchronize()
        reset_launch_counts()
        with use_tracker(tracker):
            res = run_scaffold(agg, logistic_loss, logistic_apply, params, ds,
                               cfg, num_rounds=SCAFFOLD_ROUNDS,
                               selection_seed=42, batch_indices=batches,
                               device=device)
        torch.cuda.synchronize()
        counts = launch_counts()
        snaps = snaps[1:] + [counts]
        round_ms = _round_ms(tracker)
        need(np.isfinite(res.train_loss).all()
             and res.train_loss[-1] < res.train_loss[0],
             f"scaffold {agg}: losses {res.train_loss}")
        ops = ("gram", "combine") if agg == "contextual" else ("combine",)
        prev = {k: 0 for k in counts}
        for t, snap in enumerate(snaps):
            for op in ops:
                need(snap[f"{op}/cuda"] > prev[f"{op}/cuda"],
                     f"scaffold {agg}: round {t} launched no {op}/cuda")
            prev = snap
        plain = {k: v for k, v in counts.items() if k.endswith("/torch") and v}
        need(not plain, f"scaffold {agg}: plain versions ran: {plain}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        out[agg] = {"loss": res.train_loss, "acc": res.test_acc,
                    "volatility": res.loss_volatility(), "round_ms": round_ms,
                    "launches": {k: v for k, v in counts.items() if v}}
        log(f"scaffold {agg:10s} loss {res.train_loss[0]:.4f} -> "
            f"{res.train_loss[-1]:.4f}  acc {res.test_acc[-1]:.4f}  "
            f"volatility {res.loss_volatility():.4f}  round ms median "
            f"{statistics.median(round_ms):.2f} (first {round_ms[0]:.2f}, all "
            f"{[round(r, 2) for r in round_ms]})  launches "
            f"{out[agg]['launches']}")
    rel = scaffold_round_vs_cpu(ds, params, device=device)
    log(f"scaffold: one contextual round, card vs CPU, max rel err of the new "
        f"params and c_global {rel:.3e} (tolerance 1e-4)")
    need(rel <= 1e-4, f"scaffold card round disagrees with the CPU: {rel:.3e}")
    out["vs_cpu"] = rel
    return {"counts": total, "numbers": out}


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


def _big_stages(ctx):
    """A tier-tree round's P-space stages, as the reference's
    ``_round_once``: gateway solves, the cloud's γ stage; returns the
    round's delta."""
    P, gws = BIG["P"], BIG["gateways"]
    per = P // gws
    cohorts = [list(range(g * per, (g + 1) * per)) for g in range(gws)]
    sums = [ctx.gateway(c) for c in cohorts]
    counts = [float(len(c)) for c in cohorts]
    ghat = ctx.compose_grads([s["ghat"] for s in sums], counts)
    delta, _ = ctx.cloud_combo([s["u_bar"] for s in sums], counts, ghat)
    return delta


def _big_round(eng, template, deltas, grads):
    """One tier-tree round through the context API: the stages of
    :func:`_big_stages`, then the apply."""
    ctx = eng.begin_round(deltas, grads)
    delta = _big_stages(ctx)
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
    need(bodies == {"mma": len(deltas), "f32": 0, "cross": 0},
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
    need(stream.body_launches() == {"mma": 4 * len(deltas), "f32": 0,
                                    "cross": 0},
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
    # the library yardstick of the apply: a torch.add per slab of its
    # leaf's f32 params and the mix weights' product with the bf16 slab, in
    # the slab's dtype, as the combine rows' (w + a @ U); not donated
    from repro_torch.core.flatten import tree_leaves
    lib_slabs = [(p.reshape(-1), s.matrix) for p, s in zip(
        tree_leaves(template), sctx._dview.slabs)]
    mix = {m.dtype: sdelta.w.to(m.dtype) for _, m in lib_slabs}
    apply_library_ms = time_ms(lambda: [torch.add(f, mix[m.dtype] @ m)
                                        for f, m in lib_slabs], 5, warmup=1)
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
        f"{apply_host_ms * 1e3:.1f} us of host time to issue one; library "
        f"(torch.add of w and a @ U per slab) {apply_library_ms * 1e3:.1f} "
        f"us; the apply's device kernels seen in three calls "
        f"{apply_launches}")

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
            "apply_library_ms": apply_library_ms,
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


@contextlib.contextmanager
def _recorded_routes(into: list):
    """Append each MoE layer's top-k expert set (sorted ids, (T, k)) to
    ``into`` inside the block (``moe_forward`` looks ``route`` up on the
    module at each call)."""
    from repro_torch.models import moe
    saved = moe.route

    def recording(cfg, router, xt):
        out = saved(cfg, router, xt)
        into.append(out[2].sort(-1).values)
        return out
    moe.route = recording
    try:
        yield
    finally:
        moe.route = saved


def _route_flips(a: list, b: list) -> int:
    """(layer, token) pairs whose top-k expert sets differ between two
    recorded runs of the same step."""
    return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))


def _random_cache(cfg, device):
    """The serve cache's layout filled with seeded normals, drawn on the CPU
    so that every device holds the same cache."""
    import torch
    from repro_torch.models import transformer as ttf
    cache = ttf.init_lm_cache(cfg, SERVE["slots"], SERVE["max_seq"],
                              ring=False, device=device)
    gen = torch.Generator()
    gen.manual_seed(3)
    for t in cache.kv:
        t.copy_(torch.randn(t.shape, generator=gen))
    return cache


def _decode_logits(cfg, params, device, cache,
                   variants=("kernel", "plain")) -> tuple:
    """The logits of one decode step (4 slots at depths 200-230, all
    active), once per attention in ``variants``, each from the same cache:
    ``kernel`` (the port's path), ``plain`` (the plain flash_decode in f32),
    ``f64`` (its arithmetic in f64) and ``sdpa`` (the SDPA yardstick).
    Returns ``(logits, routes)``: routes maps each variant to its MoE
    layers' top-k sets (empty for a dense model)."""
    import torch
    from repro_torch.kernels import force_backend
    from repro_torch.models import transformer as ttf
    pos = torch.tensor([200, 210, 220, 230], dtype=torch.int32, device=device)
    tok = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=device)
    active = torch.ones(SERVE["slots"], dtype=torch.bool, device=device)
    attention = {"kernel": contextlib.nullcontext,
                 "plain": lambda: force_backend("torch", "flash_decode"),
                 "f64": lambda: _attention(_flash_decode_f64),
                 "sdpa": lambda: _attention(_flash_decode_sdpa)}
    saved = [t.clone() for t in cache.kv]
    out, routes = {}, {}
    for name in variants:
        for t, s in zip(cache.kv, saved):
            t.copy_(s)
        routes[name] = []
        with attention[name](), _recorded_routes(routes[name]):
            out[name], _ = ttf.decode_slots(cfg, params, tok, cache, pos,
                                            active=active)
    return out, routes


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


def _param_count(cfg) -> int:
    """Parameters of a dense or MoE config: the analytic estimate (for MoE
    it counts every routed and shared expert and the router) plus the norm
    scales it leaves out (ln1, ln2, qk-norm per layer; final norm)."""
    qk = 2 * cfg.resolved_head_dim if cfg.qk_norm else 0
    return (cfg.param_count_estimate()
            + cfg.num_layers * (2 * cfg.d_model + qk) + cfg.d_model)


def serve_phase(device: str = "cuda", cfg=None, small=None,
                logit_tol: float = SERVE_LOGIT_TOL, tag: str = "serve",
                extra=None) -> dict:
    """The continuous-batching engine on a full-width bf16 model (the full
    qwen3-14b by default; the moe phase passes each MoE config with its own
    logit tolerance, and ``extra(cfg, params, device)`` for the checks only
    it makes while the model is loaded); ``small`` is the reduced f32
    config served on the card and on the CPU (the reduced ``cfg`` by
    default).  ``cfg``, ``small`` and ``device`` other than the defaults
    also rehearse the phase's control flow at a small size."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves, tree_map
    from repro_torch.kernels import (decode_attn, launch_counts,
                                     reset_launch_counts)
    from repro_torch.models import get_model
    from repro_torch.models import transformer as ttf
    from repro_torch.obs import InMemoryTracker, use_tracker
    cfg = cfg or get_config(SERVE["arch"])
    small = small or get_config(cfg.name).reduced()
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
    log(f"{tag}: {cfg.name} L={L} d={cfg.d_model} heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} hd={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size}" + (
            f" experts {cfg.num_experts} top-{cfg.experts_per_token} shared "
            f"{cfg.num_shared_experts}" if cfg.family == "moe" else "")
        + f" bf16: {n} parameters, {weight_bytes} B, init {init_s:.1f} s; "
        f"weights read per decode step {step_bytes} B -> bound "
        f"{step_bound_ms:.3f} ms")
    need(n == _param_count(cfg), f"{tag}: {n} parameters, want "
         f"{_param_count(cfg)}")

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
         f"{tag}: not every request completed with its budget")
    need(seen == sorted(seen) and eng.model_version == 1
         and eng.stats["swaps"] == 1, f"{tag}: versions {seen}")
    need(all(0 <= c.admit_version <= c.final_version <= 1 for c in done),
         f"{tag}: completion versions")
    need(counts["flash_decode/cuda"] == L * steps,
         f"{tag}: flash_decode/cuda {counts['flash_decode/cuda']} launches, "
         f"want L x decode steps = {L * steps}")
    need(bodies == {"cluster": L * steps, "mma": 0, "cuda_core": 0},
         f"{tag}: flash_decode bodies {bodies}, want all {L * steps} bf16 "
         "launches on the cluster body")
    plain = {k: v for k, v in counts.items() if k.endswith("/torch") and v}
    need(not plain, f"{tag}: plain versions ran on the path: {plain}")
    chunk_ms = sorted(ms / SERVE["scan_chunk"]
                      for ms in _round_ms(tracker, "serve/decode_chunk"))
    swap_stall = eng.stats["swap_stall_s_max"]
    log(f"{tag}: {len(done)} requests, {tokens} tokens in {wall:.2f} s = "
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
    log(f"{tag}: decode step B={B} S={SERVE['max_seq']} alone: median "
        f"{step_med:.2f} ms (min {min(step_ms):.2f}) against the "
        f"{step_bound_ms:.3f} ms bound ({step_bound_ms / step_med:.1%}); "
        f"prefill chunk of {SERVE['prefill_chunk']} tokens: median "
        f"{statistics.median(prefill_ms):.2f} ms")

    if busy is None:
        log(f"{tag}: device busy time per step: not measured (the profiler "
            "recorded no device time)")
    else:
        log(f"{tag}: device busy per decode step {busy['busy_ms']:.2f} ms of "
            f"{step_med:.2f} ms ({busy['busy_ms'] / step_med:.1%}; idle "
            f"share {1 - busy['busy_ms'] / step_med:.1%}); by kernel (ms per "
            f"step, launches per step): " + "; ".join(
                f"{k} {v[0]:.3f} ({v[1]:g})" for k, v in busy["top"]))

    # the kernel against the plain flash_decode inside one decode step,
    # beside the floor that two correct attentions show through the bf16
    # model: the plain version in f32 against the same arithmetic in f64,
    # and against SDPA; a MoE model also counts the (layer, token) top-k
    # sets that the attention's f32 differences moved
    lg, routes = _decode_logits(cfg, params, device, cache,
                                ("kernel", "plain", "f64", "sdpa"))
    logit_err = _logit_err(lg["kernel"], lg["plain"])
    floor = {"plain_vs_f64": _logit_err(lg["plain"], lg["f64"]),
             "plain_vs_sdpa": _logit_err(lg["plain"], lg["sdpa"]),
             "kernel_vs_f64": _logit_err(lg["kernel"], lg["f64"])}
    logit_floor = max(floor["plain_vs_f64"], floor["plain_vs_sdpa"])
    flips = {pair: _route_flips(routes[a], routes[b]) for pair, (a, b) in (
        ("kernel_vs_plain", ("kernel", "plain")),
        ("plain_vs_f64", ("plain", "f64")),
        ("plain_vs_sdpa", ("plain", "sdpa")))}
    log(f"{tag}: logit floor (one full-width bf16 step, max |dlogit| / max "
        f"|logit|) of two correct attentions {logit_floor:.3e}: plain f32 vs "
        f"f64 {floor['plain_vs_f64']:.3e}, plain vs SDPA "
        f"{floor['plain_vs_sdpa']:.3e}; kernel vs plain {logit_err:.3e}, "
        f"kernel vs f64 {floor['kernel_vs_f64']:.3e} (gate "
        f"{logit_tol:.4g})" + (
            f"; (layer, token) top-k sets that differ of "
            f"{L * SERVE['slots']}: {flips}" if routes["kernel"] else ""))
    need(logit_err <= logit_tol, f"{tag}: decode-step logits with the "
         f"kernel vs plain flash_decode: {logit_err:.3e} of max |logit| > "
         f"{logit_tol}")
    del lg
    more = extra(cfg, params, device) if extra else {}
    del eng, cache
    torch.cuda.empty_cache()

    # continuous batching equals solo decode at full width
    few = [(p[:60 + 20 * i], 6 + 3 * i) for i, (p, _) in enumerate(reqs[:3])]
    batched = _staggered(_engine(cfg, params, device), few)
    for rid, req in enumerate(few):
        solo = _staggered(_engine(cfg, params, device), [req])
        need(solo[0] == batched[rid], f"{tag}: rid {rid} batched "
             f"{batched[rid]} != solo {solo[0]}")
    del params, published
    torch.cuda.empty_cache()

    # the reduced f32 config on the card and on the CPU: the same tokens,
    # and one decode step's logits within f32 summation order
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
    need(small_bodies["cluster"] == small_bodies["mma"] == 0
         and small_bodies["cuda_core"] > 0,
         f"{tag}: reduced f32 flash_decode bodies {small_bodies}, want the "
         "CUDA-core body only")
    on_cpu = _staggered(_engine(small, small_cpu, "cpu", **kw), small_reqs)
    need(on_card == on_cpu, f"{tag}: reduced f32 tokens card {on_card} != "
         f"CPU {on_cpu}")
    lg, _ = _decode_logits(small, small_card, device,
                           _random_cache(small, device))
    small_err = _logit_err(lg["kernel"], lg["plain"])
    cpu_lg, _ = _decode_logits(small, small_cpu, "cpu",
                               _random_cache(small, "cpu"), ("kernel",))
    card_vs_cpu = _logit_err(lg["kernel"].cpu(), cpu_lg["kernel"])
    for what, err in (("kernel vs plain flash_decode", small_err),
                      ("card vs CPU", card_vs_cpu)):
        need(err <= SERVE_LOGIT_TOL_F32, f"{tag}: reduced f32 decode-step "
             f"logits {what} {err:.3e} > {SERVE_LOGIT_TOL_F32}")
    log(f"{tag}: kernel vs plain flash_decode in one decode step: "
        f"{logit_err:.3e} of max |logit| (tolerance {logit_tol:.4g}); "
        f"reduced f32: {small_err:.3e}, card vs CPU {card_vs_cpu:.3e} "
        f"(tolerance {SERVE_LOGIT_TOL_F32}); 3 staggered requests equal solo "
        f"at full width; reduced f32 {small.name} tokens equal on card and "
        f"CPU ({sum(map(len, on_cpu.values()))} tokens; flash_decode bodies "
        f"{small_bodies})")
    return dict({"counts": counts, "bodies": bodies,
                 "reduced_f32_bodies": small_bodies,
                 "tokens": tokens, "wall_s": wall,
                 "tokens_per_s": tokens / wall, "decode_steps": steps,
                 "decode_step_ms_alone": step_med,
                 "decode_step_ms_alone_all": step_ms,
                 "decode_step_ms_as_served_median":
                     statistics.median(chunk_ms),
                 "decode_step_bound_ms": step_bound_ms,
                 "decode_step_bytes": step_bytes,
                 "prefill_chunk_ms": statistics.median(prefill_ms),
                 "swap_stall_s": swap_stall,
                 "logit_rel_err_vs_plain": logit_err,
                 "logit_floor": logit_floor, "logit_floor_pairs": floor,
                 "logit_tolerance": logit_tol,
                 "logit_rel_err_vs_plain_reduced_f32": small_err,
                 "logit_rel_err_card_vs_cpu_reduced_f32": card_vs_cpu,
                 "device_busy": busy, "init_s": init_s, "parameters": n},
                **({"route_flips": flips} if routes["kernel"] else {}),
                **more)


def _serve_steps(cfg, mesh, mode: str, max_seq: int, B: int) -> tuple:
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    return (build_prefill_step(cfg, mesh, InputShape(
                "custom", "prefill", max_seq, B), mode=mode),
            build_decode_step(cfg, mesh, InputShape(
                "custom", "decode", max_seq, B), mode=mode))


def _serve_run(cfg, params, mesh, mode: str, prompts, tokens,
               max_seq: int) -> tuple:
    """The prefill of ``prompts`` then a decode step per token of
    ``tokens`` through the steps of ``mode``: (every call's logits on the
    host, the last cache, the decode step, the steps' placement)."""
    prefill, decode = _serve_steps(cfg, mesh, mode, max_seq,
                                   prompts.shape[0])
    logits, cache = prefill(params, {"tokens": prompts})
    out = [logits.float().cpu()]
    for tok in tokens:
        logits, cache = decode(params, tok, cache)
        out.append(logits.float().cpu())
    return out, cache, decode, prefill.placement


def _attention_decode_f64(cfg, params, x, cache, position, *, window=None,
                          use_rope=True):
    """``attention.attention_decode``'s plain arithmetic (outside ring
    mode) in f64 where it works in f32: the second correct attention of a
    placed hybrid's logit floor (``serve_placed_model``)."""
    import torch
    from repro_torch.models import attention as A
    B, S = x.shape[0], cache.k.shape[1]
    A.check_capacity(position, S)
    pos = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    q, k, v = A._project_qkv(cfg, params, x, pos if use_rope else None,
                             use_rope)
    cache.k[:, position] = k[:, 0].to(cache.k.dtype)
    cache.v[:, position] = v[:, 0].to(cache.v.dtype)
    hd = cfg.resolved_head_dim
    s = torch.einsum("bkgd,bskd->bkgs",
                     A._grouped(cfg, q).double() * hd ** -0.5,
                     cache.k.double())
    s = A.softcap(s, cfg.attn_logit_softcap)
    kpos = torch.arange(S, device=x.device)
    ok = kpos <= position
    if window is not None:
        ok = ok & (kpos > position - window)
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, cache.v.double())
    return o.reshape(B, 1, -1).to(x.dtype) @ params["wo"], cache


def _serve_placed_f32(name: str, mesh, device: str) -> float:
    """The reduced f32 config, placed and unplaced on ``mesh`` (TF32 off):
    the largest gap of any call's logits over max |logit|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    P = SERVE_PLACED
    cfg = get_config(name).reduced()
    params = get_model(cfg).init(0, device=device)
    gen = torch.Generator()
    gen.manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (P["batch"], P["small_prompt"]),
                            generator=gen, dtype=torch.int32).to(device)
    tokens = [torch.randint(0, cfg.vocab_size, (P["batch"],), generator=gen,
                            dtype=torch.int32).to(device)
              for _ in range(P["steps"])]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = _serve_run(cfg, params, mesh, "tp", prompts, tokens,
                         P["small_seq"])[0]
        want = _serve_run(cfg, params, mesh, "dp", prompts, tokens,
                          P["small_seq"])[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return max(_logit_err(a, b) for a, b in zip(got, want))


def serve_placed_model(name: str, mesh, smi_line: str,
                       device: str = "cuda", reduced: bool = False) -> dict:
    """One model of :func:`serve_placed_phase`: its bf16 params seeded on
    the card, the unplaced run (mode "dp"; its decode step timed, then its
    cache freed), the placed run (mode "tp") as the main path with the
    launch counters at 0 just before it and read just after, its decode
    step timed; the logits gated; the reduced f32 config placed and
    unplaced."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.kernels import (decode_attn, launch_counts,
                                     reset_launch_counts)
    P = SERVE_PLACED
    cfg = get_config(name)
    cfg = cfg.reduced() if reduced else cfg
    tag = f"serve placed {cfg.name}"
    on_card = torch.device(device).type == "cuda"
    if on_card:
        bundle, params, n, nbytes, init_s = _init_on_card(tag, cfg, smi_line,
                                                         device)
    else:       # a rehearsal of the control flow on the CPU
        from repro_torch.models import get_model
        params = get_model(cfg).init(0, device=device)
        n = sum(p.numel() for p in tree_leaves(params))
        nbytes = sum(p.numel() * p.element_size()
                     for p in tree_leaves(params))
        init_s = None
    gen = torch.Generator()
    gen.manual_seed(7)
    B, S0, max_seq = P["batch"], P["prompt"], P["max_seq"]
    prompts = torch.randint(0, cfg.vocab_size, (B, S0), generator=gen,
                            dtype=torch.int32).to(device)
    tokens = [torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                            dtype=torch.int32).to(device)
              for _ in range(P["steps"])]
    attn_layers = (cfg.num_layers // cfg.attn_every
                   if cfg.family == "hybrid" else cfg.num_layers)

    def step_numbers(decode, cache, what):
        tok = tokens[-1]
        if not on_card:
            return {"step_ms": None, "step_ms_all": [], "device_busy": None}
        ms = _event_ms(lambda: decode(params, tok, cache), reps=5)
        busy = device_busy(lambda: decode(params, tok, cache), steps=2)
        med = statistics.median(ms)
        log(f"{tag} {what} decode step at position {cache.position} "
            f"({smi_line}): median {med:.2f} ms (min {min(ms):.2f}); "
            + ("device busy not measured (the profiler recorded no device "
               "time)" if busy is None else
               f"device busy {busy['busy_ms']:.2f} ms ({busy['busy_ms'] / med:.1%}"
               f", idle {1 - busy['busy_ms'] / med:.1%}); by kernel (ms, "
               "launches per step): " + "; ".join(
                   f"{k} {v[0]:.3f} ({v[1]:g})" for k, v in busy["top"])))
        return {"step_ms": med, "step_ms_all": ms, "device_busy": busy}

    want, cache, decode, plain_placement = _serve_run(
        cfg, params, mesh, "dp", prompts, tokens, max_seq)
    unplaced = step_numbers(decode, cache, "unplaced")
    del cache, decode
    if on_card:
        torch.cuda.empty_cache()
    floor = None
    if cfg.family == "hybrid":
        # the hybrid's floor: the unplaced steps again with their plain
        # attention in f64, against the f32 run, call by call (its SSM
        # states carry each step's rounding into every later step)
        from repro_torch.models import transformer
        plain = transformer.attention_decode
        transformer.attention_decode = _attention_decode_f64
        try:
            want64 = _serve_run(cfg, params, mesh, "dp", prompts, tokens,
                                max_seq)[0]
        finally:
            transformer.attention_decode = plain
        floor = [_logit_err(a, b) for a, b in zip(want64, want)]
        del want64
        if on_card:
            torch.cuda.empty_cache()
    logit_tol = (SERVE_LOGIT_TOL if floor is None
                 else SERVE_PLACED_FLOOR_RATIO * max(floor))

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reset_launch_counts()
    before = decode_attn.body_launches()
    sync()
    t0 = time.perf_counter()
    got, cache, decode, placement = _serve_run(cfg, params, mesh, "tp",
                                               prompts, tokens, max_seq)
    sync()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    bodies = _tally_since(before, decode_attn.body_launches())
    need(placement in ("tp", "fsdp") and plain_placement == "replicated",
         f"{tag}: placements {placement}, {plain_placement}")
    if on_card:
        want_launches = attn_layers * P["steps"]
        need(counts["flash_decode/cuda"] == want_launches,
             f"{tag}: flash_decode/cuda {counts['flash_decode/cuda']} "
             f"launches, want {attn_layers} attention layers x "
             f"{P['steps']} steps = {want_launches}")
        need(bodies == {"cluster": want_launches, "mma": 0,
                        "cuda_core": 0},
             f"{tag}: flash_decode bodies {bodies}, want the cluster body "
             "only")
        ran = {k: v for k, v in counts.items() if k.endswith("/torch") and v}
        need(not ran, f"{tag}: plain versions ran on the path: {ran}")
    need(all(torch.isfinite(g).all() for g in got), f"{tag}: logits not "
         "finite")
    errs = [_logit_err(a, b) for a, b in zip(got, want)]
    need(max(errs) <= logit_tol, f"{tag}: placed vs unplaced logits "
         f"{max(errs):.3e} of max |logit| > {logit_tol:.4g}")
    block_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(cache) if torch.is_tensor(t))
    placed = step_numbers(decode, cache, "placed")
    del cache, decode
    peak = torch.cuda.max_memory_allocated() if on_card else None
    del params
    if on_card:
        torch.cuda.empty_cache()
    small_err = _serve_placed_f32(name, mesh, device)
    need(small_err <= SERVE_LOGIT_TOL_F32, f"{tag}: reduced f32 placed vs "
         f"unplaced logits {small_err:.3e} > {SERVE_LOGIT_TOL_F32}")
    log(f"{tag} ({smi_line}): prefill of {B} x {S0} tokens into {max_seq} "
        f"rows then {P['steps']} decode steps in {wall:.2f} s; logits placed "
        f"vs unplaced {', '.join(f'{e:.2e}' for e in errs)} of max |logit| "
        f"(prefill first; gate {logit_tol:.4g}"
        + ("" if floor is None else
           f": {SERVE_PLACED_FLOOR_RATIO}x the floor, unplaced f32 vs f64 "
           f"attention {', '.join(f'{e:.2e}' for e in floor)}")
        + f"); flash_decode "
        f"{counts.get('flash_decode/cuda', 0)} launches, bodies {bodies}; "
        f"cache block {block_bytes} B; peak allocated {peak} B; reduced f32 "
        f"{small_err:.3e} (gate {SERVE_LOGIT_TOL_F32}); decode step placed "
        f"{placed['step_ms']} ms, unplaced {unplaced['step_ms']} ms")
    return {"counts": counts, "bodies": bodies, "placement": placement,
            "logit_rel_err": errs, "logit_tolerance": logit_tol,
            "logit_floor_f32_vs_f64": floor,
            "reduced_f32_logit_rel_err": small_err, "wall_s": wall,
            "placed": placed, "unplaced": unplaced,
            "cache_block_bytes": block_bytes, "peak_allocated_bytes": peak,
            "parameters": n, "weight_bytes": nbytes, "init_s": init_s,
            "attention_layers": attn_layers}


def serve_placed_phase(smi_line: str, device: str = "cuda",
                       archs=None, reduced: bool = False) -> dict:
    """The serve phase's placed part (``SERVE_PLACED``): each model's
    placed prefill and decode steps on a one-rank NCCL group (a
    ``FileStore`` in a temporary directory; gloo on the CPU) with a (1, 1)
    mesh of ranks, against the unplaced steps (:func:`serve_placed_model`);
    the group is destroyed.  The counts are the placed runs' (summed over
    the models)."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    models, counts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            for name in archs or SERVE_PLACED["archs"]:
                rec = serve_placed_model(name, mesh, smi_line, device,
                                         reduced)
                models[name] = rec
                for key, v in rec["counts"].items():
                    counts[key] = counts.get(key, 0) + v
        finally:
            dist.destroy_process_group()
    return {"counts": counts, "models": models}


# --------------------------------------------------------------------- moe

def _moe_dense_f64(cfg, p, xt, top_e) -> tuple:
    """tests/test_model_numerics.py's dense formula in f64: every token
    through every expert, weighted by the renormalised gate at the layer's
    own top-k choice ``top_e``.  Also returns how many tokens the f64
    router would send to another top-k set."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.layers import _gelu_tanh
    x = xt.double()
    probs = torch.softmax(x @ p["router"].double(), -1)
    k = cfg.experts_per_token
    own = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :k]
    moved = int((own.sort(-1).values != top_e.sort(-1).values).any(-1).sum())
    gate = probs.gather(1, top_e)
    gates = torch.zeros_like(probs).scatter(
        1, top_e, gate / gate.sum(-1, keepdim=True))

    def mlp(w_up, w_gate, w_down):
        up = x @ w_up.double()
        up = (F.silu(x @ w_gate.double()) * up if w_gate is not None
              else _gelu_tanh(up))
        return up @ w_down.double()
    out = torch.zeros_like(x)
    for e in range(cfg.num_experts):
        out += gates[:, e, None] * mlp(
            p["w_up"][e], p["w_gate"][e] if "w_gate" in p else None,
            p["w_down"][e])
    if "shared" in p:
        s = p["shared"]
        out += mlp(s["w_up"], s.get("w_gate"), s["w_down"])
    return out, moved


def _stage_device(fn) -> dict:
    """Device µs and launches per call of ``fn`` (``torch.profiler`` over
    three calls)."""
    rows = _device_rows(fn, 3)
    return {"device_us": sum(_device_us(e) for e in rows) / 3,
            "launches": sum(e.count for e in rows) / 3}


def moe_layer_checks(cfg, params, device: str = "cuda") -> dict:
    """Layer 0 of a loaded full-width MoE model alone, at T = 4 (a decode
    step) and 64 (a prefill chunk): ``moe_forward`` against the dense
    all-experts formula in f64 (``MOE_LAYER_TOL``), once under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync) and bitwise
    equal to the first call (no atomics); and the layer's device µs split
    into router/dispatch, expert ``bmm``, combine and the shared experts."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.mlp import mlp_forward
    from repro_torch.models.transformer import layer_views
    p = layer_views(params["blocks"], cfg.num_layers)[0]["moe"]
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    out = {}
    for T in MOE_LAYER_TOKENS:
        x = torch.randn((1, T, cfg.d_model), generator=gen,
                        device=device).to(p["w_up"].dtype)
        xt = x.reshape(T, -1)
        got, aux = moe.moe_forward(cfg, p, x)
        probs, top_p, top_e = moe.route(cfg, p["router"], xt)
        want, moved = _moe_dense_f64(cfg, p, xt, top_e)
        err = float((got.reshape(T, -1).double() - want).abs().max()
                    / want.abs().max())
        need(err <= MOE_LAYER_TOL, f"moe {cfg.name}: layer at T={T} vs the "
             f"dense f64 formula {err:.3e} of max > {MOE_LAYER_TOL}")
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again, aux2 = moe.moe_forward(cfg, p, x)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        need(torch.equal(got, again) and torch.equal(aux, aux2),
             f"moe {cfg.name}: two calls of the layer at T={T} differ")
        buf, placed = moe.dispatch(cfg, xt, top_e)
        out_buf = moe.experts(p, buf)

        def front():
            probs, _, top_e = moe.route(cfg, p["router"], xt)
            moe.aux_loss(cfg, probs, top_e)
            return moe.dispatch(cfg, xt, top_e)
        split = {"router_dispatch": _stage_device(front),
                 "experts_bmm": _stage_device(lambda: moe.experts(p, buf)),
                 "combine": _stage_device(
                     lambda: moe.combine(out_buf, top_p, placed))}
        if "shared" in p:
            split["shared"] = _stage_device(
                lambda: mlp_forward(cfg, p["shared"], xt))
        layer = _stage_device(lambda: moe.moe_forward(cfg, p, x))
        layer_ms = _event_ms(lambda: moe.moe_forward(cfg, p, x), reps=10)
        weight_bytes = sum(p[w].numel() * p[w].element_size()
                           for w in ("w_up", "w_gate", "w_down") if w in p)
        out[f"T{T}"] = {"rel_err_vs_dense_f64": err, "tolerance":
                        MOE_LAYER_TOL, "f64_router_moved_tokens": moved,
                        "no_host_sync": True, "bitwise_repeatable": True,
                        "capacity": moe.capacity(cfg, T), "split": split,
                        "layer_device_us": layer["device_us"],
                        "layer_launches": layer["launches"],
                        "layer_event_ms": statistics.median(layer_ms),
                        "expert_weight_bytes": weight_bytes}
        log(f"moe {cfg.name}: layer 0 at T={T} (capacity "
            f"{moe.capacity(cfg, T)}): vs the dense f64 formula {err:.3e} of "
            f"max (tolerance {MOE_LAYER_TOL}; the f64 router moves {moved} "
            f"tokens); no host sync under set_sync_debug_mode('error'); two "
            f"calls bitwise equal; device {layer['device_us']:.1f} us in "
            f"{layer['launches']:g} launches, events "
            f"{statistics.median(layer_ms) * 1e3:.1f} us; split (device us, "
            f"launches): " + "; ".join(
                f"{k} {v['device_us']:.1f} ({v['launches']:g})"
                for k, v in split.items())
            + f"; expert weights {weight_bytes / 1e6:.1f} MB = "
            f"{weight_bytes / HBM_BYTES_PER_S * 1e6:.1f} us at the HBM rate")
    return {"layer": out}


def moe_phase(smi_line: str, device: str = "cuda", cfgs=None) -> dict:
    """Both MoE configs through :func:`serve_phase` at full width, each with
    its measured logit floor and :func:`moe_layer_checks`, one freed before
    the next.  ``cfgs`` ({name: (cfg, small)}) and ``device`` other than the
    defaults rehearse the phase's control flow at a small size."""
    import torch
    from repro_torch.configs import get_config
    out = {"counts": {}, "models": {}}
    for name in MOE_ARCHS:
        torch.cuda.empty_cache()
        cfg, small = cfgs[name] if cfgs else (get_config(name), None)
        rec = serve_phase(device, cfg, small=small,
                          logit_tol=1.5 * MOE_LOGIT_FLOOR[name],
                          tag=f"moe {name}", extra=moe_layer_checks)
        for key, v in rec.pop("counts").items():
            out["counts"][key] = out["counts"].get(key, 0) + v
        out["models"][name] = rec
        busy = rec["device_busy"]
        log(f"moe {name} ({smi_line}): {rec['tokens_per_s']:.1f} tokens/s; "
            f"decode step {rec['decode_step_ms_alone']:.2f} ms against the "
            f"{rec['decode_step_bound_ms']:.3f} ms weight-read bound; device "
            + ("busy not measured" if busy is None else
               f"busy {busy['busy_ms'] / rec['decode_step_ms_alone']:.1%}")
            + f"; flash_decode {rec['bodies']}")
    return out


# --------------------------------------------------------------- recurrent

def _state_bytes(cache) -> int:
    """Bytes of a cache's recurrent states (every field of ``cache.ssm``)."""
    return sum(t.numel() * t.element_size() for t in cache.ssm)


def _clone_cache(cache):
    """A copy of an LMCache whose tensors share nothing with ``cache``."""
    def copy(field):
        return None if field is None else type(field)(*(t.clone()
                                                        for t in field))
    return cache._replace(kv=copy(cache.kv), ssm=copy(cache.ssm),
                          shared_kv=copy(cache.shared_kv))


def recurrent_step_bound(cfg, params, cache) -> dict:
    """The byte bound of one lockstep decode step at ``cache.position``:
    every weight but the embedding read once (the hybrid's shared block
    once per group: it is applied n_groups times and, at 134 MB, does not
    stay in the 50 MB L2), the B embedding rows, the recurrent states read
    and written, and the hybrid's shared K/V rows up to the position read
    (plus one row written) in every group.  The operations (2 per weight
    and token, at the bf16 tensor-core rate) are far below it."""
    from repro_torch.core.flatten import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    B = cache.ssm[0].shape[1]
    embed = params["embed"]
    weights = nbytes(params) - nbytes(embed) + B * embed[0].numel() * \
        embed.element_size()
    kv = 0
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.attn_every
        weights += (groups - 1) * nbytes(params["shared_attn"])
        k = cache.shared_kv.k
        row = B * k.shape[3] * k.shape[4] * k.element_size()
        kv = groups * 2 * row * (cache.position + 2)
    total = weights + 2 * _state_bytes(cache) + kv
    n = sum(t.numel() for t in tree_leaves(params))
    return dict(bound(total, 2 * n * B / PEAK_FLOPS["bfloat16"]),
                weight_bytes=weights, state_bytes=_state_bytes(cache),
                kv_bytes=kv)


def _teacher_forced(cfg, params, prompt, given, max_seq) -> list:
    """The logits of prefill(prompt) and of a decode step on each token of
    ``given`` (B, T) in turn."""
    from repro_torch.models import transformer as ttf
    logits, cache = ttf.prefill(cfg, params, prompt, max_seq)
    out = [logits]
    for t in range(given.shape[1]):
        logits, cache = ttf.decode_step(cfg, params, given[:, t], cache)
        out.append(logits)
    return out


def lockstep_small(small, device: str = "cuda") -> dict:
    """The reduced f32 config served through the lockstep loop on the card
    and on the CPU from the same CPU-drawn weights and prompt (frames or
    image embeddings included): equal greedy tokens, and the first decode
    step's logits within SERVE_LOGIT_TOL_F32."""
    import torch
    from repro_torch.core.flatten import tree_map
    from repro_torch.launch.serve import (lockstep, lockstep_max_seq,
                                          lockstep_prompt)
    from repro_torch.models import get_model
    bundle = get_model(small)
    gen = torch.Generator()
    gen.manual_seed(0)
    cpu_params = bundle.init(gen)
    card_params = tree_map(lambda a: a.to(device), cpu_params)
    prompt = lockstep_prompt(small, RECURRENT["batch"],
                             RECURRENT["small_prompt"], torch.device("cpu"))
    max_seq = lockstep_max_seq(small, RECURRENT["small_prompt"],
                               RECURRENT["small_new"])
    card = lockstep(bundle, card_params,
                    tree_map(lambda a: a.to(device), prompt),
                    RECURRENT["small_new"], max_seq)
    cpu = lockstep(bundle, cpu_params, prompt, RECURRENT["small_new"],
                   max_seq)
    need(torch.equal(card.tokens.cpu(), cpu.tokens),
         f"{small.name}: reduced f32 tokens card {card.tokens.tolist()} != "
         f"CPU {cpu.tokens.tolist()}")
    step_err = _logit_err(card.logits[:, 1].cpu(), cpu.logits[:, 1])
    all_err = _logit_err(card.logits.cpu(), cpu.logits)
    need(step_err <= SERVE_LOGIT_TOL_F32, f"{small.name}: reduced f32 "
         f"decode-step logits card vs CPU {step_err:.3e} > "
         f"{SERVE_LOGIT_TOL_F32}")
    return {"tokens": int(cpu.tokens.numel()),
            "logit_rel_err_card_vs_cpu_step": step_err,
            "logit_rel_err_card_vs_cpu_all_steps": all_err}


def _written(cache) -> list:
    """The tensors of a lockstep cache that a decode step writes (whisper's
    cross K/V are written once, by prefill)."""
    if hasattr(cache, "self_kv"):
        return list(cache.self_kv)
    return [t for field in (cache.kv, cache.ssm, cache.shared_kv)
            if field is not None for t in field]


def _clone_written(cache):
    """A copy of a lockstep cache whose written tensors share nothing with
    ``cache``."""
    if hasattr(cache, "self_kv"):
        return cache._replace(self_kv=type(cache.self_kv)(
            *(t.clone() for t in cache.self_kv)))
    return _clone_cache(cache)


def _lockstep_main_path(tag: str, bundle, params, batch, max_seq: int
                        ) -> tuple:
    """The main path: ``repro_torch.launch.serve.lockstep`` on ``batch``
    with every launch counter reset before it; gates no kernel or plain
    kernel version launched, every row's RECURRENT["new"] tokens, finite
    logits.  Returns (run, counts, peak allocated bytes, tokens/s)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import lockstep
    R = RECURRENT
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    run = lockstep(bundle, params, batch, R["new"], max_seq)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    need(not any(counts.values()), f"{tag}: kernels or plain kernel "
         f"versions ran on the path: "
         f"{ {k: v for k, v in counts.items() if v} }")
    need(tuple(run.tokens.shape) == (R["batch"], R["new"]),
         f"{tag}: tokens {tuple(run.tokens.shape)}")
    need(bool(torch.isfinite(run.logits).all()), f"{tag}: non-finite "
         "logits")
    steps = R["new"] - 1
    tok_s = R["batch"] * steps / run.decode_s
    inputs = ", ".join(f"{k} {tuple(v.shape)} {v.dtype}"
                       for k, v in batch.items())
    log(f"{tag}: lockstep batch {R['batch']} prompt {R['prompt']} new "
        f"{R['new']} ({inputs}; {max_seq} cache rows): prefill "
        f"{run.prefill_s * 1e3:.1f} ms (first call), {steps} decode steps "
        f"{run.decode_s * 1e3:.1f} ms = {tok_s:.1f} tokens/s; peak "
        f"allocated {peak / 2**30:.2f} GiB; first sequence "
        f"{run.tokens[0, :16].tolist()}; launch counts all 0")
    return run, counts, peak, tok_s


def _lockstep_step(tag: str, bundle, params, batch, max_seq: int, tok,
                   step_bound, smi_line: str) -> dict:
    """One decode step alone after a fresh prefill of ``batch``: prefill
    and step CUDA-event ms, ``step_bound(cache)`` (a dict from ``bound``
    with its byte parts), device busy ms and launches a step
    (``_device_rows``), the cache's dtypes; gates no host sync in a step
    and two steps from copies of one cache bitwise equal."""
    import torch
    R = RECURRENT
    _, cache = bundle.prefill(params, batch, max_seq)
    step = lambda: bundle.decode(params, tok, cache)   # noqa: E731
    prefill_ms = _event_ms(lambda: bundle.prefill(params, batch, max_seq),
                           reps=3, warmup=1)
    step_ms = sorted(_event_ms(step, reps=R["timed_steps"]))
    step_med = statistics.median(step_ms)
    b = step_bound(cache)
    rows = _device_rows(step, 2)
    busy_ms = sum(_device_us(e) for e in rows) / 2 / 1e3
    launches = sum(e.count for e in rows) / 2
    top = sorted(rows, key=lambda e: -_device_us(e))[:6]
    parts = ", ".join(f"{k} {v} B" for k, v in b.items()
                      if k.endswith("_bytes"))
    log(f"{tag} ({smi_line}): prefill B={R['batch']} S={R['prompt']} "
        f"median {statistics.median(prefill_ms):.1f} ms "
        f"[{min(prefill_ms):.1f}-{max(prefill_ms):.1f}]; decode step alone "
        f"median {step_med:.3f} ms [{step_ms[0]:.3f}-{step_ms[-1]:.3f}] "
        f"against the {b['bound_ms']:.3f} ms bound by {b['bound_by']} "
        f"({b['bound_ms'] / step_med:.1%}; {parts}); device busy "
        + ("not measured (no device time in the trace)" if busy_ms <= 0 else
           f"{busy_ms:.3f} ms a step ({busy_ms / step_med:.1%}, idle "
           f"{1 - busy_ms / step_med:.1%}) in {launches:g} kernel launches; "
           "top: " + "; ".join(f"{e.key[:48]} {_device_us(e) / 2e3:.3f} ms "
                               f"({e.count / 2:g})" for e in top)))
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bundle.decode(params, tok, _clone_written(cache))
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    a_lg, a_c = bundle.decode(params, tok, _clone_written(cache))
    b_lg, b_c = bundle.decode(params, tok, _clone_written(cache))
    need(torch.equal(a_lg, b_lg) and all(
        torch.equal(x, y) for x, y in zip(_written(a_c), _written(b_c))),
        f"{tag}: two decode steps from copies of one cache differ")
    dtypes = {str(t.dtype) for t in _written(cache)} | {
        str(t.dtype) for t in cache if isinstance(t, torch.Tensor)}
    return {"prefill_ms": statistics.median(prefill_ms),
            "prefill_ms_all": prefill_ms, "cache_dtypes": sorted(dtypes),
            "decode_step_ms_alone": step_med,
            "decode_step_ms_alone_all": step_ms,
            "decode_step_bound_ms": b["bound_ms"],
            "decode_step_bound": b,
            "device_busy_ms": busy_ms if busy_ms > 0 else None,
            "launches_per_step": launches}


def _log_small(tag: str, small, smalled: dict) -> None:
    log(f"{tag}: reduced f32 {small.name} tokens equal on card and CPU "
        f"({smalled['tokens']} tokens), first decode step's logits "
        f"{smalled['logit_rel_err_card_vs_cpu_step']:.3e} apart (all steps "
        f"{smalled['logit_rel_err_card_vs_cpu_all_steps']:.3e}; tolerance "
        f"{SERVE_LOGIT_TOL_F32})")


def _init_on_card(tag: str, cfg, smi_line: str, device: str) -> tuple:
    """The model's seeded bf16 params on the card: (bundle, params,
    parameter count, weight bytes, init seconds)."""
    import torch
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.models import get_model
    bundle = get_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = bundle.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in tree_leaves(params))
    nbytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    log(f"{tag} ({smi_line}): {cfg.family} L={cfg.num_layers} "
        f"d={cfg.d_model} d_ff={cfg.d_ff} vocab={cfg.vocab_size}"
        + (f" heads {cfg.num_heads}/{cfg.num_kv_heads}" if cfg.num_heads
           else "")
        + (f" attn_every {cfg.attn_every} ssm_state {cfg.ssm_state}"
           if cfg.family == "hybrid" else "")
        + (f", {cfg.encoder_layers} encoder layers over "
           f"{cfg.max_source_positions} frames" if cfg.family == "audio"
           else "")
        + (f", {cfg.num_image_tokens} image tokens" if cfg.family == "vlm"
           else "")
        + f" bf16: {n} parameters, {nbytes} B, init {init_s:.1f} s")
    return bundle, params, n, nbytes, init_s


def recurrent_model(cfg, small, floor, smi_line: str,
                    device: str = "cuda") -> dict:
    """One recurrent config at full width through the lockstep loop, with
    the phase's gates and numbers (see ``recurrent_phase``)."""
    import torch
    from repro_torch.core.flatten import tree_map
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import lockstep_prompt
    from repro_torch.models import transformer as ttf
    tag = f"recurrent {cfg.name}"
    R = RECURRENT
    bundle, params, n, weight_bytes, init_s = _init_on_card(
        tag, cfg, smi_line, device)
    batch = lockstep_prompt(cfg, R["batch"], R["prompt"],
                            torch.device(device))
    prompt = batch["tokens"]
    max_seq = R["prompt"] + R["new"]
    run, counts, peak, tok_s = _lockstep_main_path(tag, bundle, params,
                                                   batch, max_seq)
    numbers = _lockstep_step(
        tag, bundle, params, batch, max_seq, run.tokens[:, 0],
        lambda cache: recurrent_step_bound(cfg, params, cache), smi_line)

    # the same weights in f32: the bf16 logits against them on the same
    # tokens, and chunked prefill = recurrent decode (TF32 off)
    p32 = tree_map(lambda a: a.float(), params)
    cfg32 = cfg.with_overrides(dtype="float32")
    f32 = _teacher_forced(cfg32, p32, prompt, run.tokens[:, :-1], max_seq)
    bf16_err = max(_logit_err(run.logits[:, t], f32[t])
                   for t in range(R["new"]))
    chunk_err = 0.0
    for t in range(1, R["given"] + 1):
        full = torch.cat([prompt, run.tokens[:, :t]], 1)
        lg, _ = ttf.prefill(cfg32, p32, full, max_seq)
        chunk_err = max(chunk_err, _logit_err(f32[t], lg))
    del p32, f32
    gate = None if floor is None else 1.5 * floor
    log(f"{tag}: f32 chunked prefill of {R['prompt']}+t vs recurrent decode "
        f"t = 1..{R['given']}: {chunk_err:.3e} of max |logit| (gate "
        f"{RECURRENT_CHUNK_TOL}); bf16 vs f32 logits over {R['new']} steps "
        f"{bf16_err:.3e} (floor {floor}, gate "
        + ("not set" if gate is None else f"{gate:.4g}") + ")")
    need(chunk_err <= RECURRENT_CHUNK_TOL, f"{tag}: chunked vs recurrent "
         f"{chunk_err:.3e} > {RECURRENT_CHUNK_TOL}")
    need(gate is not None and bf16_err <= gate, f"{tag}: bf16 vs f32 "
         f"logits {bf16_err:.3e}, gate {gate}")
    del params
    torch.cuda.empty_cache()

    smalled = lockstep_small(small, device)
    _log_small(tag, small, smalled)
    need(not any(launch_counts().values()), f"{tag}: kernels or plain "
         "kernel versions ran in the phase's checks")
    return {"counts": counts, "parameters": n, "weight_bytes": weight_bytes,
            "init_s": init_s, "prefill_s_first": run.prefill_s,
            **numbers, "decode_s": run.decode_s, "decode_steps": R["new"] - 1,
            "tokens_per_s": tok_s, "peak_allocated_bytes": peak,
            "chunked_vs_recurrent_f32": chunk_err,
            "bf16_vs_f32": bf16_err, "bf16_vs_f32_floor": floor,
            "bf16_vs_f32_tolerance": gate, "reduced_f32": smalled,
            "nvidia_smi": smi_line}


def recurrent_phase(smi_line: str, device: str = "cuda",
                    cfgs=None) -> dict:
    """rwkv6-1.6b, then zamba2-1.2b, at full width through the lockstep
    loop, each freed before the next.  ``cfgs`` ({name: (cfg, small)}) and
    ``device`` other than the defaults rehearse the phase's control flow at
    a small size."""
    import torch
    from repro_torch.configs import get_config
    out = {"counts": {}, "models": {}}
    for name in RECURRENT_ARCHS:
        torch.cuda.empty_cache()
        cfg, small = cfgs[name] if cfgs else (
            get_config(name),
            get_config(name).reduced(**RECURRENT_SMALL[name]))
        rec = recurrent_model(cfg, small, RECURRENT_LOGIT_FLOOR[name],
                              smi_line, device)
        for key, v in rec.pop("counts").items():
            out["counts"][key] = out["counts"].get(key, 0) + v
        out["models"][name] = rec
    return out


# ------------------------------------------------ encoder-decoder and VLM

def lockstep_step_bound(cfg, params, cache) -> dict:
    """The bound of one whisper or chameleon decode step at
    ``cache.position``.

    Bytes: every weight the step reads once (whisper: the decoder's, not
    the cross-attention's wk / wv, whose K/V were cached at prefill, nor the
    encoder's; chameleon: all but ``img_proj``), the B embedding rows, the
    self K/V rows up to the position read and one row written in every
    layer, and whisper's cross K/V read whole (f32 under the loop's f32
    frames).  Operations: 2 per weight and token at the bf16 tensor-core
    rate, plus the attention's q·k and p·v over those rows in f32 (the
    plain step computes them in f32)."""
    from repro_torch.core.flatten import tree_leaves_with_path
    kv = _written(cache)
    L, B = kv[0].shape[0], kv[0].shape[1]
    embed = params["embed"]
    skip = (("embed", "enc_blocks", "enc_norm", "dec_blocks/cross/wk",
             "dec_blocks/cross/wv") if cfg.family == "audio"
            else ("embed", "img_proj"))
    weights = [t for path, t in tree_leaves_with_path(params)
               if not any(path == k or path.startswith(k + "/")
                          for k in skip)]
    weight_bytes = sum(t.numel() * t.element_size() for t in weights) + \
        B * embed[0].numel() * embed.element_size()
    rows = cache.position + 1
    row = kv[0][0, :, 0].numel() * kv[0].element_size()
    kv_bytes = 2 * L * row * (rows + 1)
    cross_bytes = 0
    if cfg.family == "audio":
        cross_bytes = sum(t.numel() * t.element_size()
                          for t in (cache.cross_k, cache.cross_v))
        rows += cache.cross_k.shape[2]
    attn_ops = 4 * B * cfg.num_heads * cfg.resolved_head_dim * rows * L
    n = sum(t.numel() for t in weights)
    ops_s = 2 * n * B / PEAK_FLOPS["bfloat16"] + \
        attn_ops / PEAK_FLOPS["float32"]
    return dict(bound(weight_bytes + kv_bytes + cross_bytes, ops_s),
                weight_bytes=weight_bytes, kv_bytes=kv_bytes,
                cross_bytes=cross_bytes)


def _cut_model(cfg, params, layers: int):
    """The config and a copy of params holding only the first ``layers``
    decoder layers (everything else copied too, so the full tree can be
    freed)."""
    from repro_torch.core.flatten import tree_map
    cut = {k: (tree_map(lambda a: a[:layers].clone(), v) if k == "blocks"
               else tree_map(lambda a: a.clone(), v))
           for k, v in params.items()}
    return cfg.with_overrides(num_layers=layers), cut


def _f32_checks(cfg, params, batch, bf16_run, max_seq) -> tuple:
    """The same weights in f32 (TF32 off) on the bf16 run's tokens: (bf16
    vs f32 logits over every step, prefill + decode at t = 0..given vs the
    teacher-forced forward), each max |dlogit| / max |logit|."""
    import torch
    from repro_torch.core.flatten import tree_map
    from repro_torch.models import get_model
    R = RECURRENT
    b32 = get_model(cfg.with_overrides(dtype="float32"))
    p32 = tree_map(lambda a: a.float(), params)
    logits, cache = b32.prefill(p32, batch, max_seq)
    f32 = [logits]
    for t in range(R["new"] - 1):
        logits, cache = b32.decode(p32, bf16_run.tokens[:, t], cache)
        f32.append(logits)
    del cache
    bf16_err = max(_logit_err(bf16_run.logits[:, t], f32[t])
                   for t in range(R["new"]))
    toks = torch.cat([batch["tokens"], bf16_run.tokens[:, :R["given"]]], 1)
    full = b32.forward(p32, dict(batch, tokens=toks))
    off = cfg.num_image_tokens if cfg.family == "vlm" else 0
    last = off + batch["tokens"].shape[1] - 1
    decode_err = max(_logit_err(f32[t], full[:, last + t])
                     for t in range(R["given"] + 1))
    return bf16_err, decode_err


def lockstep_model(phase: str, cfg, small, floor, smi_line: str,
                   cut=None, device: str = "cuda") -> dict:
    """One encoder-decoder or VLM config at full width through the lockstep
    loop, with the phase's gates and numbers (see ``lockstep_phase``)."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import (lockstep, lockstep_max_seq,
                                          lockstep_prompt)
    from repro_torch.models import get_model
    tag = f"{phase} {cfg.name}"
    R = RECURRENT
    torch.cuda.empty_cache()
    bundle, params, n, weight_bytes, init_s = _init_on_card(
        tag, cfg, smi_line, device)
    batch = lockstep_prompt(cfg, R["batch"], R["prompt"],
                            torch.device(device))
    max_seq = lockstep_max_seq(cfg, R["prompt"], R["new"])
    run, counts, peak, tok_s = _lockstep_main_path(tag, bundle, params,
                                                   batch, max_seq)
    numbers = _lockstep_step(
        tag, bundle, params, batch, max_seq, run.tokens[:, 0],
        lambda cache: lockstep_step_bound(cfg, params, cache), smi_line)

    # f32 (TF32 off): bf16 vs f32 on the same tokens, and prefill + decode
    # = the teacher-forced forward; chameleon on its first `cut` layers
    if cut:
        ccfg, cparams = _cut_model(cfg, params, cut)
        del params
        torch.cuda.empty_cache()
        crun = lockstep(get_model(ccfg), cparams, batch, R["new"], max_seq)
        log(f"{tag}: f32 checks on the full-width config cut to its first "
            f"{cut} of {cfg.num_layers} layers (bf16 run of the cut, then "
            "its f32 copy)")
    else:
        ccfg, cparams, crun = cfg, params, run
        del params
    bf16_err, decode_err = _f32_checks(ccfg, cparams, batch, crun, max_seq)
    del cparams, crun
    torch.cuda.empty_cache()
    gate = None if floor is None else 1.5 * floor
    log(f"{tag}: f32 at " + (f"the {cut}-layer cut" if cut else "full depth")
        + f" (the bf16 run's cache dtypes {numbers['cache_dtypes']}): "
        f"prefill + decode t = 0..{R['given']} vs the teacher-forced "
        f"forward {decode_err:.3e} of max |logit| (gate "
        f"{RECURRENT_CHUNK_TOL}); bf16 vs f32 logits over {R['new']} steps "
        f"{bf16_err:.3e} (floor {floor}, gate "
        + ("not set" if gate is None else f"{gate:.4g}") + ")")
    need(decode_err <= RECURRENT_CHUNK_TOL, f"{tag}: decode vs forward "
         f"{decode_err:.3e} > {RECURRENT_CHUNK_TOL}")
    need(gate is not None and bf16_err <= gate, f"{tag}: bf16 vs f32 "
         f"logits {bf16_err:.3e}, gate {gate}")

    smalled = lockstep_small(small, device)
    _log_small(tag, small, smalled)
    need(not any(launch_counts().values()), f"{tag}: kernels or plain "
         "kernel versions ran in the phase's checks")
    return {"counts": counts, "parameters": n, "weight_bytes": weight_bytes,
            "init_s": init_s, "prefill_s_first": run.prefill_s,
            **numbers, "decode_s": run.decode_s, "decode_steps": R["new"] - 1,
            "tokens_per_s": tok_s, "peak_allocated_bytes": peak,
            "f32_layers": cut or cfg.num_layers,
            "decode_vs_forward_f32": decode_err,
            "bf16_vs_f32": bf16_err, "bf16_vs_f32_floor": floor,
            "bf16_vs_f32_tolerance": gate, "reduced_f32": smalled,
            "nvidia_smi": smi_line}


def lockstep_phase(smi_line: str, phase: str, device: str = "cuda",
                   cfgs=None) -> dict:
    """The ``whisper`` or ``chameleon`` phase: its config at full width
    through the lockstep loop (``lockstep_model``), then freed.  ``cfgs``
    ((cfg, small)) and ``device`` other than the defaults rehearse the
    phase's control flow at a small size."""
    import torch
    from repro_torch.configs import get_config
    name, cut = LOCKSTEP_PHASES[phase]
    cfg, small = cfgs if cfgs else (get_config(name),
                                    get_config(name).reduced())
    rec = lockstep_model(phase, cfg, small, LOCKSTEP_LOGIT_FLOOR[name],
                         smi_line, cut, device)
    torch.cuda.empty_cache()
    return {"counts": rec.pop("counts"), "models": {name: rec}}


# ------------------------------------------------------------------- train

_MANTISSA_BITS = {"bfloat16": 8, "float16": 11, "float32": 24}


def _ulp(x, dtype) -> "torch.Tensor":
    """The spacing of ``dtype`` numbers at each |x| (f32 tensor)."""
    import torch
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       e - _MANTISSA_BITS[_dtype_name(dtype)])


def sgd_step_check(cfg, params, new, batch, lr: float, alpha: float,
                   remat, chunk: int = 1 << 26) -> dict:
    """A C = 1 step's new params against plain SGD, leaf by leaf in chunks
    (g by autograd on the same batch): against the step's own formula,
    (p + α·Δ) in f32 cast once, Δ = (−lr·g in f32) cast to the leaf dtype
    (``max_ulps``), and against the plain step p − lr·g (``sgd_max_ulps``;
    α = 1/(1+ridge) is within a bf16 ulp of 1).  Each is the most any
    element is off, in ulps of the leaf's dtype at the largest of |p|,
    |Δ| and the plain value (an add's rounding, which cancellation can
    make many ulps of a small result); ``sgd_max_ulps_bf16`` takes the
    bf16 leaves alone."""
    import torch
    from repro_torch.core.flatten import tree_leaves_with_path
    from repro_torch.launch.steps import _loss_and_grads
    from repro_torch.models import get_model
    bundle = get_model(cfg)
    _, grads = _loss_and_grads(
        lambda p, b: bundle.train_loss(p, b, remat=remat)[0], params, batch)
    worst = {"max_ulps": (0.0, None), "sgd_max_ulps": (0.0, None),
             "sgd_max_ulps_bf16": (0.0, None)}
    largest = (None, 0)

    def off(got, want, mag, dt):
        return float(((got.float() - want.float()).abs()
                      / _ulp(torch.maximum(mag, want.float().abs()),
                             dt)).max())

    for i, ((name, p0), p1) in enumerate(zip(
            tree_leaves_with_path(params),
            [p for _, p in tree_leaves_with_path(new)])):
        a, b, g = p0.reshape(-1), p1.reshape(-1), grads[i].reshape(-1)
        for s in range(0, a.numel(), chunk):
            a_s, g_s, b_s = (a[s:s + chunk].float(), g[s:s + chunk].float(),
                             b[s:s + chunk])
            delta = (-lr * g_s).to(a.dtype).float()
            mag = torch.maximum(a_s.abs(), delta.abs())
            found = {"max_ulps": off(b_s, (a_s + alpha * delta).to(a.dtype),
                                     mag, a.dtype)}
            found["sgd_max_ulps"] = off(b_s, (a_s - lr * g_s).to(a.dtype),
                                        mag, a.dtype)
            if a.dtype == torch.bfloat16:
                found["sgd_max_ulps_bf16"] = found["sgd_max_ulps"]
            for k, v in found.items():
                if v > worst[k][0]:
                    worst[k] = (v, name)
        if a.numel() > largest[1]:
            largest = (name, a.numel())
        grads[i] = None
    return {**{k: v for k, (v, _) in worst.items()},
            **{k + "_leaf": name for k, (_, name) in worst.items()},
            "largest_leaf": largest[0], "largest_leaf_numel": largest[1]}


def train_step_bound(cfg, params, tokens: int, cohorts: int) -> dict:
    """The least time of one train step: bytes — per cohort the weights
    read by one forward and one backward and the grads written (3W), then
    the apply's reads of w and the C stacked Δ and its write ((C + 2)W) —
    against 6 FLOP per active parameter per token (forward 2, backward 4;
    MoE experts counted at top-k of E) at the bf16 peak.  What remat
    "full" adds on top, the re-forward (W a cohort, 2 FLOP per active
    parameter-token), is kept apart as ``reforward_*`` and
    ``bound_with_reforward_ms``: the cost of the policy, not of the step."""
    from repro_torch.core.flatten import tree_leaves_with_path
    leaves = tree_leaves_with_path(params)
    W = sum(p.numel() * p.element_size() for _, p in leaves)
    n = sum(p.numel() for _, p in leaves)
    experts = sum(p.numel() for name, p in leaves if "moe/w_" in name)
    active = n - experts + (experts * cfg.experts_per_token
                            / cfg.num_experts if experts else 0)
    flops = 6 * active * tokens
    b = bound((3 * cohorts + cohorts + 2) * W,
              flops / PEAK_FLOPS["bfloat16"])
    re_bytes, re_flops = cohorts * W, 2 * active * tokens
    b.update(weight_bytes=W, parameters=n, active_parameters=active,
             flops=flops, cohorts=cohorts, tokens=tokens,
             reforward_bytes=re_bytes, reforward_flops=re_flops,
             bound_with_reforward_ms=bound(
                 b["bytes"] + re_bytes,
                 (flops + re_flops) / PEAK_FLOPS["bfloat16"])["bound_ms"])
    return b


def _train_device(tag: str, fn, step_ms: float, smi_line: str) -> dict:
    """Device busy ms, idle share and launches of one call of ``fn`` (a
    train step) from ``_device_rows``, with the top kernels logged."""
    rows = _device_rows(fn, 1)
    busy = sum(_device_us(e) for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -_device_us(e))[:6]
    log(f"{tag} ({smi_line}): device busy "
        + ("not measured (no device time in the trace)" if busy <= 0 else
           f"{busy:.2f} ms of a {step_ms:.2f} ms step (idle "
           f"{1 - busy / step_ms:.1%}) in {launches} kernel launches; top: "
           + "; ".join(f"{e.key[:48]} {_device_us(e) / 1e3:.2f} ms "
                       f"({e.count})" for e in top)))
    return {"device_busy_ms": busy if busy > 0 else None,
            "idle_share": 1 - busy / step_ms if busy > 0 else None,
            "launches_per_step": launches}


def _step_peak(tag: str, fn) -> dict:
    """One call of ``fn`` (a train step) with its inputs resident: the bytes
    allocated before it and its peak (``reset_peak_memory_stats`` before the
    step, ``max_memory_allocated`` after) — what the ``roofline`` phase's
    dry run predicts."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    log(f"{tag}: one step with its inputs resident: peak allocated "
        f"{peak} B ({peak / 2**30:.2f} GiB), {before} B allocated before it")
    return {"step_peak_allocated_bytes": peak,
            "allocated_before_step_bytes": before}


def _path_counts(tag: str, counts: dict, want: dict) -> None:
    """Every launch counter of a train run: the ``want`` ones exactly, the
    rest 0 (no plain version ran on the card)."""
    got = {k: v for k, v in counts.items() if v}
    need(got == {k: v for k, v in want.items() if v},
         f"{tag}: launches {got}, want {want}")


def train_entry(smi_line: str, device: str = "cuda",
                reduced: bool = False) -> dict:
    """(a) ``python -m repro_torch.launch.train --arch olmoe-1b-7b --steps
    3 --batch 8 --seq 128`` in-process (``launch.train.run``): the host
    mesh of one card, C = 1, remat "full".  Gates finite losses, α =
    1/(1+ridge) to ``TRAIN_ALPHA_TOL`` every step, the first step's new
    params within one ulp of a plain SGD step in every element, gram once
    and combine once per leaf a step (the 2³¹-element expert leaves among
    them) and no plain version.  ``reduced`` and ``device="cpu"``
    rehearse the control flow at a small size."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves_with_path
    from repro_torch.kernels import (combine, gram, launch_counts,
                                     reset_launch_counts)
    from repro_torch.launch import train as tr
    from repro_torch.models import get_model
    T = TRAIN
    tag = f"train {T['arch']}"
    args = tr.parse_args(["--arch", T["arch"], "--steps", str(T["steps"]),
                          "--batch", str(T["batch"]), "--seq", str(T["seq"]),
                          "--lr", str(T["lr"]), "--device", device]
                         + (["--reduced"] if reduced else []))
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if reduced else cfg
    remat = not reduced
    checks, peaks = {}, []

    def on_step(i, params, new, batch, metrics):
        peaks.append(torch.cuda.max_memory_allocated())
        if i == 0:
            checks.update(sgd_step_check(
                cfg, params, new, batch, T["lr"],
                float(metrics["alpha"][0]), remat))
            checks["bound"] = train_step_bound(cfg, params,
                                               T["batch"] * T["seq"], 1)
            checks["leaves"] = [(name, p.numel())
                                for name, p in tree_leaves_with_path(params)]
            checks["batch"] = batch
            torch.cuda.reset_peak_memory_stats()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    gram.reset_body_launches()
    combine.reset_body_launches()
    t0 = time.perf_counter()
    out = tr.run(args, on_step=on_step)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    gram_bodies = gram.body_launches()
    combine_bodies = combine.body_launches()
    peak = max(peaks + [torch.cuda.max_memory_allocated()])
    hist, steps = out["history"], T["steps"]
    n_leaves = len(checks["leaves"])
    want_alpha = 1.0 / (1.0 + T["ridge"])
    for i, h in enumerate(hist):
        need(math.isfinite(h["loss"]), f"{tag}: step {i} loss {h['loss']}")
        need(abs(float(h["alpha"][0]) - want_alpha) <= TRAIN_ALPHA_TOL,
             f"{tag}: step {i} alpha {h['alpha']}, want {want_alpha}")
    need(checks["max_ulps"] <= 1.0 and checks["sgd_max_ulps_bf16"] <= 1.0,
         f"{tag}: new params {checks['max_ulps']:.3g} ulp from p + alpha "
         f"Delta (leaf {checks['max_ulps_leaf']}), bf16 leaves "
         f"{checks['sgd_max_ulps_bf16']:.3g} ulp from p - lr g (leaf "
         f"{checks['sgd_max_ulps_bf16_leaf']})")
    _path_counts(tag, counts, {"gram/cuda": steps,
                               "combine/cuda": steps * n_leaves})
    need(gram_bodies == {"mma": 0, "realign": 0, "f32": steps,
                         "cuda_core": 0},
         f"{tag}: gram bodies {gram_bodies}")
    big = [(name, n) for name, n in checks["leaves"] if n >= 1 << 31]
    need(reduced or len(big) == 3, f"{tag}: leaves of 2^31 elements {big}")
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    tokens = T["batch"] * T["seq"]
    b = checks["bound"]
    log(f"{tag} ({smi_line}): launch.train --steps {steps} --batch "
        f"{T['batch']} --seq {T['seq']} on mesh {dict(out['mesh'].shape)}, "
        f"remat {remat}: losses {[round(h['loss'], 4) for h in hist]}, "
        f"alpha {[float(h['alpha'][0]) for h in hist]} (want "
        f"{want_alpha!r}); step ms {[round(h['ms'], 2) for h in hist]} "
        f"(median of steps 2-{steps}: {step_ms:.2f}) against the "
        f"{b['bound_ms']:.2f} ms bound by {b['bound_by']} "
        f"({b['bound_ms'] / step_ms:.1%}; {b['bytes'] / 1e9:.1f} GB, "
        f"{b['flops'] / 1e12:.2f} TFLOP; "
        f"{b['bound_with_reforward_ms']:.2f} ms with remat's re-forward); "
        f"{tokens / step_ms * 1e3:.0f} "
        f"tokens/s; peak allocated {peak / 2**30:.2f} GiB; {wall:.1f} s in "
        f"all (init included); new params {checks['max_ulps']:.3g} ulp at "
        f"most from p + alpha Delta, {checks['sgd_max_ulps']:.3g} from "
        f"p - lr g ({checks['sgd_max_ulps_bf16']:.3g} on the bf16 leaves; "
        f"leaf {checks['sgd_max_ulps_leaf']}); {n_leaves} "
        f"leaves, {len(big)} of >= 2^31 elements {big}; launches "
        f"{ {k: v for k, v in counts.items() if v} }; gram bodies "
        f"{gram_bodies}, combine bodies {combine_bodies}")
    params, step, batch = out["params"], out["step"], checks.pop("batch")
    del out
    stepped = _step_peak(tag, lambda: step(params, batch))
    dev = _train_device(tag, lambda: step(params, batch), step_ms, smi_line)
    del params, batch
    torch.cuda.empty_cache()
    return {"counts": counts, "record": {
        "arch": cfg.name, "mesh": {"data": 1, "model": 1}, "cohorts": 1,
        "remat": "full" if remat else False, "batch": T["batch"],
        "seq": T["seq"], "losses": [h["loss"] for h in hist],
        "alpha": [float(h["alpha"][0]) for h in hist],
        "step_ms_all": [h["ms"] for h in hist], "step_ms": step_ms,
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "bound": b,
        "tokens_per_s": tokens / step_ms * 1e3,
        "peak_allocated_bytes": peak, "wall_s": wall,
        "step_formula_max_ulps": checks["max_ulps"],
        "sgd_max_ulps": checks["sgd_max_ulps"],
        "sgd_max_ulps_bf16": checks["sgd_max_ulps_bf16"], "leaves_2e31": big,
        "gram_bodies": gram_bodies, "combine_bodies": combine_bodies,
        **stepped, **dev, "nvidia_smi": smi_line}}


def _combine_vs_formula(out, w, U, alpha, chunk: int = 1 << 24) -> dict:
    """One combine launch's output against w + Σ α_k U_k on the same
    inputs, by chunks: in ulps of w's dtype against the f64 sum cast once
    (at the larger of |w| + Σ|α_k U_k| and the result), and in max |err|
    against the plain version (f32 sum cast once)."""
    import torch
    from repro_torch.kernels import ref
    ulps, err, rel = 0.0, 0.0, 0.0
    a64 = alpha.double()[:, None]
    for s in range(0, w.numel(), chunk):
        w_s, U_s, o_s = w[s:s + chunk], U[:, s:s + chunk], out[s:s + chunk]
        terms = a64 * U_s.double()
        exact = w_s.double() + terms.sum(0)
        mag = (w_s.double().abs() + terms.abs().sum(0)).float()
        del terms
        want = exact.to(w.dtype)
        ulps = max(ulps, float(((o_s.double() - want.double()).abs()
                                / _ulp(torch.maximum(mag, want.float().abs()),
                                       w.dtype).double()).max()))
        plain = ref.combine_ref(w_s, U_s, alpha)
        err = max(err, _max_err(o_s, plain))
        rel = max(rel, _max_err(o_s, plain) / _scale(plain))
    return {"max_ulps": ulps, "max_abs_err": err, "max_rel_err": rel}


def _combine_ulp_gate(dtype, K: int) -> float:
    """The most a combine output may be off the exact sum cast once, in
    ulps of its dtype at |w| + Σ|α_k U_k|: bf16, one (the f32 sum is far
    finer than a bf16 step, and both round to a neighbour of the exact
    value); f32, (K + 2)/2 (K fmaf roundings and the add of w, each at
    most half an ulp, and the cast of the exact sum)."""
    import torch
    return 1.0 if dtype == torch.bfloat16 else (K + 2) / 2


@contextlib.contextmanager
def checked_train_ops(found: dict):
    """While open, the train step's gram and combine calls
    (``launch.steps``' own names) launch their kernels as always, and each
    output is then held against its plain version on the same inputs:
    G and c against ``gram_ref`` (relative to max(1, max |plain|)), each
    leaf's combine against :func:`_combine_vs_formula`.  ``found`` gets
    one record a call.  The plain versions are the ``ref`` functions
    themselves, so no launch is counted for them."""
    from repro_torch.kernels import ref
    from repro_torch.launch import steps
    gram_fn, combine_fn = steps.gram_and_cross, steps.weighted_combine

    def gram_checked(U, g, **kw):
        G, c = gram_fn(U, g, **kw)
        Gp, cp = ref.gram_ref(U, g)
        found.setdefault("gram", []).append({
            "K": U.shape[0], "n": U.shape[1], "dtype": _dtype_name(U.dtype),
            "max_abs_err": max(_max_err(G, Gp), _max_err(c, cp)),
            "max_rel_err": max(_max_err(G, Gp) / _scale(Gp),
                               _max_err(c, cp) / _scale(cp))})
        return G, c

    def combine_checked(w, U, alpha, **kw):
        out = combine_fn(w, U, alpha, **kw)
        rec = _combine_vs_formula(out, w, U, alpha)
        rec.update(K=U.shape[0], n=U.shape[1], dtype=_dtype_name(w.dtype),
                   alpha=alpha.tolist(),
                   gate_ulps=_combine_ulp_gate(w.dtype, U.shape[0]))
        found.setdefault("combine", []).append(rec)
        return out

    steps.gram_and_cross = gram_checked
    steps.weighted_combine = combine_checked
    try:
        yield found
    finally:
        steps.gram_and_cross, steps.weighted_combine = gram_fn, combine_fn


def _gate_checked_step(tag: str, found: dict, n_leaves: int, alpha,
                       scope_n=None) -> dict:
    """Gates one checked step (:func:`checked_train_ops`): a combine per
    leaf, each within its ulp gate of the exact sum and within
    ``TOL[("combine", dtype)]`` of the plain version, on the α the step
    reports; with ``scope_n``, one gram of that many columns within
    ``TOL[("gram", dtype)]`` of the plain version.  Returns the worst."""
    comb = found.get("combine", [])
    need(len(comb) == n_leaves, f"{tag}: {len(comb)} combine calls checked, "
         f"want {n_leaves}")
    for r in comb:
        need(r["alpha"] == list(alpha), f"{tag}: the combine got alpha "
             f"{r['alpha']}, the step reports {list(alpha)}")
        need(r["max_ulps"] <= r["gate_ulps"]
             and r["max_rel_err"] <= TOL[("combine", r["dtype"])],
             f"{tag}: combine K={r['K']} n={r['n']} {r['dtype']} "
             f"{r['max_ulps']:.3g} ulp from the exact sum (gate "
             f"{r['gate_ulps']}), {r['max_rel_err']:.3e} from plain")
    worst = {"combine_calls": len(comb),
             "combine_max_ulps": max(r["max_ulps"] for r in comb),
             "combine_max_abs_err": max(r["max_abs_err"] for r in comb),
             "combine_largest_n": max(r["n"] for r in comb)}
    grams = found.get("gram", [])
    need(len(grams) == (scope_n is not None),
         f"{tag}: {len(grams)} gram calls checked")
    for r in grams:
        need(r["n"] == scope_n, f"{tag}: the gram took {r['n']} columns, "
             f"the scope has {scope_n}")
        need(r["max_rel_err"] <= TOL[("gram", r["dtype"])],
             f"{tag}: gram K={r['K']} n={r['n']} {r['max_rel_err']:.3e} "
             "off plain")
        worst.update(gram_K=r["K"], gram_n=r["n"],
                     gram_max_abs_err=r["max_abs_err"],
                     gram_max_rel_err=r["max_rel_err"])
    return worst


def train_cohorts(smi_line: str, device: str = "cuda",
                  reduced: bool = False) -> dict:
    """(b) C = 4 cohorts of the full zamba2-1.2b on ``emulated_mesh((4, 1),
    ("data", "model"))``: batch 8 (2 sequences a cohort), seq 128, remat
    "full", 3 contextual steps then 3 fedavg steps.  The first step of each
    runs under :func:`checked_train_ops`: its gram (K = 4 over the
    lm_head + final_norm scope) and every leaf's combine (K = 4) against
    their plain versions on the same inputs, the combine on fedavg's α =
    1/4.  Gates those, finite losses, Theorem 1's bound < 0 at every
    contextual step, gram once a contextual step, combine once per leaf a
    step and no plain version launched.  Peak memory is read over the
    unchecked steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves, tree_leaves_with_path
    from repro_torch.kernels import (combine, gram, launch_counts,
                                     reset_launch_counts)
    from repro_torch.launch.mesh import emulated_mesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import make_batches
    from repro_torch.models import get_model
    T = TRAIN_COHORTS
    cfg = get_config(T["arch"])
    cfg = cfg.reduced() if reduced else cfg
    tag = f"train {T['arch']} C = 4"
    bundle = get_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = bundle.init(gen)
    mesh = emulated_mesh(T["mesh"], ("data", "model"))
    shape = InputShape("custom", "train", T["seq"], T["batch"])
    C = T["mesh"][0]
    batches = list(make_batches(cfg, bundle, T["batch"], T["seq"],
                                T["steps"], device=device))
    b = train_step_bound(cfg, params, T["batch"] * T["seq"], C)
    n_leaves = len(tree_leaves(params))
    scope_n = sum(p.numel() for name, p in tree_leaves_with_path(params)
                  if "lm_head" in name or "final_norm" in name)
    torch.cuda.empty_cache()
    reset_launch_counts()
    gram.reset_body_launches()
    combine.reset_body_launches()
    runs, checked, peaks = {}, {}, []
    for agg in ("contextual", "fedavg"):
        step = build_train_step(cfg, mesh, shape, aggregator=agg,
                                lr=T["lr"], remat="full")
        rec = runs[agg] = {"ms": [], "loss": [], "alpha": [], "bound": []}
        for i, batch in enumerate(batches):
            found = {}
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            with (checked_train_ops(found) if i == 0
                  else contextlib.nullcontext()):
                ev[0].record()
                params, m = step(params, batch)
                ev[1].record()
                torch.cuda.synchronize()
            rec["ms"].append(ev[0].elapsed_time(ev[1]))
            rec["loss"].append(float(m["loss"]))
            rec["alpha"].append(m["alpha"].cpu().tolist())
            if "bound" in m:
                rec["bound"].append(float(m["bound"]))
            if i > 0:
                peaks.append(torch.cuda.max_memory_allocated())
            else:
                checked[agg] = _gate_checked_step(
                    f"{tag} {agg}", found, n_leaves, rec["alpha"][0],
                    scope_n if agg == "contextual" else None)
                del found
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
    counts = launch_counts()
    gram_bodies = gram.body_launches()
    combine_bodies = combine.body_launches()
    peak = max(peaks)
    steps = T["steps"]
    for agg, rec in runs.items():
        need(all(math.isfinite(x) for x in rec["loss"]),
             f"{tag} {agg}: losses {rec['loss']}")
    need(len(runs["contextual"]["bound"]) == steps
         and all(x < 0 for x in runs["contextual"]["bound"]),
         f"{tag}: Theorem 1's bound {runs['contextual']['bound']}, want < 0")
    need(runs["fedavg"]["alpha"][0] == [1.0 / C] * C,
         f"{tag}: the combine of fedavg's checked step got alpha "
         f"{runs['fedavg']['alpha'][0]}, want {[1.0 / C] * C}")
    _path_counts(tag, counts, {"gram/cuda": steps,
                               "combine/cuda": 2 * steps * n_leaves})
    need(gram_bodies == {"mma": 0, "realign": 0, "f32": steps,
                         "cuda_core": 0},
         f"{tag}: gram bodies {gram_bodies}")
    ctx = runs["contextual"]
    step_ms = statistics.median(ctx["ms"][1:])
    fed_ms = statistics.median(runs["fedavg"]["ms"][1:])
    tokens = T["batch"] * T["seq"]
    log(f"{tag} ({smi_line}): emulated mesh {dict(mesh.shape)}, batch "
        f"{T['batch']} seq {T['seq']}, remat full; contextual losses "
        f"{[round(x, 4) for x in ctx['loss']]}, alpha "
        f"{[[round(a, 4) for a in x] for x in ctx['alpha']]}, bound "
        f"{ctx['bound']}; fedavg losses "
        f"{[round(x, 4) for x in runs['fedavg']['loss']]}, alpha "
        f"{runs['fedavg']['alpha'][0]}; step ms contextual "
        f"{[round(x, 2) for x in ctx['ms']]} (the first checked; median of "
        f"2-{steps}: {step_ms:.2f}), fedavg "
        f"{[round(x, 2) for x in runs['fedavg']['ms']]}"
        f" ({fed_ms:.2f}) against the {b['bound_ms']:.2f} ms bound by "
        f"{b['bound_by']} ({b['bound_ms'] / step_ms:.1%}; "
        f"{b['bytes'] / 1e9:.1f} GB, {b['flops'] / 1e12:.2f} TFLOP; "
        f"{b['bound_with_reforward_ms']:.2f} ms with remat's re-forward); "
        f"{tokens / step_ms * 1e3:.0f} tokens/s; peak allocated "
        f"{peak / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in counts.items() if v} }; gram bodies "
        f"{gram_bodies}, combine bodies {combine_bodies}")
    for agg, w in checked.items():
        log(f"{tag} {agg}, checked first step: {w['combine_calls']} combine "
            f"calls (K = {C}, largest n {w['combine_largest_n']}) at most "
            f"{w['combine_max_ulps']:.3g} ulp from the exact sum, max |err| "
            f"vs plain {w['combine_max_abs_err']:.3e}"
            + (f"; gram K = {w['gram_K']} n = {w['gram_n']} max |err| vs "
               f"plain {w['gram_max_abs_err']:.3e} (relative "
               f"{w['gram_max_rel_err']:.3e}, tolerance "
               f"{TOL[('gram', 'float32')]})" if "gram_n" in w else ""))
    step = build_train_step(cfg, mesh, shape, lr=T["lr"], remat="full")
    stepped = _step_peak(tag, lambda: step(params, batches[0]))
    dev = _train_device(tag, lambda: step(params, batches[0]), step_ms,
                        smi_line)
    del params, batches
    torch.cuda.empty_cache()
    return {"counts": counts, "record": {
        "arch": cfg.name, "mesh": dict(mesh.shape), "cohorts": C,
        "remat": "full", "batch": T["batch"], "seq": T["seq"],
        "contextual": ctx, "fedavg": runs["fedavg"], "step_ms": step_ms,
        "fedavg_step_ms": fed_ms, "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"], "bound": b,
        "tokens_per_s": tokens / step_ms * 1e3,
        "peak_allocated_bytes": peak, "checked_first_steps": checked,
        "gram_bodies": gram_bodies, "combine_bodies": combine_bodies,
        **stepped, **dev, "nvidia_smi": smi_line}}


def train_card_vs_cpu(device: str = "cuda") -> dict:
    """(c) The reduced f32 zamba2 and olmoe configs, C = 4 on an emulated
    (4, 1) mesh, one contextual step under each remat policy with TF32
    off: the card's new params equal the CPU's, and each policy's equal
    remat=False's, at ``TRAIN_TOL`` (relative to max(1, max |p|))."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves, tree_map
    from repro_torch.launch.mesh import emulated_mesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import make_batches
    from repro_torch.models import get_model
    S = TRAIN_SMALL_SHAPE
    mesh = emulated_mesh((4, 1), ("data", "model"))
    shape = InputShape("custom", "train", S["seq"], S["batch"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for name in TRAIN_SMALL:
            cfg = get_config(name).reduced()
            bundle = get_model(cfg)
            cpu = bundle.init(0, device="cpu")
            card = tree_map(lambda a: a.to(device), cpu)
            batch = next(make_batches(cfg, bundle, S["batch"], S["seq"], 1))
            on_card = {k: v.to(device) for k, v in batch.items()}
            news, errs = {}, {}
            for remat in TRAIN_REMATS:
                step = build_train_step(cfg, mesh, shape, remat=remat)
                got, m = step(card, on_card)
                want, _ = step(cpu, batch)
                news[remat] = got
                errs[f"card_vs_cpu_{remat}"] = max(
                    _train_rel(a.cpu(), b) for a, b in
                    zip(tree_leaves(got), tree_leaves(want)))
            for remat in TRAIN_REMATS[1:]:
                errs[f"remat_{remat}_vs_false"] = max(
                    _train_rel(a, b) for a, b in
                    zip(tree_leaves(news[remat]), tree_leaves(news[False])))
            log(f"train {cfg.name} C = 4, f32, TF32 off: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (tolerance {TRAIN_TOL})")
            for k, v in errs.items():
                need(v <= TRAIN_TOL, f"train {cfg.name}: {k} {v:.3e} > "
                     f"{TRAIN_TOL}")
            out[name] = errs
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def _train_rel(got, want) -> float:
    scale = max(1.0, float(want.float().abs().max()))
    return float((got.float() - want.float()).abs().max()) / scale


def train_nccl(device: str = "cuda") -> dict:
    """(d) A one-rank NCCL process group (a ``FileStore`` in a temporary
    directory), ``hierarchical_contextual_combine`` on a (1, 1, 1)
    ``make_mesh`` with CUDA tensors: equal to the local math at
    ``TRAIN_TOL``; the group is destroyed."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import hierarchical_contextual_combine
    from repro_torch.core.solve import solve_alpha_simple
    from repro_torch.launch.mesh import make_mesh
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    n, beta = 1 << 20, 10.0
    g = torch.randn(n, generator=gen, device=device)
    u = -0.1 * (g + 0.5 * torch.randn(n, generator=gen, device=device))
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
            comb, a_intra, a_pods = hierarchical_contextual_combine(
                mesh, u, g, beta)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    # the local math: one cohort in one pod, twice
    a1 = solve_alpha_simple((u @ u)[None, None], (u @ g)[None], beta, 1e-6)
    intra = a1[0] * u
    a2 = solve_alpha_simple((intra @ intra)[None, None], (intra @ g)[None],
                            beta, 1e-6)
    want = a2[0] * intra
    errs = {"combined": _train_rel(comb, want),
            "alpha_intra": _train_rel(a_intra, a1),
            "alpha_pods": _train_rel(a_pods, a2)}
    log(f"train collectives on a one-rank {backend} group, mesh "
        f"{dict(mesh.shape)}: hierarchical_contextual_combine at n = {n} "
        f"vs the local math " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in errs.items())
        + f" (tolerance {TRAIN_TOL}); alpha intra {a_intra.tolist()}, "
        f"pods {a_pods.tolist()}")
    for k, v in errs.items():
        need(v <= TRAIN_TOL, f"train collectives: {k} {v:.3e} > {TRAIN_TOL}")
    need(not dist.is_initialized(), "train collectives: the process group "
         "was not destroyed")
    return {"backend": backend, **errs}


def train_kernel_rows(device: str = "cuda", n_leaf: int = (1 << 31) + 8,
                      n_scope: int = 50304 * 2048 + 2048) -> dict:
    """The train path's kernel shapes on random inputs, against their plain
    versions and a one-call PyTorch yardstick, beside the bound: the
    combine at an expert leaf's size and past it (2³¹ + 8 bf16 elements,
    K = 1: every element within one bf16 ulp of the f64 formula, by
    chunks), and the gram of olmoe-1b-7b's scope (K = 1, lm_head and
    final_norm: 103 M f32 columns)."""
    import torch
    from repro_torch.kernels import gram_and_cross, weighted_combine
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    chunk = 1 << 28
    w = torch.empty(n_leaf, dtype=torch.bfloat16, device=device)
    U = torch.empty((1, n_leaf), dtype=torch.bfloat16, device=device)
    for s in range(0, n_leaf, chunk):
        m = min(chunk, n_leaf - s)
        w[s:s + m] = torch.randn(m, generator=gen, device=device)
        U[0, s:s + m] = 0.01 * torch.randn(m, generator=gen, device=device)
    alpha = torch.tensor([0.75], device=device)
    out = weighted_combine(w, U, alpha)
    worst = 0.0
    for s in range(0, n_leaf, chunk):
        want = (w[s:s + chunk].double()
                + 0.75 * U[0, s:s + chunk].double())
        off = ((out[s:s + chunk].double() - want).abs()
               / _ulp(want.float(), torch.bfloat16).double()).max()
        worst = max(worst, float(off))
    need(worst <= 1.0, f"train: combine at n = {n_leaf} {worst:.3f} ulp off")
    comb = {"op": "combine", "K": 1, "n": n_leaf, "dtype": "bfloat16",
            "max_ulps_vs_f64": worst,
            "ms": time_ms(lambda: weighted_combine(w, U, alpha, out=out),
                          reps=5, warmup=1),
            "library_ms": time_ms(lambda: torch.add(w, U[0], alpha=0.75),
                                  reps=5, warmup=1),
            **combine_bound(1, n_leaf, torch.bfloat16)}
    plain = weighted_combine(w, U, alpha, backend="torch")
    comb["max_abs_err"] = float((out.float() - plain.float()).abs().max())
    del plain
    comb["plain_ms"] = time_ms(
        lambda: weighted_combine(w, U, alpha, backend="torch"), reps=2,
        warmup=1)
    del w, U, out
    torch.cuda.empty_cache()
    Us = torch.randn((1, n_scope), generator=gen, device=device)
    g = torch.randn(n_scope, generator=gen, device=device)
    G, c = gram_and_cross(Us, g)
    Gp, cp = gram_and_cross(Us, g, backend="torch")
    gr = {"op": "gram", "K": 1, "n": n_scope, "dtype": "float32",
          "max_abs_err": max(_max_err(G, Gp), _max_err(c, cp)),
          "max_rel_err": max(_max_err(G, Gp) / _scale(Gp),
                             _max_err(c, cp) / _scale(cp)),
          "ms": time_ms(lambda: gram_and_cross(Us, g), reps=20),
          "plain_ms": time_ms(lambda: gram_and_cross(Us, g,
                                                     backend="torch"),
                              reps=20),
          "library_ms": time_ms(lambda: (Us @ Us.T, Us @ g), reps=20),
          **gram_bound(1, n_scope, torch.float32)}
    need(gr["max_rel_err"] <= TOL[("gram", "float32")],
         f"train: gram at olmoe's scope {gr['max_rel_err']:.3e} off plain")
    del Us, g
    torch.cuda.empty_cache()
    for r in (comb, gr):
        log(f"train kernel row: {r['op']} K=1 n={r['n']} {r['dtype']}: "
            f"{r['ms'] * 1e3:.1f} us against the {r['bound_ms'] * 1e3:.1f} "
            f"us bound by {r['bound_by']} ({r['bound_ms'] / r['ms']:.1%}); "
            f"plain {r['plain_ms'] * 1e3:.1f} us, library "
            f"{r['library_ms'] * 1e3:.1f} us; max |err| vs plain "
            f"{r['max_abs_err']:.3e}"
            + (f", {r['max_ulps_vs_f64']:.3f} ulp at most vs f64 (gate 1)"
               if "max_ulps_vs_f64" in r else ""))
    return {"combine": comb, "gram": gr}


def _median_step_ms(fn, calls: int) -> tuple:
    """(median, all) CUDA-event ms of ``calls`` calls of ``fn`` after one
    warm call."""
    import torch
    fn()
    times = []
    for _ in range(calls):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        del out
        times.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(times), times


def _leaf_gap(a, b, chunk: int = 1 << 26) -> dict:
    """Two leaves (``b`` may lie on the host), by chunks (an expert leaf
    holds 2³¹ elements): max |a − b|, max |b|, the largest difference in
    ulps of ``a``'s dtype at each element's magnitude, and the count of
    elements that differ."""
    import torch
    out = {"diff": 0.0, "top": 0.0, "ulps": 0.0, "differing": 0}
    fa, fb = a.reshape(-1), b.reshape(-1)
    for s in range(0, fa.numel(), chunk):
        x = fa[s:s + chunk].float()
        y = fb[s:s + chunk].to(x.device).float()
        diff = (x - y).abs()
        out["diff"] = max(out["diff"], float(diff.max()))
        out["top"] = max(out["top"], float(y.abs().max()))
        ulp = _ulp(torch.maximum(x.abs(), y.abs()), a.dtype)
        out["ulps"] = max(out["ulps"], float((diff / ulp).max()))
        out["differing"] += int((x != y).sum())
    return out


def _tree_gap(pairs) -> dict:
    """``(name, a, b)`` leaf by leaf (:func:`_leaf_gap`): the largest
    difference relative to max(1, max |b|) and in ulps, the count of
    elements that differ and the three leaves furthest off."""
    out = {"max_rel": 0.0, "max_ulps": 0.0, "differing": 0}
    rels = []
    for name, a, b in pairs:
        g = _leaf_gap(a, b)
        rels.append((g["diff"] / max(1.0, g["top"]), name))
        out["max_ulps"] = max(out["max_ulps"], g["ulps"])
        out["differing"] += g["differing"]
    rels.sort(reverse=True)
    out.update(max_rel=rels[0][0], leaf=rels[0][1],
               furthest=[(n, r) for r, n in rels[:3]])
    return out


@contextlib.contextmanager
def _update_tap(fn):
    """Inside, ``fn(j, update, new)`` sees each leaf's f32 combined update
    — what ``launch.steps``' train step on a mesh of ranks hands the
    ``combine`` op with α = 1 — and the new leaf it makes, in flattening
    order.  The op runs (and counts) as it does outside."""
    from repro_torch.launch import steps
    real = steps.weighted_combine
    leaf = iter(range(1 << 30))

    def tapped(p, U, a, **kw):
        new = real(p, U, a, **kw)
        fn(next(leaf), U[0], new)
        return new

    steps.weighted_combine = tapped
    try:
        yield
    finally:
        steps.weighted_combine = real


class _UpdateGate:
    """Each leaf's update against the unplaced step's (``ref``, in
    flattening order, on the host): ``ratio`` max |a − b| / max |b| (the
    gate, at ``TRAIN_UPDATE_TOL``), the elements that differ, and
    ``worst``, the leaf furthest off.  ``max_numel`` skips the larger
    leaves (the ratio is then a lower bound of the gate's)."""

    def __init__(self, names, ref, max_numel: int = 1 << 62):
        self.names, self.ref, self.max_numel = names, ref, max_numel
        self.ratio, self.worst, self.differing = 0.0, None, 0
        self.leaves = 0

    def __call__(self, j: int, update, new) -> None:
        if update.numel() > self.max_numel:
            return
        g = _leaf_gap(update, self.ref[j])
        ratio = (g["diff"] / g["top"] if g["top"] else
                 0.0 if g["diff"] == 0 else math.inf)
        if ratio >= self.ratio:
            self.ratio, self.worst = ratio, self.names[j]
        self.differing += g["differing"]
        self.leaves += 1

    def record(self) -> dict:
        return {"ratio": self.ratio, "leaf": self.worst,
                "differing": self.differing, "leaves": self.leaves}


@contextlib.contextmanager
def _planted_fault(name: str):
    """A fault in ``models.moe.combine`` while inside (see
    ``TRAIN_FAULTS``)."""
    import torch
    from repro_torch.models import moe
    real = moe.combine

    def router(out_buf, top_p, placed):
        return real(out_buf, top_p.detach(), placed)

    def last(out_buf, top_p, placed):
        keep = torch.ones_like(top_p)
        keep[:, -1] = 0
        return real(out_buf, top_p * keep, placed)

    moe.combine = {"router": router, "last": last}[name]
    try:
        yield
    finally:
        moe.combine = real


def _placed_vs_unplaced_f32(mesh, device: str) -> dict:
    """The reduced f32 olmoe-1b-7b, placed and unplaced on ``mesh`` (TF32
    off): new params at ``TRAIN_TOL`` (relative to max(1, max |p|)), where
    the full-width bf16 step's can differ by a rounding."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves, tree_map
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import make_batches
    from repro_torch.models import get_model
    from repro_torch.sharding import place_batch
    S = TRAIN_SMALL_SHAPE
    cfg = get_config(TRAIN["arch"]).reduced()
    bundle = get_model(cfg)
    params = tree_map(lambda a: a.to(device), bundle.init(0, device="cpu"))
    batch = {k: v.to(device) for k, v in next(make_batches(
        cfg, bundle, S["batch"], S["seq"], 1)).items()}
    shape = InputShape("custom", "train", S["seq"], S["batch"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, _ = build_train_step(cfg, mesh, shape, remat="full")(
            params, place_batch(mesh, batch))
        want, _ = build_train_step(cfg, mesh, shape, remat="full",
                                   mode="dp")(params, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err = max(_train_rel(a, b) for a, b in zip(tree_leaves(got),
                                                tree_leaves(want)))
    need(err <= TRAIN_TOL, f"train placed {cfg.name} f32: {err:.3e} off the "
         f"unplaced step > {TRAIN_TOL}")
    return {"arch": cfg.name, "max_rel_err": err}


def train_placed(smi_line: str, device: str = "cuda",
                 reduced: bool = False) -> dict:
    """(e) The placed step (``launch.steps.build_train_step``, mode "tp")
    of the full olmoe-1b-7b on a one-rank NCCL group (a ``FileStore`` in a
    temporary directory) with a (1, 1) mesh of ranks, C = 1, against the
    unplaced step (mode "dp") on the same params and batch: its blocks
    are the whole leaves there, every model-parallel collective runs on
    the group of one.  Gates the placement, each leaf's f32 combined
    update against the unplaced step's at ``TRAIN_UPDATE_TOL`` of the
    leaf's max |update| (:func:`_update_tap`), that gate failing a planted
    fault (``TRAIN_FAULTS``), the reduced f32 model's new params at
    ``TRAIN_TOL``, α, gram once and combine once a leaf on ``cuda`` in the
    placed step.  The new params' gap is said, not gated (bitwise equal
    or not), beside the unplaced step against itself.  Both steps' ms
    (CUDA events, the median of ``TRAIN["steps"]`` calls after a warm
    one, taken in turn) and busy share; the group is destroyed."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_leaves, tree_leaves_with_path
    from repro_torch.kernels import (combine, gram, launch_counts,
                                     reset_launch_counts)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import InputShape, meta_params
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import make_batches
    from repro_torch.models import get_model
    from repro_torch.sharding import param_pspecs, place_batch, shard_shape
    from repro_torch.sharding.specs import spec_leaves
    T = TRAIN
    cfg = get_config(T["arch"])
    cfg = cfg.reduced() if reduced else cfg
    tag = f"train placed {cfg.name}"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    bundle = get_model(cfg)
    shape = InputShape("custom", "train", T["seq"], T["batch"])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            placed = build_train_step(cfg, mesh, shape, lr=T["lr"],
                                      remat="full")
            plain = build_train_step(cfg, mesh, shape, lr=T["lr"],
                                     remat="full", mode="dp")
            need(placed.placement == "tp" and plain.placement == "replicated",
                 f"{tag}: placements {placed.placement}, {plain.placement}")
            gen = torch.Generator(device=device)
            gen.manual_seed(0)
            params = bundle.init(gen)
            # on a (1, 1) mesh every block is its whole leaf: the placed
            # step takes the params themselves
            specs = param_pspecs(cfg, meta_params(cfg), mesh, "tp")
            for (path, spec), p in zip(spec_leaves(specs),
                                       tree_leaves(params)):
                need(shard_shape(tuple(p.shape), spec, mesh)
                     == tuple(p.shape), f"{tag}: {path} block of {spec}")
            batch = next(make_batches(cfg, bundle, T["batch"], T["seq"], 1,
                                      device=device))
            local = place_batch(mesh, batch)
            names = [name for name, _ in tree_leaves_with_path(params)]
            # the unplaced step: its f32 updates and new params kept on the
            # host (the card holds one step beside the params, no more)
            ref = []
            with _update_tap(lambda j, u, new: ref.append(u.cpu())):
                want, m_want = plain(params, batch)
            want = [t.cpu() for t in tree_leaves(want)]
            faults = {}
            for fault in TRAIN_FAULTS:
                # every leaf but the three 2³¹-element expert leaves
                gate = _UpdateGate(names, ref, max_numel=1 << 30)
                with _planted_fault(fault), _update_tap(gate):
                    placed(params, local)
                faults[fault] = gate.record()
            need(faults["router"]["ratio"] > TRAIN_UPDATE_TOL,
                 f"{tag}: the update gate passes a planted fault (the MoE's "
                 f"combine weights detached): {faults['router']}")
            reset_launch_counts()
            gram.reset_body_launches()
            combine.reset_body_launches()
            gate = _UpdateGate(names, ref)
            with _update_tap(gate):
                got, m_got = placed(params, local)
            torch.cuda.synchronize()
            counts = launch_counts()
            bodies = {"gram": gram.body_launches(),
                      "combine": combine.body_launches()}
            _path_counts(tag, counts, {"gram/cuda": 1,
                                       "combine/cuda": len(names)})
            need(bodies["gram"] == {"mma": 0, "realign": 0, "f32": 1,
                                    "cuda_core": 0},
                 f"{tag}: gram bodies {bodies['gram']}")
            update = gate.record()
            del ref
            alpha = (float(m_got["alpha"][0]), float(m_want["alpha"][0]))
            losses = (float(m_got["loss"]), float(m_want["loss"]))
            gap = _tree_gap(zip(names, tree_leaves(got), want))
            del got
            # the unplaced step against itself
            again, _ = plain(params, batch)
            self_gap = _tree_gap(zip(names, tree_leaves(again), want))
            del again, want
            need(update["ratio"] <= TRAIN_UPDATE_TOL,
                 f"{tag}: leaf {update['leaf']}'s update off the unplaced "
                 f"step's by {update['ratio']:.3e} of its max |update| > "
                 f"{TRAIN_UPDATE_TOL}")
            need(abs(alpha[0] - alpha[1]) <= TRAIN_ALPHA_TOL,
                 f"{tag}: alpha {alpha}")
            times = {}
            for name, step, b in (("placed", placed, local),
                                  ("unplaced", plain, batch),
                                  ("unplaced", plain, batch),
                                  ("placed", placed, local)):
                runs = _median_step_ms(lambda: step(params, b),
                                       T["steps"] - 1)[1]
                times.setdefault(name, []).extend(runs)
            step_ms = {k: statistics.median(v) for k, v in times.items()}
            dev = {name: _train_device(f"{tag} ({name} step)",
                                       lambda: step(params, b),
                                       step_ms[name], smi_line)
                   for name, step, b in (("placed", placed, local),
                                         ("unplaced", plain, batch))}
            del params
            torch.cuda.empty_cache()
            small = _placed_vs_unplaced_f32(mesh, device)
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"{tag} C = 1 on a one-rank {backend} group, mesh "
        f"{dict(mesh.shape)} ({smi_line}): each leaf's f32 update off the "
        f"unplaced step's by {update['ratio']:.3e} of its max |update| at "
        f"most (leaf {update['leaf']}, gate {TRAIN_UPDATE_TOL}), "
        f"{update['differing']} elements differ; planted faults "
        + ", ".join(f"{k} {v['ratio']:.3e} (leaf {v['leaf']})"
                    for k, v in faults.items())
        + f"; new params {gap['max_rel']:.3e} of max(1, max |p|) and "
        f"{gap['max_ulps']:.3g} ulp at most (furthest {gap['furthest']}), "
        f"{gap['differing']} elements differ, bitwise equal: "
        f"{gap['differing'] == 0}; the unplaced step against itself "
        f"{self_gap['differing']} elements differ; the reduced "
        f"f32 {small['arch']} placed vs unplaced {small['max_rel_err']:.3e} "
        f"(tolerance {TRAIN_TOL}, TF32 off); alpha placed / unplaced "
        f"{alpha}, loss {losses}; step ms placed "
        f"{[round(t, 2) for t in times['placed']]} (median "
        f"{step_ms['placed']:.2f}), unplaced "
        f"{[round(t, 2) for t in times['unplaced']]} (median "
        f"{step_ms['unplaced']:.2f}): placed / unplaced "
        f"{step_ms['placed'] / step_ms['unplaced']:.3f}; launches in the "
        f"placed step {({k: v for k, v in counts.items() if v})}, bodies "
        f"{bodies}")
    return {"counts": counts, "record": {
        "arch": cfg.name, "mesh": dict(mesh.shape), "backend": backend,
        "placement": "tp", "cohorts": 1, "batch": T["batch"],
        "seq": T["seq"], "update_vs_unplaced": update,
        "update_tol": TRAIN_UPDATE_TOL, "planted_faults": faults,
        "vs_unplaced": gap, "unplaced_vs_itself": self_gap,
        "bitwise_equal": gap["differing"] == 0, "reduced_f32": small,
        "alpha": alpha, "loss": losses, "step_ms": step_ms,
        "step_ms_all": times, "bodies": bodies,
        **{f"{name}_{k}": v for name, d in dev.items()
           for k, v in d.items()}, "nvidia_smi": smi_line}}


def train_sharded_rows(device: str = "cuda", sizes: dict = None) -> dict:
    """The placed step's kernel shapes on a 16-wide 'model' axis
    (``TRAIN_SHARDED``), each against its plain version and its one-call
    PyTorch yardstick, beside its bound: the gram of one rank's scope
    columns at K = 16 and 32 (f32); the sum of the 16 column blocks' grams
    against the gram of the whole U (K = 16, f32: what the all-reduce over
    'model' adds up); the combine of an expert leaf's block (bf16 w, its
    f32 combined update, K = 1, α = 1)."""
    import torch
    from repro_torch.kernels import gram_and_cross, weighted_combine
    S = dict(TRAIN_SHARDED, **(sizes or {}))
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    rows = {}
    n = S["n_scope"]
    for K in S["Ks"]:
        U = torch.randn((K, n), generator=gen, device=device)
        g = torch.randn(n, generator=gen, device=device)
        G, c = gram_and_cross(U, g)
        Gp, cp = gram_and_cross(U, g, backend="torch")
        r = {"op": "gram", "K": K, "n": n, "dtype": "float32",
             "max_abs_err": max(_max_err(G, Gp), _max_err(c, cp)),
             "max_rel_err": max(_max_err(G, Gp) / _scale(Gp),
                                _max_err(c, cp) / _scale(cp)),
             "ms": time_ms(lambda: gram_and_cross(U, g), reps=20),
             "plain_ms": time_ms(lambda: gram_and_cross(
                 U, g, backend="torch"), reps=20),
             "library_ms": time_ms(lambda: (U @ U.T, U @ g), reps=20),
             **gram_bound(K, n, torch.float32)}
        need(r["max_rel_err"] <= TOL[("gram", "float32")],
             f"train sharded: gram K={K} {r['max_rel_err']:.3e} off plain")
        rows[f"gram_K{K}"] = r
        del U, g
    # the all-reduce's sum: 16 column blocks' grams against the whole U's
    K, m = S["Ks"][0], S["model"]
    U = torch.randn((K, m * n), generator=gen, device=device)
    g = torch.randn(m * n, generator=gen, device=device)
    G, c = gram_and_cross(U, g)
    Gs = torch.zeros_like(G)
    cs = torch.zeros_like(c)
    for b in range(m):
        Gb, cb = gram_and_cross(U[:, b * n:(b + 1) * n].contiguous(),
                                g[b * n:(b + 1) * n])
        Gs += Gb
        cs += cb
    Gp, cp = gram_and_cross(U, g, backend="torch")
    r = {"op": "gram", "K": K, "n": m * n, "blocks": m, "dtype": "float32",
         "sum_vs_whole_rel_err": max(_max_err(Gs, G) / _scale(G),
                                     _max_err(cs, c) / _scale(c)),
         "sum_vs_plain_rel_err": max(_max_err(Gs, Gp) / _scale(Gp),
                                     _max_err(cs, cp) / _scale(cp)),
         "max_abs_err": max(_max_err(G, Gp), _max_err(c, cp))}
    need(r["sum_vs_whole_rel_err"] <= TOL[("gram", "float32")]
         and r["sum_vs_plain_rel_err"] <= TOL[("gram", "float32")],
         f"train sharded: the sum of {m} column-block grams is "
         f"{r['sum_vs_whole_rel_err']:.3e} off the whole U's gram, "
         f"{r['sum_vs_plain_rel_err']:.3e} off plain")
    rows["gram_block_sum"] = r
    del U, g, G, Gs, Gp
    torch.cuda.empty_cache()
    ne = S["n_expert"]
    w = torch.randn(ne, generator=gen, device=device).to(torch.bfloat16)
    U = 0.01 * torch.randn((1, ne), generator=gen, device=device)
    one = torch.ones(1, device=device)
    out = weighted_combine(w, U, one)
    plain = weighted_combine(w, U, one, backend="torch")
    lib = torch.empty_like(w)
    r = {"op": "combine", "K": 1, "n": ne, "dtype": "float32",
         "w_dtype": "bfloat16",
         "max_abs_err": float((out.float() - plain.float()).abs().max()),
         "ms": time_ms(lambda: weighted_combine(w, U, one, out=out), reps=20),
         "plain_ms": time_ms(lambda: weighted_combine(
             w, U, one, backend="torch"), reps=5),
         # one call writing bf16, as the kernel: w + U in f32, rounded once
         "library_ms": time_ms(lambda: torch.add(w, U[0], out=lib), reps=20),
         **combine_bound(1, ne, torch.float32, torch.bfloat16)}
    need(r["max_abs_err"] <= TOL[("combine", "bfloat16")],
         f"train sharded: combine at n = {ne} {r['max_abs_err']:.3e} off "
         "plain")
    rows["combine_expert_block"] = r
    del w, U, out, plain, lib
    torch.cuda.empty_cache()
    for key, r in rows.items():
        log(f"train sharded kernel row {key}: {r['op']} K={r['K']} "
            f"n={r['n']} {r['dtype']}"
            + (f": the sum of {r['blocks']} column blocks' grams "
               f"{r['sum_vs_whole_rel_err']:.3e} off the whole U's gram, "
               f"{r['sum_vs_plain_rel_err']:.3e} off plain (gate "
               f"{TOL[('gram', 'float32')]})" if "blocks" in r else
               (f" (w {r['w_dtype']})" if "w_dtype" in r else "")
               + f": {r['ms'] * 1e3:.1f} us "
               f"against the {r['bound_ms'] * 1e3:.1f} us bound by "
               f"{r['bound_by']} ({r['bound_ms'] / r['ms']:.1%}); plain "
               f"{r['plain_ms'] * 1e3:.1f} us, library "
               f"{r['library_ms'] * 1e3:.1f} us; max |err| vs plain "
               f"{r['max_abs_err']:.3e}"))
    return rows


def train_phase(smi_line: str, device: str = "cuda",
                reduced: bool = False) -> dict:
    """The ``train`` phase (see ``TRAIN``): (a) the entry point at full
    width, (b) four cohorts at full width, the path's kernel shapes timed
    (the combine at 2³¹ + 8 elements, the gram of olmoe's scope), (c) card
    = CPU under each remat policy, (d) the collectives on NCCL, (e) the
    placed step on a one-rank NCCL group against the unplaced one, and
    the placed step's kernel shapes on a 16-wide 'model' axis.  The
    path's counts are (a)'s, (b)'s and (e)'s first placed step's."""
    entry = train_entry(smi_line, device, reduced)
    cohorts = train_cohorts(smi_line, device, reduced)
    placed = train_placed(smi_line, device, reduced)
    counts = dict(entry["counts"])
    for k, v in list(cohorts["counts"].items()) + list(
            placed["counts"].items()):
        counts[k] = counts.get(k, 0) + v
    rows = (train_kernel_rows(device) if not reduced else
            train_kernel_rows(device, (1 << 20) + 8, 1 << 16))
    rows["sharded"] = train_sharded_rows(device, None if not reduced else
                                         dict(n_scope=4104, n_expert=1 << 16))
    return {"counts": counts, "models": {
        TRAIN["arch"]: entry["record"],
        TRAIN_COHORTS["arch"]: cohorts["record"]},
        "placed": placed["record"],
        "kernel_rows": rows, "card_vs_cpu": train_card_vs_cpu(device),
        "collectives": train_nccl(device)}


# ---------------------------------------------------------------- roofline

# one train step of a config at a shape on an emulated mesh, traced on fake
# tensors (launch.dryrun.dryrun_step); argv[1] is the JSON of its arguments
_DRYRUN_STEP = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import emulated_mesh
from repro_torch.launch.shapes import InputShape
a = json.loads(sys.argv[1])
rec = dryrun.dryrun_step(
    get_config(a["arch"]), emulated_mesh(a["mesh"], ("data", "model")),
    InputShape("custom", "train", a["seq"], a["batch"]),
    extra={"lr": a["lr"], "remat": "full"})
print(json.dumps(rec))
"""


@contextlib.contextmanager
def _dryruns(jobs: dict, out_dir: str):
    """Starts each job ({key: argv}) in a subprocess of its own, all at
    once, on the CPU (``CUDA_VISIBLE_DEVICES`` empty), and yields a
    function that waits for all within ``ROOFLINE_TIMEOUT_S`` of the start
    and returns {key: (rc, stdout, stderr, seconds)}; on leaving, kills any
    still running."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    procs = {}
    t0 = time.perf_counter()

    def wait() -> dict:
        done = {}
        for key, (p, out, err) in procs.items():
            left = ROOFLINE_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                rc = p.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                need(False, f"roofline: dry run {key} past "
                     f"{ROOFLINE_TIMEOUT_S} s")
            out.seek(0)
            err.seek(0)
            done[key] = (rc, out.read(), err.read(),
                         time.perf_counter() - t0)
        return done

    try:
        for i, (key, argv) in enumerate(jobs.items()):
            out = open(Path(out_dir) / f"{i}.out", "w+")
            err = open(Path(out_dir) / f"{i}.err", "w+")
            procs[key] = (subprocess.Popen([sys.executable] + argv, stdout=out,
                                           stderr=err, env=env, cwd=ROOT),
                          out, err)
        yield wait
    finally:
        for p, out, err in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()


def _analytic_rows(records: dict, smi_line: str) -> dict:
    """(b) The reference's analytic terms (``launch.analytic``, on the H100
    constants) of every measured step at the shape its phase ran, at one
    chip, beside the phase's byte bound and step ms.  A train run of C > 1
    cohorts on an emulated (C, 1) mesh puts C logical devices on the card:
    its row sums the terms of the C devices with the params replicated, as
    the port keeps them (``dp_only``), and prints the one-chip terms too."""
    from repro_torch.configs import get_config
    from repro_torch.launch.analytic import analytic_roofline
    from repro_torch.launch.serve import lockstep_max_seq
    from repro_torch.launch.shapes import InputShape
    R = RECURRENT
    rows = []
    for phase, name, rec in records["decode"]:
        cfg = get_config(name)
        if phase in ("serve", "moe"):
            B, S = SERVE["slots"], SERVE["max_seq"]
        else:
            B, S = R["batch"], lockstep_max_seq(cfg, R["prompt"], R["new"])
        a = analytic_roofline(cfg, InputShape("measured", "decode", S, B),
                              data=1, model=1, pods=1)
        rows.append((phase, name, f"decode B={B} S={S}", a, 1,
                     rec["decode_step_bound_ms"],
                     rec["decode_step_ms_alone"], None))
    for name, rec in records["train"].items():
        cfg = get_config(name)
        C = rec["cohorts"]
        shape = InputShape("measured", "train", rec["seq"], rec["batch"])
        one = analytic_roofline(cfg, shape, data=1, model=1, pods=1)
        a = (one if C == 1 else
             analytic_roofline(cfg, shape, data=C, model=1, pods=1,
                               dp_only=True))
        rows.append(("train", name, f"train B={rec['batch']} "
                     f"S={rec['seq']} C={C}", a, C, rec["bound_ms"],
                     rec["step_ms"], None if C == 1 else one))
    out = {}
    for phase, name, shape, a, devs, bound_ms, step_ms, one in rows:
        mem_ms, comp_ms = a.memory_s * devs * 1e3, a.compute_s * devs * 1e3
        ratio = mem_ms / bound_ms
        log(f"roofline (b) {phase} {name} {shape} ({smi_line}): analytic "
            + (f"summed over {devs} devices (params replicated) " if devs > 1
               else "at one chip ")
            + f"memory {mem_ms:.3f} ms, compute {comp_ms:.3f} ms, collective "
            f"{a.collective_s * devs * 1e3:.3f} ms, bottleneck "
            f"{a.bottleneck}; the phase's byte bound {bound_ms:.3f} ms "
            f"({ratio:.3f}x); measured step {step_ms:.2f} ms"
            + ("" if one is None else
               f"; at one chip memory {one.memory_s * 1e3:.3f} ms "
               f"({one.memory_s * 1e3 / bound_ms:.3f}x), compute "
               f"{one.compute_s * 1e3:.3f} ms, bottleneck {one.bottleneck}"))
        need(ROOFLINE_BYTES_RANGE[0] <= ratio <= ROOFLINE_BYTES_RANGE[1],
             f"roofline (b) {phase} {name}: analytic memory term "
             f"{mem_ms:.3f} ms is {ratio:.3f}x the phase's byte bound "
             f"{bound_ms:.3f} ms, outside {ROOFLINE_BYTES_RANGE}")
        out[f"{phase} {name}"] = {
            "shape": shape, "devices": devs, "memory_ms": mem_ms,
            "compute_ms": comp_ms,
            "collective_ms": a.collective_s * devs * 1e3,
            "bottleneck": a.bottleneck, "hbm_bytes": a.hbm_bytes * devs,
            "flops": a.flops * devs, "phase_bound_ms": bound_ms,
            "memory_over_bound": ratio, "step_ms": step_ms,
            **({} if one is None else {
                "one_chip_memory_ms": one.memory_s * 1e3,
                "one_chip_compute_ms": one.compute_s * 1e3,
                "one_chip_bottleneck": one.bottleneck})}
    return out


def roofline_phase(smi_line: str, records: dict) -> dict:
    """The ``roofline`` phase: it reads the earlier phases' records
    (``records``: ``"decode"`` [(phase, arch, record)] of the serve, moe,
    recurrent, whisper and chameleon phases, ``"train"`` {arch: record} of
    the train phase) and runs no model on the card.

    (a) The dry run of each train combination (olmoe-1b-7b C = 1 on the
    host mesh, zamba2-1.2b C = 4 on the emulated (4, 1) mesh; remat "full")
    predicts its step's peak: within ``ROOFLINE_PEAK_TOL`` of the peak the
    train phase measured with the step's inputs resident; the trace's FLOPs
    against the analytic ``model_forward_flops`` x 4 (remat "full") within
    ``ROOFLINE_FLOPS_RANGE``, beside the bound's 6 · active · tokens.
    (b) ``_analytic_rows``.  (c) ``ROOFLINE_PRODUCTION`` through the CLI
    (``python -m repro_torch.launch.dryrun``) on a fake process group of
    256 / 512 ranks: each ``ok``, with its trace seconds, per-rank peak,
    fit and TFLOP beside the analytic per-device TFLOP.  The five dry runs
    run at once in subprocesses on the CPU while (b) is computed."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.analytic import (analytic_roofline,
                                             model_forward_flops)
    from repro_torch.launch.shapes import INPUT_SHAPES, InputShape
    t0 = time.perf_counter()
    trains = {TRAIN["arch"]: dict(TRAIN, mesh=(1, 1)),
              TRAIN_COHORTS["arch"]: TRAIN_COHORTS}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {name: ["-c", _DRYRUN_STEP, json.dumps(
            {"arch": name, "mesh": list(T["mesh"]), "batch": T["batch"],
             "seq": T["seq"], "lr": T["lr"]})] for name, T in trains.items()}
        jobs.update({combo: ["-m", "repro_torch.launch.dryrun", "--arch",
                             combo[0], "--shape", combo[1], "--mesh",
                             combo[2], "--out", tmp]
                     for combo in ROOFLINE_PRODUCTION})
        with _dryruns(jobs, tmp) as wait:
            rows = _analytic_rows(records, smi_line)
            done = wait()
        for key, (rc, out, err, secs) in done.items():
            need(rc == 0, f"roofline: dry run {key} exit {rc}: "
                 f"{(out + err)[-2000:]}")
        production = {}
        for arch, shape_name, mesh in ROOFLINE_PRODUCTION:
            path = Path(tmp) / f"{arch}_{shape_name}_{mesh}.json"
            production[f"{arch}|{shape_name}|{mesh}"] = json.loads(
                path.read_text())

    # (a) the train steps: predicted peak and FLOPs against the card's
    predicted = {}
    for name, T in trains.items():
        rc, out, err, secs = done[name]
        rec = json.loads(out.strip().splitlines()[-1])
        meas = records["train"][name]
        cfg = get_config(name)
        shape = InputShape("custom", "train", T["seq"], T["batch"])
        pred_peak = rec["memory"]["peak_bytes"]
        got_peak = meas["step_peak_allocated_bytes"]
        rel = (pred_peak - got_peak) / got_peak
        trace = rec["cost"]["flops"]
        ana = model_forward_flops(cfg, shape, cfg.sliding_window) * 4
        six = meas["bound"]["flops"]
        log(f"roofline (a) train {name} C = {meas['cohorts']} mesh "
            f"{tuple(T['mesh'])} ({smi_line}): dry run (traced in "
            f"{rec['trace_s']} s, {secs:.1f} s with its process) predicts a "
            f"peak of {pred_peak} B ({pred_peak / 2**30:.2f} GiB: arguments "
            f"{rec['memory']['argument_size_in_bytes']} B + temporaries "
            f"{rec['memory']['temp_size_in_bytes']} B); measured "
            f"{got_peak} B ({got_peak / 2**30:.2f} GiB, "
            f"{meas['allocated_before_step_bytes']} B resident before the "
            f"step): {rel:+.2%} (gate {ROOFLINE_PEAK_TOL:.0%}); trace "
            f"{trace / 1e12:.3f} TFLOP against the analytic "
            f"model_forward_flops x 4 {ana / 1e12:.3f} TFLOP "
            f"({trace / ana:.3f}x, gate {ROOFLINE_FLOPS_RANGE}) and the "
            f"bound's 6 * active * tokens {six / 1e12:.3f} TFLOP "
            f"({trace / six:.3f}x)"
            + ("; the MoE experts' bmm counts every capacity slot"
               if cfg.family == "moe" else "")
            + f"; trace bytes {rec['cost']['bytes accessed'] / 1e9:.1f} GB, "
            f"{rec['dispatched_ops']} ops")
        need(abs(rel) <= ROOFLINE_PEAK_TOL,
             f"roofline (a) {name}: predicted peak {pred_peak} B is "
             f"{rel:+.2%} off the measured {got_peak} B")
        need(ROOFLINE_FLOPS_RANGE[0] <= trace / ana
             <= ROOFLINE_FLOPS_RANGE[1],
             f"roofline (a) {name}: trace / analytic FLOPs "
             f"{trace / ana:.3f} outside {ROOFLINE_FLOPS_RANGE}")
        predicted[name] = {
            "predicted_peak_bytes": pred_peak, "measured_peak_bytes": got_peak,
            "peak_rel_err": rel, "trace_flops": trace,
            "analytic_flops": ana, "six_active_tokens_flops": six,
            "trace_bytes": rec["cost"]["bytes accessed"],
            "trace_s": rec["trace_s"], "process_s": secs,
            "dry_run": rec}

    # (c) the production combinations: the train step and the
    # decode steps placed
    for tag, rec in production.items():
        need(rec["status"] == "ok", f"roofline (c) {tag}: {rec['status']}")
        arch, shape_name, mesh = tag.split("|")
        a = analytic_roofline(get_config(arch), INPUT_SHAPES[shape_name],
                              pods=2 if mesh == "multi" else 1)
        m, r = rec["memory"], rec["roofline"]
        ratio = rec["cost"]["flops"] / a.flops
        args = m["argument_size_in_bytes"] / m["sharded_argument_bytes"] - 1
        log(f"roofline (c) {tag} on a fake group of {r['num_chips']} ranks "
            f"({rec['placement']}): traced in {rec['trace_s']} s; per-rank "
            f"peak {m['peak_bytes'] / 2**30:.2f} GiB, fits {m['fits']} "
            f"(sharded arguments {m['sharded_argument_bytes'] / 2**30:.3f} "
            f"GiB a device, the port's {m['argument_size_in_bytes'] / 2**30:.3f}"
            f" GiB: {args:+.2%}); per-rank {rec['cost']['flops'] / 1e12:.3f} "
            f"TFLOP beside the analytic {a.flops / 1e12:.3f} TFLOP a device "
            f"({ratio:.2f}x); collectives "
            f"{ {k: v for k, v in rec['collectives'].items() if v} }")
        if shape_name.startswith("decode"):
            cfg = get_config(arch)
            lo, hi = ROOFLINE_DECODE_FLOPS_RANGE
            gated, what = ratio, "the analytic"
            if cfg.family == "moe":
                free = analytic_roofline(
                    cfg.with_overrides(experts_per_token=cfg.num_experts),
                    INPUT_SHAPES[shape_name],
                    pods=2 if mesh == "multi" else 1).flops
                rec["drop_free_analytic_flops_per_device"] = free
                gated, what = rec["cost"]["flops"] / free, "the drop-free analytic"
                log(f"roofline (c) {tag}: the drop-free analytic (every "
                    f"expert over every slot) {free / 1e12:.3f} TFLOP a "
                    f"device ({free / a.flops:.2f}x the k-active one); "
                    f"trace {gated:.2f}x it")
            need(rec["placement"] in ("tp", "fsdp") and m["fits"]
                 and lo <= gated <= hi
                 and abs(args) <= ROOFLINE_PLACED_ARGS_TOL,
                 f"roofline (c) {tag}: placement {rec['placement']}, fits "
                 f"{m['fits']}, FLOPs {gated:.2f}x {what} (want "
                 f"{lo}-{hi:g}), arguments {args:+.2%} off the specs' "
                 f"blocks (at most {ROOFLINE_PLACED_ARGS_TOL:.0%})")
        if shape_name.startswith("train"):
            need(rec["placement"] == "tp" and m["fits"]
                 and ratio <= ROOFLINE_PLACED_FLOPS_MAX
                 and abs(args) <= ROOFLINE_PLACED_ARGS_TOL,
                 f"roofline (c) {tag}: placement {rec['placement']}, fits "
                 f"{m['fits']}, FLOPs {ratio:.2f}x the analytic (at most "
                 f"{ROOFLINE_PLACED_FLOPS_MAX}), arguments {args:+.2%} off "
                 f"the specs' blocks (at most {ROOFLINE_PLACED_ARGS_TOL:.0%})")
        rec["analytic_flops_per_device"] = a.flops
    wall = time.perf_counter() - t0
    log(f"roofline: {wall:.1f} s")
    return {"train": predicted, "analytic": rows,
            "production": production, "wall_s": wall}


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
        f"{build_s['combine.cu']:.2f}, decode_attn_cluster.cu (2 instances) "
        f"{build_s['decode_attn_cluster.cu']:.2f} and decode_attn_mma.cu (2) "
        f"{build_s['decode_attn_mma.cu']:.2f} beside decode_attn.cu (32) "
        f"{build_s['decode_attn.cu']:.2f}, sketch_mma.cu (8) "
        f"{build_s['sketch_mma.cu']:.2f} and sketch_realign.cu (8) "
        f"{build_s['sketch_realign.cu']:.2f}, gram_block_mma.cu (32) "
        f"{build_s['gram_block_mma.cu']:.2f}, gram_mma.cu (8) "
        f"{build_s['gram_mma.cu']:.2f}, gram_f32.cu (20) "
        f"{build_s['gram_f32.cu']:.2f} and cross_f32.cu (4) "
        f"{build_s['cross_f32.cu']:.2f}; slowest "
        f"{max(build_s, key=build_s.get)} {max(build_s.values()):.2f}")
    _build.load_library()
    for K in (PATH_SHAPE[0], 25, 64, 100):
        for dt in ("f32", "bf16"):
            per_sm, smem = gram.launch_config(K, dt == "bf16", dt == "bf16", 0)
            log(f"launch: gram.cu partial K={K} {dt}: {smem} B dynamic shared "
                f"memory per block, {per_sm} blocks per SM, "
                f"{gram.row_slices(K)} grid slices; gram finish: 0 B; "
                f"combine: 4*K = {4 * K} B (alpha)")
    sms = _build.sm_count(0)
    for K, n in ((1, 103_024_640), (5, N_PATH), (PATH_SHAPE[0], N_PATH),
                 (16, 6_440_960), (32, 6_440_960), (64, 1 << 24),
                 (100, 1 << 24), (100, N_PATH), (500, 68), (2000, 68)):
        vec = n % 4 == 0
        per_sm, smem, threads = gram.f32_launch_config(K, vec, 0)
        blocks, cols, floats = gram.f32_call_plan(K, n, vec, 0)
        log(f"launch: gram_f32 K={K} n={n} ({'16' if vec else '4'}-byte "
            f"reads, {'stream' if K <= gram.F32_STREAM_MAX_K else 'tiles'}): "
            f"{threads} threads, {smem} B dynamic shared memory, {per_sm} "
            f"blocks per SM; {gram.f32_num_slices(K)} slices x {blocks} "
            f"blocks of {cols} columns, scratch {floats} floats, "
            f"{'one launch' if blocks == 1 else 'one cooperative launch'}")
    for ma, m1, m2, sym, n in ((PATH_SHAPE[0], PATH_SHAPE[0], 1, False, N_PATH),
                               (25, 25, 1, False, N_PATH),
                               (100, 100, 1, False, N_PATH),
                               (64, 32, 1, False, 1 << 24),
                               (100, 100, 100, True, 7840),
                               (100, 100, 100, True, 10)):
        vec = n % 4 == 0
        level, blocks, cols, floats = cross.f32_call_plan(ma, m1, m2, sym, n,
                                                          vec, 0)
        per_sm, slices, _ = cross.f32_launch_config(ma, m1, m2, sym, level,
                                                    vec, 0)
        plan = cross.f32_plan(cross.F32Cuts.of(ma, m1, m2, sym, level),
                              cols // cross.F32_GROUP)
        what = (f"stream_stats P={ma}" if sym else
                f"gram_block Ka={ma} Kb={m1}")
        log(f"launch: cross_f32 {what} n={n} ({'16' if vec else '4'}-byte "
            f"copies): level {level}, {slices} slices x {blocks} blocks of "
            f"{cols} columns, {plan['budget']} threads, a ring of "
            f"{plan['ring']} x {plan['groups']} groups ({plan['smem_bytes']} "
            f"B), {per_sm} blocks per SM at the widest ring; scratch {floats} "
            f"floats, {'one launch' if blocks == 1 else 'one cooperative launch'}")
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
    for K, n, m in SKETCH_APPLY_MODEL + SKETCH_REALIGN_MODEL:
        per_sm, _ = cross.launch_config("sketch_realign_launch_config",
                                        (K, m), 0)
        aligned, _ = cross.launch_config("sketch_mma_launch_config", (K, m),
                                         0)
        need(per_sm == aligned, f"sketch K={K} m={m}: the realigning body's "
             f"{per_sm} blocks an SM against sketch_mma.cu's {aligned}")
        log(f"launch: sketch realign K={K} m={m} bf16: {per_sm} blocks of "
            f"256 threads per SM (as sketch_mma.cu); n={n}: (slices, blocks "
            f"per slice, columns per block) "
            f"{sketch.mma_grid(n, m, sms, per_sm)}; f32: cross_f32.cu "
            f"(level, blocks, columns, scratch floats) "
            f"{cross.f32_call_plan(K, m, 0, False, n, False, 0)}")
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
        MAX_CLUSTER, MMA_HEAD_DIMS, cluster_cap, cluster_launch_config,
        decode_cluster_splits, decode_mma_splits, decode_splits,
        mma_resident_blocks, resident_blocks)
    for hd in MMA_HEAD_DIMS:
        log(f"launch: flash_decode cluster body hd={hd}: clusters the card "
            "co-schedules by size (load-balancing policy) "
            + str({size: cluster_launch_config(hd, size, 0)[1]
                   for size in range(1, MAX_CLUSTER + 1)}))
    for B, S, KV, G, hd, window, _ in ((DECODE_PATH, DECODE_MOE, DECODE_LONG)
                                       + tuple(DECODE_PLACED)
                                       + tuple(DECODE_MODEL)):
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
            resident = cluster_launch_config(hd, 1, 0)[0]
            cap = cluster_cap(hd, B * KV, 0)
            splits, rows = decode_cluster_splits(B, S, KV, resident, cap,
                                                 window)
            log(f"launch: flash_decode B={B} S={S} KV={KV} G={G} hd={hd} "
                f"window={window} bf16, cluster body: cap {cap} for "
                f"{B * KV} heads; {splits} splits x {rows} rows -> "
                f"{B * KV} clusters of {splits} blocks, one launch")
    return smi_line


KERNEL_SOURCES = {
    "gram": ("src/repro_torch/kernels/csrc/gram_f32.cu",
             "src/repro/kernels/gram.py:104"),
    "combine": ("src/repro_torch/kernels/csrc/combine.cu",
                "src/repro/kernels/combine.py:30"),
    "topk": ("src/repro_torch/kernels/csrc/topk.cu",
             "src/repro/kernels/topk.py:34"),
    "sign_sketch": ("src/repro_torch/kernels/csrc/rng_sketch_col.cu",
                    "src/repro/kernels/rng_sketch.py:127"),
    "sign_sketch_adjoint": ("src/repro_torch/kernels/csrc/rng_sketch_col.cu",
                            "src/repro/kernels/rng_sketch.py:94"),
    "stream_stats": ("src/repro_torch/kernels/csrc/cross_f32.cu",
                     "src/repro/kernels/stream.py:102"),
    "gram_block": ("src/repro_torch/kernels/csrc/cross_f32.cu",
                   "src/repro/kernels/gram.py:60"),
    "sketch": ("src/repro_torch/kernels/csrc/sketch_realign.cu",
               "src/repro/kernels/sketch.py:39"),
    "flash_decode": ("src/repro_torch/kernels/csrc/decode_attn_cluster.cu",
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


def gram_realign_entry(recs: list, bodies_by_path: dict) -> dict:
    """The realigning body of gram (gram_realign.cu) on the kernels line:
    its numbers at the K = 64, n = 2^20 + 3 bf16 MODEL row, with its aligned
    twin's, gram.cu's in turn and its speed targets; its launches are each
    path's ``realign`` tally (no path takes it)."""
    row = next(r for r in recs if r["set"] == "model"
               and r["body"] == "realign" and r["K"] == 64)
    twin = next(r for r in recs if r["set"] == "model" and r["body"] == "mma"
                and r["K"] == 64 and r["n"] == GRAM_TWIN_N)
    launches = {path: b["realign"] for path, b in bodies_by_path.items()}
    return {"name": "gram_realign", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gram_realign.cu",
            "replaces": KERNEL_SOURCES["gram"][1],
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"],
            "cuda_core_ms": row["cuda_core_ms"],
            "twin_ms": twin["ms"], "twin_device_ms": twin["device_ms"],
            "twin_realign_ms": twin["realign_ms"],
            "twin_realign_device_ms": twin["realign_device_ms"],
            "shape": {"K": row["K"], "n": row["n"], "dtype": row["dtype"]},
            "tolerance": row["tolerance"], "f64_rel_err": row["f64_rel_err"],
            "targets": row["targets"]}


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
    t_start = time.perf_counter()
    from repro_torch.kernels import (combine, decode_attn, gram, rng_sketch,
                                     sketch, stream)
    gram_bodies, block_bodies, sketch_bodies, decode_bodies = {}, {}, {}, {}
    combine_bodies, sign_bodies, stream_bodies = {}, {}, {}

    def on_path(path: str, phase, *args):
        """Run a path phase; every gram launch in it must take the f32 body
        (gram_f32.cu: the paths hand gram f32 inputs), no path but the
        robust one reaches gram_block, and that one only its f32 body
        (cross_f32.cu: f32 inputs), no path takes cross.cuh's stream_stats
        body (the f32 paths' slabs take cross_f32.cu, the big-model ones
        the tensor cores; the phases gate each run's bodies themselves),
        and no path reaches sketch."""
        gram.reset_body_launches()
        gram.reset_block_body_launches()
        sketch.reset_body_launches()
        decode_attn.reset_body_launches()
        combine.reset_body_launches()
        rng_sketch.reset_body_launches()
        stream.reset_body_launches()
        result = phase(*args)
        combine_bodies[path] = combine.body_launches()
        sign_bodies[path] = rng_sketch.body_launches()
        gram_bodies[path] = gram.body_launches()
        block_bodies[path] = gram.block_body_launches()
        sketch_bodies[path] = sketch.body_launches()
        decode_bodies[path] = decode_attn.body_launches()
        stream_bodies[path] = stream.body_launches()
        need(gram_bodies[path]["mma"] == gram_bodies[path]["realign"]
             == gram_bodies[path]["cuda_core"] == 0,
             f"{path}: gram bodies {gram_bodies[path]}, want f32 only")
        if path == "robust":
            need(block_bodies[path]["mma"] == 0
                 and block_bodies[path]["cross"] == 0
                 and block_bodies[path]["f32"] > 0,
                 f"{path}: gram_block bodies {block_bodies[path]}, want "
                 "f32 only")
        else:
            need(sum(block_bodies[path].values()) == 0,
                 f"{path}: gram_block bodies {block_bodies[path]}, want none")
        need(stream_bodies[path]["cross"] == 0
             and (path != "bigmodel" or stream_bodies[path]["f32"] == 0)
             and (path not in ("streamed", "robust")
                  or stream_bodies[path]["mma"] == 0),
             f"{path}: stream_stats bodies {stream_bodies[path]}")
        need(sum(sketch_bodies[path].values()) == 0,
             f"{path}: sketch bodies {sketch_bodies[path]}, want none")
        need(all(t["first"] == 0 for t in sign_bodies[path].values()),
             f"{path}: sign sketch bodies {sign_bodies[path]}, want col only")
        return result

    try:
        smi_line = setup_phase()
        kern = kernels_phase()
        sync_counts, ds, params = on_path("sync", path_phase)
        asynced = on_path("async", async_phase, ds, params)
        hier_counts = on_path("hier", hier_phase, ds, params)
        streamed_counts = on_path("streamed", streamed_phase, ds, params)
        meshed = on_path("streamed_mesh", streamed_mesh_phase, smi_line,
                              ds, params)
        robusted = on_path("robust", robust_phase, ds, params)
        fleeted = on_path("fleet", fleet_phase)
        scaffolded = on_path("scaffold", scaffold_phase, ds, params)
        big = on_path("bigmodel", bigmodel_phase)
        served = on_path("serve", serve_phase)
        placed_served = on_path("serve_placed", serve_placed_phase,
                                     smi_line)
        moed = on_path("moe", moe_phase, smi_line)
        recurred = on_path("recurrent", recurrent_phase, smi_line)
        lockstepped = {phase: on_path(phase, lockstep_phase, smi_line,
                                           phase)
                       for phase in LOCKSTEP_PHASES}
        trained = on_path("train", train_phase, smi_line)
        roofed = roofline_phase(smi_line, {
            "decode": [("serve", SERVE["arch"], served)]
            + [("moe", name, rec) for name, rec in moed["models"].items()]
            + [("recurrent", name, rec)
               for name, rec in recurred["models"].items()]
            + [(phase, name, rec) for phase, lst in lockstepped.items()
               for name, rec in lst["models"].items()],
            "train": trained["models"]})
        by_path = {"sync": sync_counts, "async": asynced["counts"],
                   "hier": hier_counts,
                   "streamed": streamed_counts,
                   "streamed_mesh": meshed["counts"],
                   "robust": robusted["counts"],
                   "fleet": fleeted["counts"],
                   "scaffold": scaffolded["counts"],
                   "bigmodel": big["counts"], "serve": served["counts"],
                   "serve_placed": placed_served["counts"],
                   "moe": moed["counts"], "recurrent": recurred["counts"],
                   **{phase: rec["counts"]
                      for phase, rec in lockstepped.items()},
                   "train": trained["counts"]}
        for path, counts in by_path.items():
            need(gram_bodies[path]["f32"] >= counts.get("gram/cuda", 0),
                 f"{path}: {counts.get('gram/cuda', 0)} gram launches, "
                 f"bodies {gram_bodies[path]}")
        log(f"gram bodies by path (each phase, its checks against the CPU "
            f"included): {gram_bodies}")
        # every gram_block launch of the robust runs was counted by body
        # (each run gated exactly); the phase's card-vs-CPU rounds add more
        need(block_bodies["robust"]["f32"]
             >= robusted["counts"]["gram_block/cuda"] > 0,
             f"robust: gram_block bodies {block_bodies['robust']}, "
             f"{robusted['counts']['gram_block/cuda']} launches in the runs")
        log(f"gram_block bodies by path: {block_bodies}")
        # stream_stats: the f32 slabs of the streamed, robust-streamed and
        # mesh rounds on cross_f32.cu, the big-model slabs and the split
        # pass's windows on the tensor cores
        for path in ("streamed", "robust"):
            need(stream_bodies[path]["f32"] > 0,
                 f"{path}: stream_stats bodies {stream_bodies[path]}")
        need(stream_bodies["bigmodel"]["mma"]
             >= big["counts"]["stream_stats/cuda"] > 0,
             f"bigmodel: stream_stats bodies {stream_bodies['bigmodel']}")
        log(f"stream_stats bodies by path (the last run's of each phase, "
            f"each run gated in its phase): {stream_bodies}")
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
        # phases (the mesh part too) took the col body (the phases' card rounds against the CPU
        # included: at least the runs' own launches)
        for path in ("hier", "streamed", "streamed_mesh"):
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
                 "src/repro_torch/kernels/csrc/gram_mma.cu",
                 "src/repro_torch/kernels/csrc/gram_realign.cu",
                 "src/repro_torch/kernels/csrc/gram.cu"],
        bodies_by_path=gram_bodies,
        gram_realign=gram_realign_entry(kern["gram"], gram_bodies))
    entries[names.index("gram_block")].update(
        sources=[KERNEL_SOURCES["gram_block"][0],
                 "src/repro_torch/kernels/csrc/gram_block_mma.cu",
                 "src/repro_torch/kernels/csrc/gram_block.cu"],
        bodies_by_path=block_bodies)
    entries[names.index("stream_stats")].update(
        sources=[KERNEL_SOURCES["stream_stats"][0],
                 "src/repro_torch/kernels/csrc/stream_stats.cu"],
        bodies_by_path=stream_bodies)
    entries[names.index("sketch")].update(
        sources=[KERNEL_SOURCES["sketch"][0],
                 "src/repro_torch/kernels/csrc/cross_f32.cu",
                 "src/repro_torch/kernels/csrc/sketch_mma.cu",
                 "src/repro_torch/kernels/csrc/sketch.cu"],
        bodies_by_path=sketch_bodies)
    entries[names.index("combine")].update(
        sources=[KERNEL_SOURCES["combine"][0],
                 "src/repro_torch/kernels/csrc/combine_vec.cu"],
        bodies_by_path=combine_bodies)
    entries[names.index("flash_decode")].update(
        sources=[KERNEL_SOURCES["flash_decode"][0],
                 "src/repro_torch/kernels/csrc/decode_attn_mma.cu",
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
    entries[names.index("gram")]["fleet"] = fleeted["numbers"]
    entries[names.index("gram")]["scaffold"] = scaffolded["numbers"]
    entries[names.index("stream_stats")]["bigmodel"] = {
        k: v for k, v in big.items() if k != "counts"}
    entries[names.index("stream_stats")]["streamed_mesh"] = {
        k: v for k, v in meshed.items() if k != "counts"}
    entries[names.index("flash_decode")]["serve"] = {
        k: v for k, v in served.items() if k != "counts"}
    entries[names.index("flash_decode")]["serve_placed"] = placed_served[
        "models"]
    entries[names.index("flash_decode")]["moe"] = moed["models"]
    # no kernel lies on the recurrent path (its launches are 0 for every
    # op); its numbers ride on the serving entry
    entries[names.index("flash_decode")]["recurrent"] = recurred["models"]
    # nor on the whisper and chameleon paths (both decode through the plain
    # attention_decode, as the reference)
    for phase, rec in lockstepped.items():
        entries[names.index("flash_decode")][phase] = rec["models"]
    # the train path launches gram (one a contextual step) and combine (one
    # a leaf a step): its numbers ride on both entries
    train_numbers = {k: v for k, v in trained.items() if k != "counts"}
    entries[names.index("gram")]["train"] = train_numbers
    entries[names.index("combine")]["train"] = train_numbers
    # the analytic tools held to the train steps: on the train path's entry
    entries[names.index("gram")]["roofline"] = roofed
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
