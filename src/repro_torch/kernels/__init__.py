"""Kernels of the port: hand-written Hopper CUDA with plain PyTorch twins.

Ops (``cuda`` / ``torch`` backends, selected by the tensors' device — see
``registry.py``):

  * ``gram``    — fused G = U Uᵀ, c = U g (f32: ``csrc/gram_f32.cu``;
    bf16, K <= 127: ``csrc/gram_mma.cu``, or ``csrc/gram_realign.cu`` for
    rows that start only 2-byte aligned; the rest: ``csrc/gram.cu``)
  * ``combine`` — α-weighted update combine w + Σ α_k U_k
    (``csrc/combine.cu``; rows 16-byte aligned: ``csrc/combine_vec.cu``)
  * ``topk``    — the k largest-|v| entries, radix select (``csrc/topk.cu``)
  * ``sign_sketch`` / ``sign_sketch_adjoint`` — U Rᵀ/√m and Rᵀ s/√m with
    the ±1 matrix R hashed from counters in the kernel
    (``csrc/rng_sketch_col.cu``; the first body, run only to compare:
    ``csrc/rng_sketch.cu``, ``csrc/rng_hash.cuh``)
  * ``stream_stats`` — the streamed engine's G = D Dᵀ, C = D GMᵀ
    (``csrc/stream_stats.cu``)
  * ``gram_block`` — G_ab = U_a U_bᵀ, c_a = U_a g (``csrc/gram_block.cu``;
    bf16: ``csrc/gram_block_mma.cu``)
  * ``sketch``  — U Rᵀ against an explicit R (bf16, K <= 64:
    ``csrc/sketch_mma.cu``, or ``csrc/sketch_realign.cu`` for rows that
    start only 2-byte aligned; f32: ``csrc/cross_f32.cu``; the rest:
    ``csrc/sketch.cu``)
  * ``flash_decode`` — single-token GQA attention against a KV cache, with
    the (o, lse) partials (``csrc/decode_attn.cu``); ``lse_merge`` combines
    partials of a split cache in plain torch

``stream_stats``, ``gram_block`` and ``sketch`` share one device body,
``csrc/cross.cuh``.  ``stream_stats``, ``gram``, ``gram_block`` and
``sketch`` each take a tensor-core body of their own for bf16 inputs
(``stream._mma_eligible``, ``gram._mma_eligible``,
``gram._block_mma_eligible``, ``sketch._mma_eligible``).

The CUDA sources build at first use with ``nvcc`` for ``sm_90a``
(``_build.py``); importing this package builds nothing.
"""
from .ops import (flash_decode, gram_and_cross, gram_block_and_cross,
                  lse_merge, sign_sketch, sign_sketch_adjoint, sketch_apply,
                  stream_stats, topk_select, weighted_combine)
from .registry import (available_ops, backends, dispatch, force_backend,
                       launch_counts, register_impl, reset_launch_counts,
                       select_impl)

__all__ = ["available_ops", "backends", "dispatch", "flash_decode",
           "force_backend", "gram_and_cross", "gram_block_and_cross",
           "launch_counts", "lse_merge", "register_impl",
           "reset_launch_counts", "select_impl", "sign_sketch",
           "sign_sketch_adjoint", "sketch_apply", "stream_stats",
           "topk_select", "weighted_combine"]
