"""``sign_sketch`` and its adjoint: U Rᵀ/√m and Rᵀ s/√m with the ±1 matrix R
generated from counters inside the kernel — the Hopper kernels.

Replace ``repro.kernels.rng_sketch.rng_sketch_pallas`` and
``rng_sketch_adjoint_xla``.  The CUDA source (``csrc/rng_sketch.cu``, hash
in ``csrc/rng_hash.cuh``) says what bounds them on the H100 and how the
deterministic split over (row tile, column range) is laid out; this module
checks the inputs, allocates the outputs and the scratch with
``torch.empty``, and launches on the current stream without synchronising.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .registry import count_launch

ROWS_PER_BLOCK = 128          # rows of R per block (csrc kRowsPerBlock)
COL_TILE = 256                # columns staged per step (csrc kColTile)
BLOCKS_PER_SM = 16
MAX_KC = 8                    # rows of U one pass accumulates (csrc kMaxKC)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
MAX_SEED = (1 << 32) - 1


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed <= MAX_SEED:
        raise ValueError(f"seed {seed} is not a uint32")
    return seed


def grid(K: int, n: int, m: int, sm_count: int) -> Tuple[int, int, int]:
    """``(n_splits, cols_per_split, rows per pass)``: enough (row tile,
    column range) blocks to fill the card even at K = 1."""
    m_tiles = -(-m // ROWS_PER_BLOCK)
    splits = max(1, min(-(-BLOCKS_PER_SM * sm_count // m_tiles),
                        -(-n // COL_TILE)))
    cols = -(-n // splits)
    kc = 1 if K <= 1 else 2 if K <= 2 else 4 if K <= 4 else MAX_KC
    return -(-n // cols), cols, kc


def sign_sketch_cuda(updates: torch.Tensor, seed: int, m: int
                     ) -> torch.Tensor:
    """``updates (K, n)`` f32 or bf16, contiguous on a CUDA device, uint32
    ``seed``, ``m`` ≥ 1 → ``U Rᵀ/√m (K, m)`` f32."""
    if not updates.is_cuda:
        raise ValueError("sign_sketch_cuda needs CUDA tensors; got "
                         f"{updates.device}")
    if updates.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"sign_sketch_cuda: updates dtype {updates.dtype} "
                        f"not in {SUPPORTED_DTYPES}")
    if updates.dim() != 2 or not updates.is_contiguous():
        raise ValueError("sign_sketch_cuda: want contiguous updates (K, n), "
                         f"got shape {tuple(updates.shape)}")
    K, n = updates.shape
    if K < 1 or n < 1 or m < 1:
        raise ValueError(f"sign_sketch_cuda: K={K}, n={n}, m={m} must be "
                         ">= 1")
    seed = _check_seed(seed)
    dev = updates.device
    splits, cols, kc = grid(K, n, m, _build.sm_count(dev.index))
    partial = torch.empty((splits * kc * m,), dtype=torch.float32, device=dev)
    out = torch.empty((K, m), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.sign_sketch_launch(
            updates.data_ptr(), K, n, int(updates.dtype == torch.bfloat16),
            seed, m, partial.data_ptr(), partial.numel(), out.data_ptr(),
            splits, cols, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "sign_sketch")
    count_launch("sign_sketch", "cuda")
    return out


def sign_sketch_adjoint_cuda(coords: torch.Tensor, seed: int, n: int
                             ) -> torch.Tensor:
    """``coords (m,)`` f32, contiguous on a CUDA device, uint32 ``seed``,
    ``n`` ≥ 1 → ``Rᵀ coords/√m (n,)`` f32."""
    if not coords.is_cuda:
        raise ValueError("sign_sketch_adjoint_cuda needs CUDA tensors; got "
                         f"{coords.device}")
    if coords.dtype != torch.float32:
        raise TypeError("sign_sketch_adjoint_cuda: coords must be float32, "
                        f"got {coords.dtype}")
    if coords.dim() != 1 or not coords.is_contiguous() or coords.numel() < 1:
        raise ValueError("sign_sketch_adjoint_cuda: want a contiguous "
                         f"non-empty (m,) vector, got {tuple(coords.shape)}")
    if n < 1:
        raise ValueError(f"sign_sketch_adjoint_cuda: n={n} must be >= 1")
    seed = _check_seed(seed)
    dev = coords.device
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.sign_sketch_adjoint_launch(
            coords.data_ptr(), coords.numel(), seed, n, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "sign_sketch_adjoint")
    count_launch("sign_sketch_adjoint", "cuda")
    return out
