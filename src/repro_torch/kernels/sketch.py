"""``sketch``: S_U = U Rᵀ against an explicit sketch matrix R — the Hopper
kernel.

Replaces ``repro.kernels.sketch.sketch_apply_pallas``.  It has two bodies,
chosen from the inputs alone (:func:`_mma_eligible`): a call with U and R
both bf16, 1 <= K <= 64, n % 8 == 0, 16-byte aligned pointers and row
strides that are multiples of 8 runs on the bf16 tensor cores
(``csrc/sketch_mma.cu``), every other call on the shared cross-product body
of ``csrc/cross.cuh`` (``csrc/sketch.cu``: any K and m, f32 or bf16 each, no
pad).  No f32 operand is rounded to bf16 to reach a tensor core.  Each
source says what bounds it on the H100 and how its deterministic split
reduction is laid out; this module checks the inputs, allocates the output
and the scratch with ``torch.empty`` and launches on the current stream
without synchronising.  ``body_launches()`` tallies the launches by body.
For the counter-based sign sketch, whose R is never stored, see
``rng_sketch.py``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import _build, cross, gram
from .registry import count_launch

SKETCH_MMA_MAX_K = 64     # the tensor-core body's K: U in 8·NB <= 64 rows
MMA_SLICE_ROWS = 128      # rows of R a block of the tensor-core body takes
MMA_WARPS = 8             # warps of a block: one 16-row tile of R each
MMA_STAGE_COLS = 128      # columns of one staged tile
_BODY_LAUNCHES = {"mma": 0, "cross": 0}


def _mma_eligible(updates: torch.Tensor, sketch: torch.Tensor) -> bool:
    """Whether a call takes the tensor-core body: U and R both bf16,
    1 <= K <= 64, m >= 1, n >= 1 with n % 8 == 0, both ``data_ptr()``
    16-byte aligned and both row strides multiples of 8 entries (every row
    then starts 16-byte aligned).  Reads only dtypes, shapes, strides and
    pointers."""
    (K, n), m = updates.shape, sketch.shape[0]
    return (updates.dtype == torch.bfloat16 and sketch.dtype == torch.bfloat16
            and 1 <= K <= SKETCH_MMA_MAX_K and m >= 1
            and n >= 1 and n % 8 == 0
            and all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
                    for t in (updates, sketch)))


def body_launches() -> Dict[str, int]:
    """``{"mma": launches, "cross": launches}`` since the last reset."""
    return dict(_BODY_LAUNCHES)


def reset_body_launches() -> None:
    for key in _BODY_LAUNCHES:
        _BODY_LAUNCHES[key] = 0


def mma_rows(K: int) -> int:
    """Staged rows of U in the tensor-core body: K zero-padded to a multiple
    of 8 (a block's partial is 128 x this)."""
    return 8 * -(-K // 8)


def mma_slices(m: int) -> int:
    """Slices of R's m rows, 128 a slice (the last one short)."""
    return -(-m // MMA_SLICE_ROWS)


def mma_deal(K: int) -> List[List[Tuple[int, int]]]:
    """The (16 x 8) tiles (i, j) of a slice's (128 x 8·NB) partial S_Uᵀ that
    each warp of a tensor-core block owns: warp w the row tile w of R and all
    NB row groups of U (as ``sketch_mma_partial`` deals them)."""
    return [[(w, j) for j in range(mma_rows(K) // 8)]
            for w in range(MMA_WARPS)]


def mma_grid(n: int, m: int, sm_count: int,
             blocks_per_sm: int) -> Tuple[int, int, int]:
    """``(slices, num_blocks, cols_per_block)`` of the tensor-core body: one
    resident wave over all slices, each block over whole staged tiles."""
    slices = mma_slices(m)
    return (slices, *gram.grid(n, sm_count, blocks_per_sm, slices))


def sketch_apply_cuda(updates: torch.Tensor, sketch: torch.Tensor
                      ) -> torch.Tensor:
    """``updates (K, n)`` and ``sketch (m, n)``, f32 or bf16 each, any row
    stride with unit-strided columns, on one CUDA device → ``(K, m)`` f32,
    on the tensor-core body when :func:`_mma_eligible` holds and on
    cross.cuh's otherwise."""
    dev = updates.device
    ldu = cross.row_stride("sketch_apply_cuda", "updates", updates, dev)
    ldr = cross.row_stride("sketch_apply_cuda", "sketch", sketch, dev)
    (K, n), (m, ns) = updates.shape, sketch.shape
    if ns != n:
        raise ValueError(f"sketch operands disagree on n: {n} vs {ns}")
    if K < 1 or m < 1:
        raise ValueError(f"sketch_apply_cuda: K={K} and m={m} must be >= 1")
    S = torch.empty((K, m), dtype=torch.float32, device=dev)
    if n == 0:
        return S.zero_()
    mma = _mma_eligible(updates, sketch)
    lib = _build.load_library()
    if mma:
        per_sm, _ = cross.launch_config("sketch_mma_launch_config", (K, m),
                                        dev.index)
        slices, num_blocks, cols = mma_grid(n, m, _build.sm_count(dev.index),
                                            per_sm)
        partial = torch.empty(
            (slices * num_blocks * MMA_SLICE_ROWS * mma_rows(K),),
            dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.sketch_mma_launch(
                updates.data_ptr(), ldu, K, sketch.data_ptr(), ldr, m, n,
                partial.data_ptr(), partial.numel(), num_blocks, cols,
                S.data_ptr(), cross.stream_of(dev))
    else:
        partial, num_blocks, cols = cross.scratch("sketch_apply_launch_config",
                                                  (K, m), n, dev)
        bf16 = torch.bfloat16
        with torch.cuda.device(dev):
            rc = lib.sketch_apply_launch(
                updates.data_ptr(), ldu, int(updates.dtype == bf16), K,
                sketch.data_ptr(), ldr, int(sketch.dtype == bf16), m, n,
                partial.data_ptr(), partial.numel(), num_blocks, cols,
                S.data_ptr(), cross.stream_of(dev))
    _build.check(lib, rc, "sketch")
    count_launch("sketch", "cuda")
    _BODY_LAUNCHES["mma" if mma else "cross"] += 1
    return S
