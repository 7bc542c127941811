"""``sketch``: S_U = U Rᵀ against an explicit sketch matrix R — the Hopper
kernel.

Replaces ``repro.kernels.sketch.sketch_apply_pallas``.  It has four bodies,
chosen from dtypes, shapes, strides and pointers alone (:func:`_body`):

* ``mma`` (``csrc/sketch_mma.cu``): U and R both bf16, 1 <= K <= 64,
  n % 8 == 0, 16-byte aligned pointers and row strides that are multiples
  of 8 (:func:`_mma_eligible`), on the bf16 tensor cores;
* ``realign`` (``csrc/sketch_realign.cu``): the other bf16 calls with
  1 <= K <= 64 (odd n, unaligned views or row strides), the same tensor-core
  loop on tiles staged from the aligned-down 16-byte chunks of each row and
  shifted into place in shared memory (``realign.realign_plan`` mirrors
  it; :func:`realign_plan` here too);
* ``f32`` (``csrc/cross_f32.cu``, the f32 body of ``gram_block`` and
  ``stream_stats``): U and R both f32, A = U against B1 = R, one launch;
* ``cross`` (``csrc/sketch.cu`` on ``csrc/cross.cuh``): mixed f32/bf16
  calls and bf16 K > 64; ``body="cross"`` forces any call onto it, to
  compare.

No f32 operand is rounded to bf16 to reach a tensor core.  Each source says
what bounds it on the H100 and how its deterministic split reduction is laid
out; this module checks the inputs, allocates the output and the scratch
with ``torch.empty`` and launches on the current stream without
synchronising.  ``body_launches()`` tallies the launches by body.  For the
counter-based sign sketch, whose R is never stored, see ``rng_sketch.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import _build, cross, gram
# the realigned staging's mirror, importable here as before
from .realign import CHUNK as REALIGN_CHUNK  # noqa: F401
from .realign import realign_plan, realign_shift  # noqa: F401
from .registry import count_launch

SKETCH_MMA_MAX_K = 64     # the tensor-core bodies' K: U in 8·NB <= 64 rows
MMA_SLICE_ROWS = 128      # rows of R a block of the tensor-core body takes
MMA_WARPS = 8             # warps of a block: one 16-row tile of R each
MMA_STAGE_COLS = 128      # columns of one staged tile
BODIES = ("mma", "realign", "f32", "cross")
_BODY_LAUNCHES = {body: 0 for body in BODIES}
# the tensor-core bodies' launchers: (occupancy query, launch)
_TC_FUNCS = {"mma": ("sketch_mma_launch_config", "sketch_mma_launch"),
             "realign": ("sketch_realign_launch_config",
                         "sketch_realign_launch")}


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


def _realign_eligible(updates: torch.Tensor, sketch: torch.Tensor) -> bool:
    """Whether the realigning tensor-core body can take a call: U and R
    both bf16, 1 <= K <= 64, m >= 1, n >= 1, any row strides and
    pointers."""
    (K, n), m = updates.shape, sketch.shape[0]
    return (updates.dtype == torch.bfloat16 and sketch.dtype == torch.bfloat16
            and 1 <= K <= SKETCH_MMA_MAX_K and m >= 1 and n >= 1)


def _f32_eligible(updates: torch.Tensor, sketch: torch.Tensor) -> bool:
    """Whether cross_f32.cu can take a call: U and R both f32 and the
    slices of (K, m) fit its grid (:func:`cross.f32_shape_ok`)."""
    (K, _), m = updates.shape, sketch.shape[0]
    return (updates.dtype == torch.float32 and sketch.dtype == torch.float32
            and K >= 1 and m >= 1 and cross.f32_shape_ok(K, m, 0, False))


def _body(updates: torch.Tensor, sketch: torch.Tensor) -> str:
    """The body a call takes: ``mma`` where :func:`_mma_eligible` holds,
    ``realign`` for the other bf16 calls with K <= 64, ``f32`` for f32 U
    and R, ``cross`` for the rest (mixed dtypes, K > 64).  Reads only
    dtypes, shapes, strides and pointers."""
    if _mma_eligible(updates, sketch):
        return "mma"
    if _realign_eligible(updates, sketch):
        return "realign"
    if _f32_eligible(updates, sketch):
        return "f32"
    return "cross"


def body_launches() -> Dict[str, int]:
    """``{body: launches}`` for ``mma``, ``realign``, ``f32`` and ``cross``
    since the last reset."""
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


def _launch_tensor_cores(body: str, updates: torch.Tensor, ldu: int,
                         sketch: torch.Tensor, ldr: int, S: torch.Tensor
                         ) -> None:
    """sketch_mma.cu or sketch_realign.cu: a partial kernel over one wave
    of blocks, then the finish."""
    (K, n), m = updates.shape, sketch.shape[0]
    dev = updates.device
    config_fn, launch_fn = _TC_FUNCS[body]
    per_sm, _ = cross.launch_config(config_fn, (K, m), dev.index)
    slices, num_blocks, cols = mma_grid(n, m, _build.sm_count(dev.index),
                                        per_sm)
    partial = torch.empty(
        (slices * num_blocks * MMA_SLICE_ROWS * mma_rows(K),),
        dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = getattr(lib, launch_fn)(
            updates.data_ptr(), ldu, K, sketch.data_ptr(), ldr, m, n,
            partial.data_ptr(), partial.numel(), num_blocks, cols,
            S.data_ptr(), cross.stream_of(dev))
    _build.check(lib, rc, f"sketch ({body})")


def _launch_cross(updates: torch.Tensor, ldu: int, sketch: torch.Tensor,
                  ldr: int, S: torch.Tensor) -> None:
    """sketch.cu: cross.cuh's partial and finish kernels."""
    (K, n), m = updates.shape, sketch.shape[0]
    dev = updates.device
    partial, num_blocks, cols = cross.scratch("sketch_apply_launch_config",
                                              (K, m), n, dev)
    bf16 = torch.bfloat16
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.sketch_apply_launch(
            updates.data_ptr(), ldu, int(updates.dtype == bf16), K,
            sketch.data_ptr(), ldr, int(sketch.dtype == bf16), m, n,
            partial.data_ptr(), partial.numel(), num_blocks, cols,
            S.data_ptr(), cross.stream_of(dev))
    _build.check(lib, rc, "sketch (cross)")


def sketch_apply_cuda(updates: torch.Tensor, sketch: torch.Tensor, *,
                      body: Optional[str] = None) -> torch.Tensor:
    """``updates (K, n)`` and ``sketch (m, n)``, f32 or bf16 each, any row
    stride with unit-strided columns, on one CUDA device → ``(K, m)`` f32,
    on the body :func:`_body` picks; ``body=`` forces one (``"cross"``
    takes any call; ``"mma"`` an eligible call, ``"realign"`` bf16 U and R
    with K <= 64, ``"f32"`` f32 U and R) and raises where the call does
    not fit it."""
    dev = updates.device
    ldu = cross.row_stride("sketch_apply_cuda", "updates", updates, dev)
    ldr = cross.row_stride("sketch_apply_cuda", "sketch", sketch, dev)
    (K, n), (m, ns) = updates.shape, sketch.shape
    if ns != n:
        raise ValueError(f"sketch operands disagree on n: {n} vs {ns}")
    if K < 1 or m < 1:
        raise ValueError(f"sketch_apply_cuda: K={K} and m={m} must be >= 1")
    if body not in (None,) + BODIES:
        raise ValueError(f"sketch_apply_cuda: body {body!r} not in {BODIES}")
    took = _body(updates, sketch)
    if body == "mma" and took != "mma":
        raise ValueError("sketch_apply_cuda: the mma body takes bf16 U and R "
                         f"with 1 <= K <= {SKETCH_MMA_MAX_K}, n % 8 == 0, "
                         "16-byte aligned pointers and row strides that are "
                         "multiples of 8")
    if body == "realign" and not _realign_eligible(updates, sketch):
        raise ValueError("sketch_apply_cuda: the realign body takes bf16 U "
                         f"and R with 1 <= K <= {SKETCH_MMA_MAX_K} and n >= 1")
    if body == "f32" and took != "f32":
        raise ValueError("sketch_apply_cuda: the f32 body takes f32 U and R "
                         "whose slices fit its grid")
    took = body or took
    S = torch.empty((K, m), dtype=torch.float32, device=dev)
    if n == 0:
        return S.zero_()
    if took == "f32":
        cross.launch_f32("sketch", updates, K, ldu, sketch, m, ldr, sketch,
                         0, 0, False, n, S, m, S, 0, False)
    elif took == "cross":
        _launch_cross(updates, ldu, sketch, ldr, S)
    else:
        _launch_tensor_cores(took, updates, ldu, sketch, ldr, S)
    count_launch("sketch", "cuda")
    _BODY_LAUNCHES[took] += 1
    return S
