"""``combine``: w' = w + Σ_k α_k U_k — the Hopper kernel.

Replaces ``repro.kernels.combine.combine_pallas``.  It has two bodies,
chosen from the inputs alone (:func:`_vec_eligible`): a call whose rows of
U, w and out all start 16-byte aligned runs on ``csrc/combine_vec.cu``
(16-byte loads, rows split across the warps of a block where n is too small
to fill the card: :func:`combine_vec_split`); every other call (odd n,
31 400-byte f32 rows, views a few bytes in) on ``csrc/combine.cu``
(one element a lane per row).  Both read U with its row stride, so a
(K, n) window of a wider slab — a rank's columns in the streamed engine's
split — is taken as it lies.  Each source says what bounds it on the H100
and how the pass is laid out; this module checks the inputs in one pass,
allocates the output with ``torch.empty`` (or writes into the caller's
``out``, which may be the base itself) and launches on the current stream
without synchronising.  ``body_launches()`` tallies the launches by body.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from . import _build
from .registry import count_launch

MAX_K = 4096
BLOCKS_PER_SM = 8          # combine.cu's grid cap
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
VEC_BYTES = 16             # a lane's load of U per row in combine_vec.cu
VEC_WARPS = 8              # warps of a combine_vec.cu block
VEC_SPLITS = (1, 2, 4, 8)  # its row-slice instances (W_k)
VEC_MIN_ROWS = 4           # rows a slice keeps at least (one load batch)
VEC_MIN_BLOCKS_PER_SM = 2  # W_k stays 1 where whole columns give this many
BODIES = ("vec", "scalar")
_BODY_LAUNCHES = {body: 0 for body in BODIES}


def _vec_eligible(params_vec: torch.Tensor, updates: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> bool:
    """Whether a call takes ``combine_vec.cu``: w and U each f32 or bf16,
    1 <= K <= ``MAX_K``, every row of U 16-byte aligned (``data_ptr()``,
    n · element size and the row stride · element size multiples of 16) and
    w and out 16-byte aligned (``out`` None: a fresh allocation, which is).
    Reads only dtypes, shapes, strides and pointers."""
    K, n = updates.shape
    elem = updates.element_size()
    return (updates.dtype in SUPPORTED_DTYPES
            and params_vec.dtype in SUPPORTED_DTYPES
            and 1 <= K <= MAX_K and n >= 1
            and updates.data_ptr() % VEC_BYTES == 0
            and n * elem % VEC_BYTES == 0
            and _row_stride(updates) * elem % VEC_BYTES == 0
            and params_vec.data_ptr() % VEC_BYTES == 0
            and (out is None or out.data_ptr() % VEC_BYTES == 0))


def _row_stride(updates: torch.Tensor) -> int:
    """Elements between U's rows (n for one row, whose stride is never
    read)."""
    K, n = updates.shape
    return int(updates.stride(0)) if K > 1 else n


def body_launches() -> Dict[str, int]:
    """``{"vec": launches, "scalar": launches}`` since the last reset."""
    return dict(_BODY_LAUNCHES)


def reset_body_launches() -> None:
    for key in _BODY_LAUNCHES:
        _BODY_LAUNCHES[key] = 0


def vec_cols(elem_size: int) -> int:
    """Columns of U a lane loads per row (8 bf16, 4 f32)."""
    return VEC_BYTES // elem_size


def combine_vec_split(K: int, n: int, elem_size: int, sms: int) -> int:
    """W_k, the row slices of a ``combine_vec.cu`` block (it then takes
    8 / W_k column groups of 32 vectors): 1 where whole columns give every
    SM at least ``VEC_MIN_BLOCKS_PER_SM`` blocks, else doubled until they
    do, while every slice keeps ``VEC_MIN_ROWS`` rows, at most 8."""
    groups = -(-n // (32 * vec_cols(elem_size)))
    wk = 1
    while (wk < VEC_WARPS
           and -(-groups * wk // VEC_WARPS) < VEC_MIN_BLOCKS_PER_SM * sms
           and VEC_MIN_ROWS * 2 * wk <= K):
        wk *= 2
    return wk


def vec_row_slices(K: int, wk: int) -> List[Tuple[int, int]]:
    """The rows ``[k0, k1)`` each row slice of a block sums, in order (as
    ``combine_vec_kernel`` cuts them)."""
    return [(s * K // wk, (s + 1) * K // wk) for s in range(wk)]


def vec_grid(n: int, elem_size: int, wk: int, resident: int
             ) -> Tuple[int, int]:
    """``(blocks, chunks)``: a block's chunk is 8 / W_k column groups of 32
    vectors; at most ``resident`` blocks (one wave) stride over the chunks.
    The blocks are as few as the rounds ceil(chunks / resident) allow, so
    each takes ceil or floor of chunks / blocks and the last round is as
    full as it can be (2²⁴ f32 columns: 512 blocks of 32 chunks, not 528
    of which 16 take a 32nd)."""
    chunks = -(-n // (VEC_WARPS // wk * 32 * vec_cols(elem_size)))
    rounds = -(-chunks // resident)
    return -(-chunks // rounds), chunks


@functools.lru_cache(maxsize=None)
def vec_blocks_per_sm(u_bf16: bool, w_bf16: bool, wk: int, K: int,
                      device_index: int) -> int:
    """Blocks of a ``combine_vec.cu`` instance resident per SM with K
    floats of α in shared memory (the occupancy query)."""
    lib = _build.load_library()
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.combine_vec_launch_config(int(u_bf16), int(w_bf16), wk, K,
                                           ctypes.byref(per_sm))
    _build.check(lib, rc, "combine_vec occupancy query")
    if per_sm.value < 1:
        raise RuntimeError(f"combine_vec: the kernel cannot be resident with "
                           f"K={K}")
    return per_sm.value


@functools.lru_cache(maxsize=4096)
def vec_plan(K: int, n: int, u_bf16: bool, w_bf16: bool,
             device_index: int) -> Tuple[int, int, int]:
    """``(W_k, blocks, chunks)`` of a ``combine_vec.cu`` launch."""
    sms = _build.sm_count(device_index)
    elem = 2 if u_bf16 else 4
    wk = combine_vec_split(K, n, elem, sms)
    per_sm = vec_blocks_per_sm(u_bf16, w_bf16, wk, K, device_index)
    return (wk, *vec_grid(n, elem, wk, per_sm * sms))


@functools.lru_cache(maxsize=None)
def _launchers(device_index: int):
    """``(lib, combine_launch, combine_vec_launch, combine.cu's grid cap)``
    of a device, looked up once."""
    lib = _build.load_library()
    return (lib, lib.combine_launch, lib.combine_vec_launch,
            BLOCKS_PER_SM * _build.sm_count(device_index))


def _check(params_vec: torch.Tensor, updates: torch.Tensor,
           alpha: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    dev = updates.device
    for name, t in (("params_vec", params_vec), ("updates", updates),
                    ("alpha", alpha)):
        if not t.is_cuda:
            raise ValueError(f"combine_cuda needs CUDA tensors; {name} is on "
                             f"{t.device}")
        if t.device != dev:
            raise ValueError(f"combine_cuda: {name} on {t.device}, updates "
                             f"on {dev}")
        if t is not updates and not t.is_contiguous():
            raise ValueError(f"combine_cuda: {name} must be contiguous")
    for name, t in (("params_vec", params_vec), ("updates", updates)):
        if t.dtype not in SUPPORTED_DTYPES:
            raise TypeError(f"combine_cuda: {name} dtype {t.dtype} not in "
                            f"{SUPPORTED_DTYPES}")
    if alpha.dtype != torch.float32:
        raise TypeError(f"combine_cuda: alpha must be float32, got "
                        f"{alpha.dtype}")
    if params_vec.dim() != 1 or updates.dim() != 2 or alpha.dim() != 1:
        raise ValueError("combine_cuda: want params_vec (n,), updates (K, n), "
                         f"alpha (K,); got {tuple(params_vec.shape)}, "
                         f"{tuple(updates.shape)}, {tuple(alpha.shape)}")
    K, n = updates.shape
    if params_vec.shape[0] != n or alpha.shape[0] != K:
        raise ValueError(f"combine_cuda: updates are ({K}, {n}) but "
                         f"params_vec has {params_vec.shape[0]} and alpha "
                         f"{alpha.shape[0]} entries")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"combine_cuda: K={K} outside [1, {MAX_K}]")
    if n < 1:
        raise ValueError("combine_cuda: n must be >= 1")
    if (n > 1 and updates.stride(1) != 1) or _row_stride(updates) < n:
        raise ValueError(f"combine_cuda: updates need unit-strided columns "
                         f"and rows at least n apart (strides "
                         f"{updates.stride()})")
    if out is not None and (out.device != dev or out.dtype != params_vec.dtype
                            or out.shape != params_vec.shape
                            or not out.is_contiguous()):
        raise ValueError("combine_cuda: out must be a contiguous tensor of "
                         "params_vec's shape and dtype on its device")


def combine_cuda(params_vec: torch.Tensor, updates: torch.Tensor,
                 alpha: torch.Tensor, *,
                 out: Optional[torch.Tensor] = None,
                 body: Optional[str] = None) -> torch.Tensor:
    """``params_vec (n,)``, ``updates (K, n)`` (each f32 or bf16),
    ``alpha (K,)`` f32 on one CUDA device, w and alpha contiguous and U
    with unit-strided columns (any row stride: a window of a wider slab is
    read as it lies) → ``(n,)`` in
    params_vec's dtype, written into ``out`` if given (which may be
    ``params_vec`` itself: an update in place).  The body is
    ``combine_vec.cu`` when :func:`_vec_eligible` holds and ``combine.cu``
    otherwise; ``body="scalar"`` runs an eligible call on ``combine.cu``
    instead, to compare the two bodies on one input (``"vec"`` on an
    ineligible call raises)."""
    _check(params_vec, updates, alpha, out)
    if body not in (None,) + BODIES:
        raise ValueError(f"combine_cuda: body {body!r} not in {BODIES}")
    if out is None:
        out = torch.empty_like(params_vec)
    vec = _vec_eligible(params_vec, updates, out)
    if body == "vec" and not vec:
        raise ValueError("combine_cuda: the vec body takes rows of U, w and "
                         "out that all start 16-byte aligned")
    vec = vec and body != "scalar"
    K, n = updates.shape
    ld = _row_stride(updates)
    dev = updates.device
    lib, scalar_fn, vec_fn, max_blocks = _launchers(dev.index)
    u_bf16 = updates.dtype == torch.bfloat16
    w_bf16 = params_vec.dtype == torch.bfloat16
    if vec:
        wk, blocks, _ = vec_plan(K, n, u_bf16, w_bf16, dev.index)
        fn, args = vec_fn, (params_vec.data_ptr(), updates.data_ptr(),
                            alpha.data_ptr(), out.data_ptr(), K, n, ld,
                            int(u_bf16), int(w_bf16), wk, blocks)
    else:
        fn, args = scalar_fn, (params_vec.data_ptr(), updates.data_ptr(),
                               alpha.data_ptr(), out.data_ptr(), K, n, ld,
                               int(u_bf16), int(w_bf16), max_blocks)
    # the current stream's handle, without building a torch.cuda.Stream
    # object on every call
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    _build.check(lib, rc, "combine")
    count_launch("combine", "cuda")
    _BODY_LAUNCHES["vec" if vec else "scalar"] += 1
    return out
