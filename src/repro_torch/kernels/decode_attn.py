"""``flash_decode``: single-token GQA attention against a KV cache — the
Hopper kernel.

Replaces ``repro.kernels.decode_attn.flash_decode_pallas``.  It has two
bodies, chosen from the inputs alone (:func:`_mma_eligible`): a call with
q, k and v all bf16, hd 64 or 128, G <= 16 and 16-byte aligned pointers
runs on the bf16 tensor cores (``csrc/decode_attn_mma.cu``), its splits
anchored at each row's live window (:func:`decode_mma_splits`); every
other call (f32 caches, f32 q against a bf16 cache, hd 256) on the CUDA
cores (``csrc/decode_attn.cu``), its splits tiling the whole cache
(:func:`decode_splits`).  No f32 operand is rounded to bf16 to reach a
tensor core.  Each source says what bounds it on the H100 and how the work
is laid out; this module checks the inputs, chooses the seq-axis split from
the shapes alone, allocates the outputs and the split partials with
``torch.empty`` and launches on the current stream without synchronising.
``body_launches()`` tallies the launches by body.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .registry import count_launch

HEAD_DIMS = (64, 128, 256)
MAX_G = 16                 # query rows per KV head (12 for starcoder2)
MAX_G_X_HD = 2048          # G · hd: the registers of a lane's accumulators
SPLIT_GRANULE = 64         # a split's rows are a multiple of this
MAX_SPLITS = 4096          # the merge keeps one weight per split in 16 KB
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
MMA_HEAD_DIMS = (64, 128)  # the tensor-core body's instances
MMA_TILE_ROWS = 64         # rows of its staged tiles; its splits' multiple
BODIES = ("mma", "cuda_core")
_BODY_LAUNCHES = {body: 0 for body in BODIES}


def _mma_eligible(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a call takes the tensor-core body: q, k and v all bf16,
    hd in (64, 128), 1 <= G <= 16, q contiguous, k and v with a contiguous
    last dim and strides of whole 16-byte units, and all three
    ``data_ptr()`` 16-byte aligned.  Reads only dtypes, shapes, strides and
    pointers."""
    return (q.dim() == 4 and k.dim() == 4 and v.dim() == 4
            and all(t.dtype == torch.bfloat16 for t in (q, k, v))
            and k.shape[3] in MMA_HEAD_DIMS and 1 <= q.shape[2] <= MAX_G
            and q.is_contiguous() and q.data_ptr() % 16 == 0
            and all(t.stride(3) == 1 and t.data_ptr() % 16 == 0
                    and all(s % 8 == 0 for s in t.stride()[:3])
                    for t in (k, v)))


def body_launches() -> Dict[str, int]:
    """``{"mma": launches, "cuda_core": launches}`` since the last reset."""
    return dict(_BODY_LAUNCHES)


def reset_body_launches() -> None:
    for key in _BODY_LAUNCHES:
        _BODY_LAUNCHES[key] = 0


def decode_mma_splits(B: int, S: int, KV: int, resident: int,
                      window: Optional[int] = None) -> Tuple[int, int]:
    """``(splits, rows per split)`` of the tensor-core body, from the shapes
    alone: the rows a query can see, ``live`` = min(S, window) (S without a
    window), are cut into whole ``MMA_TILE_ROWS``-row splits so that
    B·KV·splits blocks fill one wave of the ``resident`` blocks the card
    holds (one split a head when B·KV alone fills it).  The kernel anchors
    split j of batch row b at its own window: rows [lo_b + j·rows,
    min(lo_b + (j+1)·rows, len_b)), lo_b = max(0, len_b - window)."""
    live = min(S, window) if window else S
    per_row = max(1, resident // (B * KV))
    splits = max(1, min(per_row, -(-live // MMA_TILE_ROWS)))
    rows = -(-live // splits)
    rows = -(-rows // MMA_TILE_ROWS) * MMA_TILE_ROWS
    return -(-live // rows), rows


def decode_splits(B: int, S: int, KV: int, resident: int,
                  window: Optional[int] = None) -> Tuple[int, int]:
    """``(splits, rows per split)`` of the seq axis, from the shapes alone —
    never from the lengths, so a slot's output depends only on its own rows
    and not on what the other slots hold.  ``resident`` is how many blocks
    the card holds at once (blocks per SM × SMs): the rows a query can see
    (all S, or the last ``window``) are cut so that the blocks with live
    rows fill one wave, in whole ``SPLIT_GRANULE``-row splits, at most
    ``MAX_SPLITS`` of them."""
    live = min(S, window) if window else S
    per_row = max(1, resident // (B * KV))
    live_splits = max(1, min(per_row, -(-live // SPLIT_GRANULE)))
    rows = max(-(-live // live_splits), -(-S // MAX_SPLITS))
    rows = -(-rows // SPLIT_GRANULE) * SPLIT_GRANULE
    return -(-S // rows), rows


@functools.lru_cache(maxsize=None)
def resident_blocks(hd: int, G: int, bf16: bool, device_index: int) -> int:
    """Blocks of the partial kernel the card holds at once for this head
    shape and cache type (the occupancy query × the SMs)."""
    lib = _build.load_library()
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.flash_decode_launch_config(hd, G, int(bf16),
                                            ctypes.byref(per_sm))
    _build.check(lib, rc, "flash_decode occupancy query")
    if per_sm.value < 1:
        raise RuntimeError(f"flash_decode: the kernel cannot be resident for "
                           f"hd={hd}, G={G}")
    return per_sm.value * _build.sm_count(device_index)


@functools.lru_cache(maxsize=None)
def mma_resident_blocks(hd: int, device_index: int) -> int:
    """Blocks of the tensor-core body's partial kernel the card holds at
    once at head dim ``hd`` (the occupancy query × the SMs)."""
    lib = _build.load_library()
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.flash_decode_mma_launch_config(hd, ctypes.byref(per_sm))
    _build.check(lib, rc, "flash_decode_mma occupancy query")
    if per_sm.value < 1:
        raise RuntimeError(f"flash_decode: the tensor-core body cannot be "
                           f"resident for hd={hd}")
    return per_sm.value * _build.sm_count(device_index)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor, window: Optional[int],
           softcap: Optional[float]) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_cuda:
            raise ValueError(f"flash_decode_cuda needs CUDA tensors; {name} "
                             f"is on {t.device}")
        if t.device != k.device:
            raise ValueError(f"flash_decode_cuda: {name} on {t.device}, k on "
                             f"{k.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_decode_cuda: want q (B, KV, G, hd) and k, v "
                         f"(B, S, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, KV, hd = k.shape
    if q.shape[0] != B or q.shape[1] != KV or q.shape[3] != hd:
        raise ValueError(f"flash_decode_cuda: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    G = q.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode_cuda: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if not 1 <= G <= MAX_G or G * hd > MAX_G_X_HD:
        raise ValueError(f"flash_decode_cuda: G={G} with head_dim {hd}; "
                         f"want G <= {MAX_G} and G*hd <= {MAX_G_X_HD}")
    if B < 1 or S < 1 or B > 65535 or KV > 65535:
        raise ValueError(f"flash_decode_cuda: B={B}, S={S}, KV={KV} outside "
                         "the grid")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"flash_decode_cuda: q {q.dtype}, k {k.dtype}; want "
                        f"{SUPPORTED_DTYPES}")
    if v.dtype != k.dtype:
        raise TypeError(f"flash_decode_cuda: k is {k.dtype}, v {v.dtype}")
    if not q.is_contiguous():
        raise ValueError("flash_decode_cuda: q must be contiguous")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        raise ValueError("flash_decode_cuda: lengths must be a contiguous "
                         f"(B,) int32 tensor; got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    # each lane reads 16 aligned bytes of a row: rows in place, any stride
    # of whole 16-byte units
    unit = 16 // k.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % unit for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_decode_cuda: {name} needs a contiguous "
                             "last dim, 16-byte aligned rows and strides of "
                             f"whole 16-byte units; strides {t.stride()}")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode_cuda: window {window} < 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_decode_cuda: softcap {softcap} <= 0")


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, *, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      body: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, KV, G, hd) contiguous; k, v (B, S, KV, hd) strided views (each
    row's hd entries contiguous); lengths (B,) int32 → ``(o (B, KV, G,
    hd) f32, lse (B, KV, G, 1) f32)``.  Only live rows are read: rows t
    with max(0, length - window) <= t < min(length, S).  A block of a
    seq-split cache passes local lengths (position + 1 - the block's first
    global row): any int; a row with no live key in the block (length
    <= 0, or a window that ends before the block) gives o = 0 and lse =
    -1e30 from both bodies, and weighs 0 in the split merge and in
    ``ops.lse_merge``.  The body
    is the tensor-core one when :func:`_mma_eligible` holds and the CUDA-core
    one otherwise; ``body="cuda_core"`` runs an eligible call on the CUDA
    cores instead, to compare the two bodies on one input (``"mma"`` on an
    ineligible call raises)."""
    _check(q, k, v, lengths, window, softcap)
    if body not in (None,) + BODIES:
        raise ValueError(f"flash_decode_cuda: body {body!r} not in {BODIES}")
    eligible = _mma_eligible(q, k, v)
    if body == "mma" and not eligible:
        raise ValueError("flash_decode_cuda: the tensor-core body takes bf16 "
                         f"q, k, v with hd in {MMA_HEAD_DIMS}, G <= {MAX_G} "
                         "and 16-byte aligned rows")
    mma = eligible if body is None else body == "mma"
    B, S, KV, hd = k.shape
    G = q.shape[2]
    dev = k.device
    o = torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev)
    lse = torch.empty((B, KV, G, 1), dtype=torch.float32, device=dev)
    if mma:
        splits, rows = decode_mma_splits(
            B, S, KV, mma_resident_blocks(hd, dev.index), window)
    else:
        splits, rows = decode_splits(
            B, S, KV, resident_blocks(hd, G, k.dtype == torch.bfloat16,
                                      dev.index), window)
    if splits > 1:
        o_part = torch.empty((splits, B, KV, G, hd), dtype=torch.float32,
                             device=dev)
        lse_part = torch.empty((splits, B, KV, G), dtype=torch.float32,
                               device=dev)
    else:
        o_part, lse_part = o, lse
    lib = _build.load_library()
    flags = (int(window is not None), window or 0, int(softcap is not None),
             softcap or 0.0, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if mma:
            rc = lib.flash_decode_mma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                o.data_ptr(), lse.data_ptr(), o_part.data_ptr(),
                lse_part.data_ptr(), B, S, KV, G, hd, *k.stride()[:3],
                *v.stride()[:3], splits, rows, hd ** -0.5, *flags)
        else:
            rc = lib.flash_decode_launch(
                q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
                v.data_ptr(), int(k.dtype == torch.bfloat16),
                lengths.data_ptr(), o.data_ptr(), lse.data_ptr(),
                o_part.data_ptr(), lse_part.data_ptr(), B, S, KV, G, hd,
                *k.stride()[:3], *v.stride()[:3], splits, rows, hd ** -0.5,
                *flags)
    _build.check(lib, rc, "flash_decode")
    count_launch("flash_decode", "cuda")
    _BODY_LAUNCHES["mma" if mma else "cuda_core"] += 1
    return o, lse
