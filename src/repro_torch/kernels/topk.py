"""``topk``: the k largest-|v| entries of a vector — the Hopper kernel.

Replaces ``repro.kernels.topk.topk_select_pallas`` and its candidate merge.
The CUDA source (``csrc/topk.cu``) says what bounds each of its two paths on
the H100; this module checks the inputs, picks the path from (n, k) alone,
allocates the outputs (and the multi-block path's scratch) with
``torch.empty`` and launches on the current stream without synchronising.

* ``n <= SMALL_MAX_N`` (every paper-path shape): one launch of one block
  that selects, compacts and orders the top k itself, in ``lax.top_k``'s
  order (|v| descending, the lower index first among ties).
* above it: the multi-block radix select, whose k candidates are then put
  in that order with one stable ``torch.sort`` of the k values — a library
  sort of the kernel's k survivors, as the reference's own final merge also
  runs outside its Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .registry import count_launch

BLOCKS_PER_SM = 4
ENTRIES_PER_BLOCK = 1024      # fewest entries worth a block of its own
THREADS_BINS = 256            # histogram bins = threads per block
MAX_N = (1 << 31) - 1         # int32 indices
SMALL_MAX_N = 16384           # csrc/topk.cu kSmallMaxN: 4n + 8·2^⌈log2 k⌉ B of shared memory


def _check(vec: torch.Tensor, k: int) -> None:
    if not vec.is_cuda:
        raise ValueError(f"topk_cuda needs CUDA tensors; got {vec.device}")
    if vec.dtype != torch.float32:
        raise TypeError(f"topk_cuda: vec must be float32, got {vec.dtype}")
    if vec.dim() != 1 or not vec.is_contiguous():
        raise ValueError("topk_cuda: want a contiguous 1-D vector, got "
                         f"shape {tuple(vec.shape)}")
    n = vec.shape[0]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"topk_cuda: n={n} outside [1, {MAX_N}]")
    if k < 1:
        raise ValueError(f"topk_cuda: k={k} must be >= 1")


def single_block(n: int, k: int) -> bool:
    """Whether (n, k) takes the one-block select-and-order kernel: the whole
    vector and its k survivors fit one block's shared memory, which holds
    for any k <= n (``topk_cuda`` clamps k to n) up to ``SMALL_MAX_N``."""
    return n <= SMALL_MAX_N


def grid(n: int, sm_count: int) -> Tuple[int, int]:
    """``(num_blocks, chunk)`` of the multi-block path: contiguous ranges of
    ``chunk`` entries, at most ``BLOCKS_PER_SM`` blocks per SM."""
    blocks = max(1, min(BLOCKS_PER_SM * sm_count,
                        -(-n // ENTRIES_PER_BLOCK)))
    chunk = -(-n // blocks)
    return -(-n // chunk), chunk


def topk_cuda(vec: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``vec (n,)`` f32, contiguous on a CUDA device → ``(values (k,) f32,
    indices (k,) int32)``; k above n takes all n entries."""
    _check(vec, k)
    n = vec.shape[0]
    k = min(int(k), n)
    dev = vec.device
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if single_block(n, k):
        out = torch.empty((2 * k,), dtype=torch.int32, device=dev)
        vals, idx = out[:k].view(torch.float32), out[k:]
        with torch.cuda.device(dev):
            rc = lib.topk_small_launch(vec.data_ptr(), n, k, vals.data_ptr(),
                                       idx.data_ptr(), stream)
        _build.check(lib, rc, "topk")
        count_launch("topk", "cuda")
        return vals, idx
    num_blocks, chunk = grid(n, _build.sm_count(dev.index))
    scratch = torch.empty((4 + num_blocks * (THREADS_BINS + 4),),
                          dtype=torch.int32, device=dev)
    vals = torch.empty((k,), dtype=torch.float32, device=dev)
    idx = torch.empty((k,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.topk_launch(vec.data_ptr(), n, k, scratch.data_ptr(),
                             scratch.numel(), vals.data_ptr(), idx.data_ptr(),
                             num_blocks, chunk, stream)
    _build.check(lib, rc, "topk")
    count_launch("topk", "cuda")
    order = torch.sort(vals.abs(), descending=True, stable=True).indices
    return vals[order], idx[order]
