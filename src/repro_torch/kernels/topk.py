"""``topk``: the k largest-|v| entries of a vector — the Hopper kernel.

Replaces ``repro.kernels.topk.topk_select_pallas`` and its candidate merge.
The CUDA source (``csrc/topk.cu``) says what bounds it on the H100 and how
the radix select finds the top-k set; this module checks the inputs,
allocates the outputs and the scratch with ``torch.empty``, launches on the
current stream without synchronising, and then puts the k candidates in
``lax.top_k``'s order (|v| descending, the lower index first among ties)
with one stable ``torch.sort`` of the k values: a library sort of the
kernel's k survivors, as the reference's own final merge also runs outside
its Pallas kernel.
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


def grid(n: int, sm_count: int) -> Tuple[int, int]:
    """``(num_blocks, chunk)``: contiguous ranges of ``chunk`` entries, at
    most ``BLOCKS_PER_SM`` blocks per SM."""
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
    num_blocks, chunk = grid(n, _build.sm_count(dev.index))
    scratch = torch.empty((4 + num_blocks * (THREADS_BINS + 4),),
                          dtype=torch.int32, device=dev)
    vals = torch.empty((k,), dtype=torch.float32, device=dev)
    idx = torch.empty((k,), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.topk_launch(vec.data_ptr(), n, k, scratch.data_ptr(),
                             scratch.numel(), vals.data_ptr(), idx.data_ptr(),
                             num_blocks, chunk,
                             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "topk")
    count_launch("topk", "cuda")
    order = torch.sort(vals.abs(), descending=True, stable=True).indices
    return vals[order], idx[order]
