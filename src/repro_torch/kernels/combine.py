"""``combine``: w' = w + Σ_k α_k U_k — the Hopper kernel.

Replaces ``repro.kernels.combine.combine_pallas``.  The CUDA source
(``csrc/combine.cu``) says what bounds it on the H100 and how the pass is
laid out; this module checks the inputs, allocates the output with
``torch.empty`` (or writes into the caller's ``out``, which may be the base
itself) and launches on the current stream without synchronising.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .registry import count_launch

MAX_K = 4096
BLOCKS_PER_SM = 8
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def _check(params_vec: torch.Tensor, updates: torch.Tensor,
           alpha: torch.Tensor) -> None:
    tensors = (("params_vec", params_vec), ("updates", updates),
               ("alpha", alpha))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"combine_cuda needs CUDA tensors; {name} is on "
                             f"{t.device}")
        if t.device != updates.device:
            raise ValueError(f"combine_cuda: {name} on {t.device}, updates "
                             f"on {updates.device}")
        if not t.is_contiguous():
            raise ValueError(f"combine_cuda: {name} must be contiguous")
    for name, t in tensors[:2]:
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


def combine_cuda(params_vec: torch.Tensor, updates: torch.Tensor,
                 alpha: torch.Tensor, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``params_vec (n,)``, ``updates (K, n)`` (each f32 or bf16),
    ``alpha (K,)`` f32, contiguous on one CUDA device → ``(n,)`` in
    params_vec's dtype, written into ``out`` if given (which may be
    ``params_vec`` itself: an update in place)."""
    _check(params_vec, updates, alpha)
    K, n = updates.shape
    dev = updates.device
    if out is None:
        out = torch.empty_like(params_vec)
    elif (out.device != dev or out.dtype != params_vec.dtype
          or out.shape != params_vec.shape or not out.is_contiguous()):
        raise ValueError("combine_cuda: out must be a contiguous tensor of "
                         "params_vec's shape and dtype on its device")
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.combine_launch(
            params_vec.data_ptr(), updates.data_ptr(), alpha.data_ptr(),
            out.data_ptr(), K, n, int(updates.dtype == torch.bfloat16),
            int(params_vec.dtype == torch.bfloat16),
            BLOCKS_PER_SM * _build.sm_count(dev.index),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "combine")
    count_launch("combine", "cuda")
    return out
