"""Launch plumbing shared by the three cross-product kernels of
``csrc/cross.cuh`` — ``stream_stats``, ``gram_block`` and ``sketch``.

Each of them computes a product A Bᵀ of row sets over n columns with the
same device body: a grid of (A row block, B row block) slices times a split
of the columns, then a finish pass that sums the per-block partials in
order.  This module checks a row-source tensor (its row stride goes to the
kernel, so a strided (P, width) view of a stacked leaf is taken as it lies),
asks the library for the partial kernel's occupancy and slice count, and
sizes the grid and the partial scratch.  Each kernel's own module
(``stream.py``, ``gram.py``, ``sketch.py``) allocates its outputs, launches
and counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

GRANULE = 256                 # a block's column range is a multiple of this
PARTIAL_FLOATS = 64 * 64      # one block's partial: 64-row blocks of A and B
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def row_stride(op: str, name: str, t: torch.Tensor,
               device: torch.device) -> int:
    """The row stride (elements) of a 2-D row-source tensor on ``device``
    with unit-strided columns; raises on anything the kernel cannot read."""
    if not t.is_cuda:
        raise ValueError(f"{op} needs CUDA tensors; {name} is on {t.device}")
    if t.device != device:
        raise ValueError(f"{op}: {name} on {t.device}, expected {device}")
    if t.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"{op}: {name} dtype {t.dtype} not in "
                        f"{SUPPORTED_DTYPES}")
    if t.dim() != 2:
        raise ValueError(f"{op}: {name} must be 2-D, got shape "
                         f"{tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{op}: {name}'s columns must be unit-strided "
                         f"(strides {t.stride()})")
    return int(t.stride(0))


def grid(n: int, sm_count: int, blocks_per_sm: int,
         slices: int) -> Tuple[int, int]:
    """``(num_blocks, cols_per_block)`` of each slice: one resident wave of
    blocks over all slices, each over a contiguous range of whole granules."""
    granules = -(-n // GRANULE)
    blocks = max(1, min(blocks_per_sm * sm_count // slices, granules))
    cols = -(-granules // blocks) * GRANULE
    return -(-n // cols), cols


@functools.lru_cache(maxsize=None)
def launch_config(config_fn: str, dims: Tuple[int, ...],
                  device_index: int) -> Tuple[int, int]:
    """``(blocks resident per SM, slices)`` of a kernel's partial pass for
    its row counts ``dims``."""
    lib = _build.load_library()
    blocks, slices = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        rc = getattr(lib, config_fn)(*dims, ctypes.byref(blocks),
                                     ctypes.byref(slices))
    _build.check(lib, rc, f"{config_fn} occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"{config_fn}: the partial kernel cannot be "
                           f"resident for rows {dims}")
    return blocks.value, slices.value


def scratch(config_fn: str, dims: Tuple[int, ...], n: int,
            device: torch.device) -> Tuple[torch.Tensor, int, int]:
    """``(partial, num_blocks, cols_per_block)`` for one launch over n
    columns: the grid and an uninitialised f32 scratch of one 64 x 64
    partial per (slice, column block)."""
    per_sm, slices = launch_config(config_fn, dims, device.index)
    num_blocks, cols = grid(n, _build.sm_count(device.index), per_sm, slices)
    partial = torch.empty((slices * num_blocks * PARTIAL_FLOATS,),
                          dtype=torch.float32, device=device)
    return partial, num_blocks, cols


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
