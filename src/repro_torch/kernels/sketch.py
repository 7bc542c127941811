"""``sketch``: S_U = U Rᵀ against an explicit sketch matrix R — the Hopper
kernel.

Replaces ``repro.kernels.sketch.sketch_apply_pallas``.  The CUDA source
(``csrc/sketch.cu`` over the shared body ``csrc/cross.cuh``) says what
bounds it on the H100 and how the deterministic split reduction is laid
out; this module checks the inputs, allocates the output and the scratch
with ``torch.empty`` and launches on the current stream without
synchronising.  For the counter-based sign sketch, whose R is never stored,
see ``rng_sketch.py``.
"""
from __future__ import annotations

import torch

from . import _build, cross
from .registry import count_launch


def sketch_apply_cuda(updates: torch.Tensor, sketch: torch.Tensor
                      ) -> torch.Tensor:
    """``updates (K, n)`` and ``sketch (m, n)``, f32 or bf16 each, any row
    stride with unit-strided columns, on one CUDA device → ``(K, m)`` f32."""
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
    _build.check(lib, rc, "sketch")
    count_launch("sketch", "cuda")
    return S
