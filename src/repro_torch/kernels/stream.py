"""``stream_stats``: the round statistics G = D Dᵀ and C = D GMᵀ of the
streamed round engine in one pass over n — the Hopper kernel.

Replaces ``repro.kernels.stream.stream_stats_pallas``.  The CUDA source
(``csrc/stream_stats.cu`` over the shared body ``csrc/cross.cuh``) says
what bounds it on the H100 and how the deterministic split reduction is laid
out.  This module checks the inputs, allocates the outputs and the scratch
with ``torch.empty`` and launches on the current stream without
synchronising.  D and GM are taken as they lie — a (P, width) view of a
stacked leaf, any row stride — with no copy, pad or upcast; ``out=(G, C)``
adds this slab's statistics into running sums.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, cross
from .registry import count_launch


def _check_out(out, P: int, device: torch.device) -> None:
    for name, t in zip(("G", "C"), out):
        if (t.device != device or t.dtype != torch.float32
                or tuple(t.shape) != (P, P) or not t.is_contiguous()):
            raise ValueError(f"stream_stats_cuda: out {name} must be a "
                             f"contiguous ({P}, {P}) float32 tensor on "
                             f"{device}")


def stream_stats_cuda(deltas: torch.Tensor, grads: torch.Tensor, *,
                      out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``deltas``, ``grads`` (P, n), f32 or bf16 each, unit-strided columns,
    on one CUDA device → ``(G (P, P), C (P, P))`` f32.  With ``out`` the
    statistics are added into ``out`` (which is returned)."""
    dev = deltas.device
    ldd = cross.row_stride("stream_stats_cuda", "deltas", deltas, dev)
    ldg = cross.row_stride("stream_stats_cuda", "grads", grads, dev)
    if grads.shape != deltas.shape:
        raise ValueError(f"stream_stats_cuda: deltas/grads disagree: "
                         f"{tuple(deltas.shape)} vs {tuple(grads.shape)}")
    P, n = deltas.shape
    if P < 1:
        raise ValueError("stream_stats_cuda: P must be >= 1")
    if out is None:
        both = torch.empty((2, P, P), dtype=torch.float32, device=dev)
        G, C = both[0], both[1]
        accumulate = 0
    else:
        _check_out(out, P, dev)
        G, C = out
        accumulate = 1
    if n == 0:                            # no columns: nothing to launch
        if out is None:
            both.zero_()
        return (G, C) if out is None else out
    partial, num_blocks, cols = cross.scratch("stream_stats_launch_config",
                                              (P,), n, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.stream_stats_launch(
            deltas.data_ptr(), ldd, int(deltas.dtype == torch.bfloat16),
            grads.data_ptr(), ldg, int(grads.dtype == torch.bfloat16), P, n,
            partial.data_ptr(), partial.numel(), num_blocks, cols,
            G.data_ptr(), C.data_ptr(), accumulate, cross.stream_of(dev))
    _build.check(lib, rc, "stream_stats")
    count_launch("stream_stats", "cuda")
    return (G, C) if out is None else out
