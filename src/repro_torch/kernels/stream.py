"""``stream_stats``: the round statistics G = D Dᵀ and C = D GMᵀ of the
streamed round engine in one pass over n — the Hopper kernel.

Replaces ``repro.kernels.stream.stream_stats_pallas``.  It has three
bodies, chosen from the inputs alone (:func:`_body`):

* ``mma`` (``csrc/stream_stats.cu``'s ``stream_stats_mma``): the calls
  :func:`_mma_eligible` accepts — D and GM both bf16, P <= 32, rows 16-byte
  aligned, as every slab of the big-model round — on the bf16 tensor cores.
* ``f32`` (``csrc/cross_f32.cu``): D and GM both f32 — every launch of the
  streamed paths' P = 100 slabs — 8 x 8 register tiles over a ``cp.async``
  ring, the upper triangle of D Dᵀ only, one launch a call (its planner is
  in ``cross.py``).
* ``cross`` (``csrc/cross.cuh``): the rest (mixed inputs, P > 32 or
  unaligned bf16), which ``stream_stats_cuda(..., body="cross")`` also
  takes for any call, so the card can time it beside the f32 body.

This module checks the inputs, allocates the outputs (and a scratch only
where a body needs one) with ``torch.empty`` and launches on the current
stream without synchronising.  D and GM are taken as they lie — a (P,
width) view of a stacked leaf, any row stride — with no copy, pad or
upcast; ``out=(G, C)`` adds this slab's statistics into running sums.
``body_launches()`` tallies the launches by body, so a run can show which
body its path took.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build, cross
from .registry import count_launch

MMA_MAX_ROWS = 32     # the tensor-core body's P: two 16-row tiles
BODIES = ("mma", "f32", "cross")
_BODY_LAUNCHES = {body: 0 for body in BODIES}


def _mma_eligible(deltas: torch.Tensor, grads: torch.Tensor) -> bool:
    """Whether a call takes the tensor-core body: D and GM both bf16,
    1 <= P <= 32, n >= 1, both row strides multiples of 8 elements and both
    ``data_ptr()`` 16-byte aligned (every 16-byte load of a row is then
    aligned).  Reads only dtypes, shapes, strides and pointers."""
    P, n = deltas.shape
    return (deltas.dtype == torch.bfloat16 and grads.dtype == torch.bfloat16
            and 1 <= P <= MMA_MAX_ROWS and n >= 1
            and all(t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0
                    for t in (deltas, grads)))


def _body(deltas: torch.Tensor, grads: torch.Tensor) -> str:
    """The body a call takes: ``mma`` where :func:`_mma_eligible` holds,
    ``f32`` for D and GM both f32, ``cross`` for the rest."""
    if _mma_eligible(deltas, grads):
        return "mma"
    if deltas.dtype == grads.dtype == torch.float32:
        return "f32"
    return "cross"


def body_launches() -> Dict[str, int]:
    """``{"mma": launches, "f32": launches, "cross": launches}`` since the
    last reset."""
    return dict(_BODY_LAUNCHES)


def reset_body_launches() -> None:
    for key in _BODY_LAUNCHES:
        _BODY_LAUNCHES[key] = 0


def _check_out(out, P: int, device: torch.device) -> None:
    for name, t in zip(("G", "C"), out):
        if (t.device != device or t.dtype != torch.float32
                or tuple(t.shape) != (P, P) or not t.is_contiguous()):
            raise ValueError(f"stream_stats_cuda: out {name} must be a "
                             f"contiguous ({P}, {P}) float32 tensor on "
                             f"{device}")


def stream_stats_cuda(deltas: torch.Tensor, grads: torch.Tensor, *,
                      out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      body: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``deltas``, ``grads`` (P, n), f32 or bf16 each, unit-strided columns,
    on one CUDA device → ``(G (P, P), C (P, P))`` f32, on the body
    :func:`_body` picks; ``body=`` forces one (``"cross"`` takes any call;
    ``"f32"`` wants both f32, ``"mma"`` an eligible call).  With ``out`` the
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
    if body not in (None,) + BODIES:
        raise ValueError(f"stream_stats_cuda: body {body!r} not in {BODIES}")
    took = _body(deltas, grads)
    if body == "mma" and took != "mma":
        raise ValueError("stream_stats_cuda: the mma body takes bf16 D and GM "
                         f"with P <= {MMA_MAX_ROWS} and 16-byte aligned rows")
    if body == "f32" and took != "f32":
        raise ValueError("stream_stats_cuda: the f32 body takes f32 D and GM")
    took = body or took
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
    if took == "f32":
        cross.launch_f32("stream_stats", deltas, P, ldd, deltas, P, ldd,
                         grads, P, ldg, True, n, G, P, C, P, bool(accumulate))
    else:
        mma = took == "mma"
        partial, num_blocks, cols = cross.scratch(
            "stream_stats_launch_config", (P, int(mma)), n, dev)
        lib = _build.load_library()
        with torch.cuda.device(dev):
            if mma:
                rc = lib.stream_stats_mma_launch(
                    deltas.data_ptr(), ldd, grads.data_ptr(), ldg, P, n,
                    partial.data_ptr(), partial.numel(), num_blocks, cols,
                    G.data_ptr(), C.data_ptr(), accumulate,
                    cross.stream_of(dev))
            else:
                rc = lib.stream_stats_launch(
                    deltas.data_ptr(), ldd,
                    int(deltas.dtype == torch.bfloat16), grads.data_ptr(),
                    ldg, int(grads.dtype == torch.bfloat16), P, n,
                    partial.data_ptr(), partial.numel(), num_blocks, cols,
                    G.data_ptr(), C.data_ptr(), accumulate,
                    cross.stream_of(dev))
        _build.check(lib, rc, "stream_stats")
    count_launch("stream_stats", "cuda")
    _BODY_LAUNCHES[took] += 1
    return (G, C) if out is None else out
