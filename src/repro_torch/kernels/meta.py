"""The ``meta`` backend of the nine kernel ops: what a traced step runs.

A dry run (``launch.dryrun``) traces a step on fake tensors of the ``meta``
device (``FakeTensorMode``: shapes and dtypes, no storage), so a kernel op
there has no data to read and no card to launch on.  Its ``meta``
implementation here:

  * returns empty outputs of the CUDA launcher's own shapes and dtypes (the
    plain version's), as the launcher allocates them, and allocates the
    launcher's scratch beside them for the length of the call, so a memory
    tracker sees what the card would hold;
  * reports the op's FLOPs and bytes to every active cost sink
    (:func:`cost_sink`; ``launch.hlo_analysis.TraceCost`` opens one): each
    input byte read once and each output byte written once, as the bound
    of ``PERF.md`` §6 counts them;
  * counts one launch under ``op/meta``.

It never runs the plain version: those upcast whole inputs to f32
(``kernels/ref.py``), which would put three f32 copies of an expert leaf
into the predicted peak of a step whose real combine writes in place.

The launchers size their per-block scratch from an occupancy query that
needs the card.  Here one wave is taken at its largest: ``SMS`` SMs of the
H100 SXM, each holding ``MAX_BLOCKS_PER_SM`` blocks (sm_90's limit), cut to
the column blocks the shapes give, so a scratch is never smaller than the
card's.  A body is chosen from dtypes and shapes alone (a fake tensor has
no pointer to test for alignment).  ``flash_decode``'s lengths are data: a
trace counts every row its window allows.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import cross as _cross_mod
from . import gram as _gram_mod
from . import topk as _topk_mod
from .cross import GRANULE, PARTIAL_FLOATS
from .decode_attn import MAX_G, MMA_HEAD_DIMS, decode_splits
from .registry import count_launch

SMS = 132                  # SMs of one H100 SXM
MAX_BLOCKS_PER_SM = 32     # resident blocks an SM holds at most (sm_90)
WAVE = SMS * MAX_BLOCKS_PER_SM
CROSS_ROWS = 64            # cross.cuh's row blocks of A and B
F32 = torch.float32
BF16 = torch.bfloat16

_SINKS: List[Callable[[str, float, float], None]] = []


@contextlib.contextmanager
def cost_sink(fn: Callable[[str, float, float], None]):
    """Within the block, every ``meta`` op calls ``fn(op, flops, bytes)``."""
    _SINKS.append(fn)
    try:
        yield fn
    finally:
        _SINKS.remove(fn)


def _bytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _record(op: str, flops: float, nbytes: float) -> None:
    count_launch(op, "meta")
    for fn in _SINKS:
        fn(op, float(flops), float(nbytes))


def _empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def _cross_scratch(rows_a: int, rows_b: int, n: int, like) -> torch.Tensor:
    """cross.cuh's partials: one 64 x 64 block a (A, B) row-block pair and
    column block, over one wave."""
    slices = -(-rows_a // CROSS_ROWS) * -(-rows_b // CROSS_ROWS)
    blocks = max(1, min(WAVE // slices, -(-n // GRANULE)))
    return _empty((slices * blocks * PARTIAL_FLOATS,), F32, like)


def _cross_f32_scratch(ma: int, m1: int, m2: int, sym: bool, n: int,
                       like) -> torch.Tensor:
    """cross_f32.cu's partials: none where one block owns a slice's
    columns, else one per slice and column block, over one wave."""
    level = _cross_mod.f32_level(ma, m1, m2, sym, n, SMS)
    cuts = _cross_mod.F32Cuts.of(ma, m1, m2, sym, level)
    blocks, _ = _cross_mod.f32_grid(n, SMS, MAX_BLOCKS_PER_SM, cuts.slices())
    return _empty((_cross_mod.f32_scratch_floats(cuts, blocks),), F32, like)


def gram(updates: torch.Tensor, grad: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    K, n = updates.shape
    out = _empty((K * K + K,), F32, updates)
    if updates.dtype == F32 and grad.dtype == F32:     # gram_f32.cu
        blocks, _ = _gram_mod.grid(n, SMS, MAX_BLOCKS_PER_SM,
                                   _gram_mod.f32_num_slices(K))
        floats = _gram_mod.f32_scratch_floats(K, blocks)
    else:
        mma = (updates.dtype == BF16 and grad.dtype == BF16
               and 1 <= K <= _gram_mod.MMA_MAX_K and n % 8 == 0)
        slices, R = ((1, _gram_mod.mma_rows(K)) if mma else
                     (_gram_mod.row_slices(K), _gram_mod.scratch_rows(K)))
        blocks, _ = _gram_mod.grid(n, SMS, MAX_BLOCKS_PER_SM, slices)
        floats = slices * blocks * R * R
    partial = _empty((floats,), F32, updates)  # noqa: F841
    _record("gram", 2 * n * (K * (K + 1) // 2 + K),
            _bytes(updates, grad, out))
    return out[:K * K].view(K, K), out[K * K:]


def gram_block(ua: torch.Tensor, ub: torch.Tensor, grad: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    (Ka, n), Kb = ua.shape, ub.shape[0]
    out = _empty((Ka * Kb + Ka,), F32, ua)
    if (all(t.dtype == BF16 for t in (ua, ub, grad))
            and 1 <= Ka <= _gram_mod.BLOCK_MMA_MAX_KA
            and 1 <= Kb <= _gram_mod.BLOCK_MMA_MAX_KB and n % 8 == 0):
        blocks, _ = _gram_mod.grid(n, SMS, MAX_BLOCKS_PER_SM)
        ra, rb = _gram_mod.block_mma_rows(Ka, Kb)
        partial = _empty((blocks * ra * rb,), F32, ua)  # noqa: F841
    elif all(t.dtype == F32 for t in (ua, ub, grad)):     # cross_f32.cu
        partial = _cross_f32_scratch(Ka, Kb, 1, False, n, ua)  # noqa: F841
    else:
        partial = _cross_scratch(Ka, Kb + 1, n, ua)  # noqa: F841
    _record("gram_block", 2 * n * Ka * (Kb + 1), _bytes(ua, ub, grad, out))
    return out[:Ka * Kb].view(Ka, Kb), out[Ka * Kb:]


def stream_stats(deltas: torch.Tensor, grads: torch.Tensor, *,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    P, n = deltas.shape
    res = tuple(_empty((2, P, P), F32, deltas).unbind(0)) if out is None \
        else tuple(out)
    if deltas.dtype == F32 and grads.dtype == F32:      # cross_f32.cu
        partial = _cross_f32_scratch(P, P, P, True, n, deltas)  # noqa: F841
    else:
        partial = _cross_scratch(P, 2 * P, n, deltas)  # noqa: F841
    # with ``out`` the statistics are added into it: read, then written
    _record("stream_stats", 2 * n * (P * (P + 1) // 2 + P * P),
            _bytes(deltas, grads, *res) + (0 if out is None else _bytes(*res)))
    return res


def combine(params_vec: torch.Tensor, updates: torch.Tensor,
            alpha: torch.Tensor, *, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    K, n = updates.shape
    if out is None:
        out = torch.empty_like(params_vec)
    _record("combine", 2 * K * n + n,
            _bytes(params_vec, updates, alpha, out))
    return out


def sketch(updates: torch.Tensor, sketch_m: torch.Tensor) -> torch.Tensor:
    (K, n), m = updates.shape, sketch_m.shape[0]
    S = _empty((K, m), F32, updates)
    partial = _cross_scratch(K, m, n, updates)  # noqa: F841
    _record("sketch", 2 * n * K * m, _bytes(updates, sketch_m, S))
    return S


def topk(vec: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    n = vec.shape[0]
    k = min(int(k), n)
    if _topk_mod.single_block(n, k):
        out = _empty((2 * k,), torch.int32, vec)
        vals, idx = out[:k].view(F32), out[k:]
    else:
        blocks, _ = _topk_mod.grid(n, SMS)
        bins = _topk_mod.THREADS_BINS
        scratch = _empty((4 + blocks * (bins + 4),), torch.int32,  # noqa: F841
                         vec)
        vals, idx = _empty((k,), F32, vec), _empty((k,), torch.int32, vec)
    _record("topk", 0, _bytes(vec, vals, idx))
    return vals, idx


def sign_sketch(updates: torch.Tensor, seed: int, m: int) -> torch.Tensor:
    K, n = updates.shape
    out = _empty((K, m), F32, updates)
    _record("sign_sketch", 2 * K * m * n, _bytes(updates, out))
    return out


def sign_sketch_adjoint(coords: torch.Tensor, seed: int, n: int
                        ) -> torch.Tensor:
    m = coords.shape[0]
    out = _empty((n,), F32, coords)
    _record("sign_sketch_adjoint", 2 * m * n, _bytes(coords, out))
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, window: Optional[int] = None,
                 softcap: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, KV, hd = k.shape
    G = q.shape[2]
    o = _empty((B, KV, G, hd), F32, q)
    lse = _empty((B, KV, G, 1), F32, q)
    # the tensor-core calls merge their splits inside a cluster: no
    # partials; the CUDA-core body's splits go through scratch
    cluster = (all(t.dtype == BF16 for t in (q, k, v))
               and hd in MMA_HEAD_DIMS and 1 <= G <= MAX_G)
    splits = 1 if cluster else decode_splits(B, S, KV, WAVE, window)[0]
    if splits > 1:
        parts = (_empty((splits, B, KV, G, hd), F32, q),  # noqa: F841
                 _empty((splits, B, KV, G), F32, q))
    live = min(S, window) if window else S
    _record("flash_decode", 4 * B * live * KV * G * hd,
            2 * B * live * KV * hd * k.element_size()
            + _bytes(q, lengths, o, lse))
    return o, lse


IMPLS: Dict[str, Callable] = {
    "gram": gram, "gram_block": gram_block, "stream_stats": stream_stats,
    "combine": combine, "sketch": sketch, "topk": topk,
    "sign_sketch": sign_sketch, "sign_sketch_adjoint": sign_sketch_adjoint,
    "flash_decode": flash_decode}
