"""Public kernel entry points of the port, dispatched by device.

Each op registers three implementations (see
:mod:`repro_torch.kernels.registry`): ``cuda`` (the hand-written Hopper
kernel), ``torch`` (the plain PyTorch version in ``kernels.ref``) and
``meta`` (shapes and costs for a traced step, ``kernels.meta``).  A CUDA
tensor launches the kernel, a CPU tensor runs the plain version, a ``meta``
tensor the ``meta`` one; ``backend=`` forces one.  The signatures
follow ``repro.kernels.ops``; ``use_pallas`` and ``block_n`` are gone
because the CUDA kernels choose their own tiling.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import meta, ref
from .combine import combine_cuda
from .decode_attn import flash_decode_cuda
from .gram import gram_block_cuda, gram_cuda
from .registry import count_launch, dispatch, register_impl
from .rng_sketch import sign_sketch_adjoint_cuda, sign_sketch_cuda
from .sketch import sketch_apply_cuda
from .stream import stream_stats_cuda
from .topk import topk_cuda

__all__ = ["flash_decode", "gram_and_cross", "gram_block_and_cross",
           "lse_merge", "sign_sketch", "sign_sketch_adjoint", "sketch_apply",
           "stream_stats", "topk_select", "weighted_combine"]


def _plain(op: str, fn):
    def run(*args):
        count_launch(op, "torch")
        return fn(*args)
    return run


def _combine_plain(params_vec, updates, alpha, *, out=None):
    count_launch("combine", "torch")
    res = ref.combine_ref(params_vec, updates, alpha)
    return res if out is None else out.copy_(res)


def _stream_stats_plain(deltas, grads, *, out=None):
    count_launch("stream_stats", "torch")
    G, C = ref.stream_stats_ref(deltas, grads)
    if out is None:
        return G, C
    out[0].add_(G)
    out[1].add_(C)
    return out


def _flash_decode_plain(q, k, v, lengths, *, window=None, softcap=None):
    count_launch("flash_decode", "torch")
    return ref.flash_decode_ref(q, k, v, lengths, window=window,
                                softcap=softcap)


register_impl("gram", "cuda", gram_cuda)
register_impl("gram", "torch", _plain("gram", ref.gram_ref))
register_impl("gram_block", "cuda", gram_block_cuda)
register_impl("gram_block", "torch", _plain("gram_block", ref.gram_block_ref))
register_impl("stream_stats", "cuda", stream_stats_cuda)
register_impl("stream_stats", "torch", _stream_stats_plain)
register_impl("combine", "cuda", combine_cuda)
register_impl("combine", "torch", _combine_plain)
register_impl("sketch", "cuda", sketch_apply_cuda)
register_impl("sketch", "torch", _plain("sketch", ref.sketch_ref))
register_impl("topk", "cuda", topk_cuda)
register_impl("topk", "torch", _plain("topk", ref.topk_ref))
register_impl("sign_sketch", "cuda", sign_sketch_cuda)
register_impl("sign_sketch", "torch", _plain("sign_sketch", ref.rng_sketch_ref))
register_impl("sign_sketch_adjoint", "cuda", sign_sketch_adjoint_cuda)
register_impl("sign_sketch_adjoint", "torch",
              _plain("sign_sketch_adjoint", ref.rng_sketch_adjoint_ref))
register_impl("flash_decode", "cuda", flash_decode_cuda)
register_impl("flash_decode", "torch", _flash_decode_plain)
for _op, _fn in meta.IMPLS.items():
    register_impl(_op, "meta", _fn)


def gram_and_cross(updates: torch.Tensor, grad: torch.Tensor, *,
                   backend: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused G = U Uᵀ, c = U g in f32.  updates (K, n), grad (n,)."""
    return dispatch("gram", updates, grad, backend=backend)


def gram_block_and_cross(ua: torch.Tensor, ub: torch.Tensor,
                         grad: torch.Tensor, *,
                         backend: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused hierarchical-merge block: G_ab = U_a U_bᵀ and c_a = U_a g
    in f32.  ua (Ka, n), ub (Kb, n), grad (n,) (named apart from
    ``core.gram.gram_block``, which returns G alone)."""
    return dispatch("gram_block", ua, ub, grad, backend=backend)


def stream_stats(deltas: torch.Tensor, grads: torch.Tensor, *,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 backend: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused round statistics G = D Dᵀ, C = D GMᵀ (P, P) in f32 from
    deltas/grads (P, n) in any float dtype.  With ``out=(G, C)`` they are
    added into ``out`` — the streamed engine's sum over leaf slabs.  The
    plain version upcasts the inputs whole, so on the card only
    ``backend="torch"`` or ``force_backend("torch")`` reaches it."""
    return dispatch("stream_stats", deltas, grads, out=out, backend=backend)


def weighted_combine(params_vec: torch.Tensor, updates: torch.Tensor,
                     alpha: torch.Tensor, *,
                     out: Optional[torch.Tensor] = None,
                     backend: Optional[str] = None) -> torch.Tensor:
    """w + Σ α_k U_k in w's dtype.  params_vec (n,), updates (K, n),
    alpha (K,) f32.  ``out`` (w's shape and dtype) receives the result and
    may be ``params_vec`` itself."""
    return dispatch("combine", params_vec, updates, alpha, out=out,
                    backend=backend)


def sketch_apply(updates: torch.Tensor, sketch: torch.Tensor, *,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Stacked sketch-apply ``U Rᵀ`` (K, m) f32 against an explicit sketch
    matrix: updates (K, n), sketch (m, n).  For the counter-based sign
    sketch that never materializes R, use :func:`sign_sketch`."""
    if updates.shape[-1] != sketch.shape[-1]:
        raise ValueError(f"sketch operands disagree on n: "
                         f"{updates.shape[-1]} vs {sketch.shape[-1]}")
    return dispatch("sketch", updates, sketch, backend=backend)


def topk_select(vec: torch.Tensor, k: int, *,
                backend: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest-|v| entries of ``vec (n,)`` f32 as ``(values f32,
    indices int32)``, ordered by |v| descending, the lower index first among
    ties (``repro.kernels.ops.topk_select``).  k above n takes all n."""
    return dispatch("topk", vec, k, backend=backend)


def sign_sketch(updates: torch.Tensor, seed: int, m: int, *,
                backend: Optional[str] = None) -> torch.Tensor:
    """Counter-based sign sketch ``U Rᵀ/√m``: ``updates (K, n)`` → ``(K, m)``
    f32, R generated from (row, column, uint32 ``seed``) and never stored."""
    return dispatch("sign_sketch", updates, seed, m, backend=backend)


def sign_sketch_adjoint(coords: torch.Tensor, seed: int, n: int, *,
                        backend: Optional[str] = None) -> torch.Tensor:
    """Decode-side adjoint ``Rᵀ s/√m``: ``coords (m,)`` → ``(n,)`` f32, the
    same implicit R."""
    return dispatch("sign_sketch_adjoint", coords, seed, n, backend=backend)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 backend: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token attention against a KV cache; returns the f32 partials
    ``(o (B, KV, G, hd), lse (B, KV, G, 1))``.  q (B, KV, G, hd) against
    k, v (B, S, KV, hd) with per-row ``lengths`` (B,) int32 (= position + 1)
    masking, an optional sliding ``window`` and tanh ``softcap`` — the
    serving engine's per-slot contract (``models.attention.
    attention_decode_slots`` calls it once per layer per decode step).

    A block of a cache split on its seq axis (the placed decode step) is
    passed as it lies, with local lengths: for a block whose first row is
    global position ``start``, ``lengths = position + 1 - start``.  They
    may be ≤ 0 (no live row in the block: o = 0, lse ≤ -1e30, no NaN) or
    past S (every row up to S live); a window keeps rows at global
    positions > position - window, across a block edge too.  The blocks'
    partials merge by :func:`lse_merge` into the whole cache's.  The plain
    version reads every row of the cache, so on the card only
    ``backend="torch"`` or ``force_backend("torch")`` reaches it."""
    return dispatch("flash_decode", q, k, v, lengths, window=window,
                    softcap=softcap, backend=backend)


def lse_merge(o_parts: torch.Tensor, lse_parts: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine per-shard ``(o, lse)`` partials of a flash_decode over a
    cache whose seq axis was split: o_parts (P, B, KV, G, hd), lse_parts
    (P, B, KV, G, 1) → (o, lse).  Plain torch (a few elementwise ops on
    small tensors; the kernel merges its own splits inside)."""
    return ref.lse_merge_ref(o_parts, lse_parts)
