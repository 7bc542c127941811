"""Public kernel entry points of the port, dispatched by device.

Each op registers two implementations (see :mod:`repro_torch.kernels.registry`):
``cuda`` (the hand-written Hopper kernel) and ``torch`` (the plain PyTorch
version in ``kernels.ref``).  A CUDA tensor launches the kernel, a CPU
tensor runs the plain version; ``backend=`` forces one.  The signatures
follow ``repro.kernels.ops``; ``use_pallas`` and ``block_n`` are gone
because the CUDA kernels choose their own tiling.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .combine import combine_cuda
from .gram import gram_cuda
from .registry import count_launch, dispatch, register_impl
from .rng_sketch import sign_sketch_adjoint_cuda, sign_sketch_cuda
from .topk import topk_cuda

__all__ = ["gram_and_cross", "sign_sketch", "sign_sketch_adjoint",
           "topk_select", "weighted_combine"]


def _plain(op: str, fn):
    def run(*args):
        count_launch(op, "torch")
        return fn(*args)
    return run


register_impl("gram", "cuda", gram_cuda)
register_impl("gram", "torch", _plain("gram", ref.gram_ref))
register_impl("combine", "cuda", combine_cuda)
register_impl("combine", "torch", _plain("combine", ref.combine_ref))
register_impl("topk", "cuda", topk_cuda)
register_impl("topk", "torch", _plain("topk", ref.topk_ref))
register_impl("sign_sketch", "cuda", sign_sketch_cuda)
register_impl("sign_sketch", "torch", _plain("sign_sketch", ref.rng_sketch_ref))
register_impl("sign_sketch_adjoint", "cuda", sign_sketch_adjoint_cuda)
register_impl("sign_sketch_adjoint", "torch",
              _plain("sign_sketch_adjoint", ref.rng_sketch_adjoint_ref))


def gram_and_cross(updates: torch.Tensor, grad: torch.Tensor, *,
                   backend: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused G = U Uᵀ, c = U g in f32.  updates (K, n), grad (n,)."""
    return dispatch("gram", updates, grad, backend=backend)


def weighted_combine(params_vec: torch.Tensor, updates: torch.Tensor,
                     alpha: torch.Tensor, *,
                     backend: Optional[str] = None) -> torch.Tensor:
    """w + Σ α_k U_k in w's dtype.  params_vec (n,), updates (K, n),
    alpha (K,) f32."""
    return dispatch("combine", params_vec, updates, alpha, backend=backend)


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
