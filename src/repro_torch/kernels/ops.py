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

__all__ = ["gram_and_cross", "weighted_combine"]


def _plain(op: str, fn):
    def run(*args):
        count_launch(op, "torch")
        return fn(*args)
    return run


register_impl("gram", "cuda", gram_cuda)
register_impl("gram", "torch", _plain("gram", ref.gram_ref))
register_impl("combine", "cuda", combine_cuda)
register_impl("combine", "torch", _plain("combine", ref.combine_ref))


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
