"""Plain PyTorch versions of the ported kernels (``repro.kernels.ref``).

They are what a CPU tensor runs, what the CPU tests hold against the JAX
reference, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card.  Accumulation is f32 and output dtypes follow the reference.  On the
card ``gram_ref`` goes through ``torch.matmul``: keep
``torch.backends.cuda.matmul.allow_tf32`` False when comparing (TF32 keeps
about three decimal digits).
"""
from __future__ import annotations

from typing import Tuple

import torch


def gram_ref(updates: torch.Tensor, grad: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G = U Uᵀ, c = U g) in f32 — plain version of kernels.gram."""
    u = updates.float()
    g = grad.float()
    return u @ u.T, u @ g


def combine_ref(params_vec: torch.Tensor, updates: torch.Tensor,
                alpha: torch.Tensor) -> torch.Tensor:
    """w + Σ_k α_k U_k with f32 accumulation, in w's dtype — plain version
    of kernels.combine."""
    comb = torch.einsum("k,kn->n", alpha.float(), updates.float())
    return (params_vec.float() + comb).to(params_vec.dtype)
