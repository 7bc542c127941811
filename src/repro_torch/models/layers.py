"""Shared layer primitives of the port (``repro.models.layers``).

Parameters are plain tensors in nested dicts, as the reference's pytrees.
The initialisers draw from a ``torch.Generator`` in place of a
``jax.random`` key (the two give different numbers from one seed; parity
tests carry the reference's weights over with ``convert.params_from_jax``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------- init utils

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, scale: Optional[float] = None
               ) -> torch.Tensor:
    """N(0, 1)·scale (default ``in_dim ** -0.5``) of shape (in, out) in
    ``dtype`` on the generator's device."""
    scale = scale if scale is not None else in_dim ** -0.5
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in f32 with the (1 + w) scale, back in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


# ----------------------------------------------------------------------- RoPE

@functools.lru_cache(maxsize=None)
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """(head_dim/2,) f32; cached per (head_dim, theta, device), so a decode
    step does not launch the same four ops again in every layer."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq), broadcast as
    the reference's ``(S,)``, ``(1, C)`` and ``(B, 1)`` forms.  Halves are
    split, not interleaved."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)          # (hd/2,)
    angles = positions[..., :, None].float() * freqs             # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- activations

def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to approximate=True (the tanh form); torch's
    # default is the exact erf form
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "geglu": _gelu_tanh,
            "relu": F.relu}[name]


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


# -------------------------------------------------------------------- losses

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token-level CE. logits (..., V), labels (...,) int; with
    ``weights`` the weighted sum over max(Σ weights, 1), as in
    ``repro.models.layers.cross_entropy_loss``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / w.sum().clamp(min=1.0)
