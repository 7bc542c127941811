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

from ..core.distributed import (copy_to_model, max_over_model, model_shard,
                                reduce_from_model)


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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm computed in f32 with the population variance (``jnp.var``;
    torch's default would be the unbiased one), back in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


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


@functools.lru_cache(maxsize=8)
def sinusoidal_positions(num_positions: int, dim: int,
                         device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (num_positions, dim) in f32:
    ``[sin, cos]`` of ``pos / 10000 ** (2i / dim)``, as the reference
    computes them.  Cached per (num_positions, dim, device) like
    ``rope_frequencies``: a decode step reads one row of the same table in
    every step.  Callers must not write into the result."""
    pos = torch.arange(num_positions, dtype=torch.float32,
                       device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10_000.0, 2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------- matmuls

def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with jnp's type promotion: where the dtypes differ both
    are cast up to the wider one (f32 activations against bf16 weights give
    an f32 product, as ``jnp.matmul`` does; torch's ``@`` refuses the mix).
    The whisper encoder meets this when bf16 weights see f32 frames."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


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


# ----------------------------------------------------- vocab-parallel parts

def _vocab_split(rows: int, vocab: int) -> bool:
    """Inside ``model_parallel``: is a vocabulary leaf of ``rows`` rows
    this rank's V/m block (False: whole on every rank, as the spec rules
    leave a vocabulary that does not divide)?"""
    shard = model_shard()
    return shard is not None and rows * shard.size == vocab


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """``embed[tokens]``; inside ``model_parallel`` ``embed`` is this
    rank's block of V/m vocabulary rows: each rank looks up the tokens it
    holds (zeros elsewhere) and the rows are summed over ``model``, exact
    (one nonzero term a token)."""
    if not _vocab_split(embed.shape[0], vocab):
        return embed[tokens]
    shard = model_shard()
    rows = embed.shape[0]
    local = tokens.long() - shard.rank * rows
    held = (local >= 0) & (local < rows)
    x = embed[local.clamp(0, rows - 1)]
    return reduce_from_model(torch.where(held[..., None], x,
                                         torch.zeros((), dtype=x.dtype,
                                                     device=x.device)))


def lm_logits(x: torch.Tensor, head: torch.Tensor,
              vocab: int) -> torch.Tensor:
    """``x @ head``; inside ``model_parallel`` ``head`` (d, V/m) is this
    rank's vocabulary columns and so are the logits
    (:func:`cross_entropy_loss` reads them so)."""
    if not _vocab_split(head.shape[-1], vocab):
        return x @ head
    return copy_to_model(x) @ head


# -------------------------------------------------------------------- losses

def _vocab_parallel_nll(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """−log softmax(logits)[label] in f32 with the vocabulary split over
    ``model`` (logits (..., V/m) this rank's columns): the max, Σ exp and
    the label's logit are each summed (max-reduced) over the ranks, so no
    rank forms the whole (..., V) row."""
    shard = model_shard()
    lf = logits.float()
    cols = lf.shape[-1]
    top = max_over_model(lf.amax(dim=-1, keepdim=True))
    sum_exp = reduce_from_model(torch.exp(lf - top).sum(-1))
    local = labels.long() - shard.rank * cols
    held = (local >= 0) & (local < cols)
    picked = torch.gather(lf, -1, local.clamp(0, cols - 1).unsqueeze(-1)
                          ).squeeze(-1)
    picked = reduce_from_model(torch.where(held, picked,
                                           torch.zeros_like(picked)))
    return torch.log(sum_exp) + top.squeeze(-1) - picked


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       vocab: Optional[int] = None) -> torch.Tensor:
    """Mean token-level CE. logits (..., V), labels (...,) int; with
    ``weights`` the weighted sum over max(Σ weights, 1), as in
    ``repro.models.layers.cross_entropy_loss``.  Inside ``model_parallel``
    logits of V/m columns (``vocab`` = V) are this rank's vocabulary
    columns (:func:`lm_logits`) and the loss, the same on every rank,
    comes from :func:`_vocab_parallel_nll`."""
    if vocab is not None and _vocab_split(logits.shape[-1], vocab):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / w.sum().clamp(min=1.0)
