"""Plain PyTorch versions of the ported kernels (``repro.kernels.ref``).

They are what a CPU tensor runs, what the CPU tests hold against the JAX
reference, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card.  Accumulation is f32 and output dtypes follow the reference.  On the
card ``gram_ref`` goes through ``torch.matmul``: keep
``torch.backends.cuda.matmul.allow_tf32`` False when comparing (TF32 keeps
about three decimal digits).

The sign-sketch versions rebuild the implicit ±1 matrix of
``repro.kernels.rng_sketch`` from the same murmur3 hash.  torch has no full
uint32 arithmetic, so the hash runs on int64 tensors that hold uint32
values: every multiply is split into two 16-bit halves so no product
overflows, and masked back to 32 bits, which gives exactly the wrapping
uint32 product.  They work through the columns in chunks of ``block_n``, so
the m×n matrix never exists at once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def gram_ref(updates: torch.Tensor, grad: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G = U Uᵀ, c = U g) in f32 — plain version of kernels.gram."""
    u = updates.float()
    g = grad.float()
    return u @ u.T, u @ g


def gram_block_ref(ua: torch.Tensor, ub: torch.Tensor, grad: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G_ab = U_a U_bᵀ, c_a = U_a g) in f32 — plain version of
    kernels.gram's ``gram_block``."""
    a = ua.float()
    return a @ ub.float().T, a @ grad.float()


def stream_stats_ref(deltas: torch.Tensor, grads: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G = D Dᵀ, C = D GMᵀ) in f32 — plain version of kernels.stream.  It
    upcasts both inputs whole: the f32 copies the kernel exists to avoid."""
    d = deltas.float()
    return d @ d.T, d @ grads.float().T


def sketch_ref(updates: torch.Tensor, sketch: torch.Tensor) -> torch.Tensor:
    """U Rᵀ in f32 — plain version of kernels.sketch."""
    return updates.float() @ sketch.float().T


def combine_ref(params_vec: torch.Tensor, updates: torch.Tensor,
                alpha: torch.Tensor) -> torch.Tensor:
    """w + Σ_k α_k U_k with f32 accumulation, in w's dtype — plain version
    of kernels.combine."""
    comb = torch.einsum("k,kn->n", alpha.float(), updates.float())
    return (params_vec.float() + comb).to(params_vec.dtype)


def topk_ref(vec: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values f32, indices int32) of the k largest-|v| entries (all n when
    k > n), ordered by |v| descending with the lower index first among ties
    (``lax.top_k``'s order) — plain version of kernels.topk."""
    v = vec.float()
    order = torch.sort(v.abs(), descending=True, stable=True).indices[:k]
    return v[order], order.to(torch.int32)


_M32 = 0xFFFFFFFF
MIX1, MIX2 = 0x85EBCA6B, 0xC2B2AE35


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2³²`` for int64 ``x`` in [0, 2³²): two 16-bit halves of
    ``c`` keep every product below 2⁴⁹."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in an int64 tensor."""
    x = x ^ (x >> 16)
    x = _mul32(x, MIX1)
    x = x ^ (x >> 13)
    x = _mul32(x, MIX2)
    return x ^ (x >> 16)


def rng_sign_matrix(seed: int, m: int, n: int, *, col0: int = 0,
                    device=None) -> torch.Tensor:
    """``R[:, col0:col0+n]`` (m, n) f32 of the implicit ±1 matrix:
    ``R[i, j] = 1 − 2·msb(mix32(j ⊕ mix32(i ⊕ seed)))``."""
    rows = torch.arange(m, dtype=torch.int64, device=device)
    cols = torch.arange(col0, col0 + n, dtype=torch.int64, device=device)
    row_h = mix32(rows ^ (int(seed) & _M32))
    h = mix32(cols[None, :] ^ row_h[:, None])
    return 1.0 - 2.0 * (h >> 31).to(torch.float32)


def _sqrt_m(m: int, device) -> torch.Tensor:
    """√m rounded once to f32, as ``jnp.sqrt(jnp.float32(m))``."""
    return torch.sqrt(torch.tensor(float(m), dtype=torch.float32,
                                   device=device))


def rng_sketch_ref(updates: torch.Tensor, seed: int, m: int,
                   block_n: int = 4096) -> torch.Tensor:
    """``U Rᵀ/√m`` (K, m) f32 — plain version of kernels.rng_sketch."""
    u = updates.float()
    K, n = u.shape
    acc = torch.zeros((K, m), dtype=torch.float32, device=u.device)
    for c0 in range(0, n, block_n):
        c1 = min(n, c0 + block_n)
        R = rng_sign_matrix(seed, m, c1 - c0, col0=c0, device=u.device)
        acc = acc + u[:, c0:c1] @ R.T
    return acc / _sqrt_m(m, u.device)


def rng_sketch_adjoint_ref(coords: torch.Tensor, seed: int, n: int,
                           block_n: int = 4096) -> torch.Tensor:
    """``Rᵀ s/√m`` (n,) f32 — plain version of the decode-side adjoint."""
    s = coords.float()
    m = s.shape[0]
    parts = [s @ rng_sign_matrix(seed, m, min(n, c0 + block_n) - c0,
                                 col0=c0, device=s.device)
             for c0 in range(0, n, block_n)]
    return torch.cat(parts) / _sqrt_m(m, s.device)


NEG_INF = -1e30


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, window: Optional[int] = None,
                     softcap: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (B, KV, G, hd) f32, lse (B, KV, G, 1) f32) — plain version of
    kernels.decode_attn.  q (B, KV, G, hd); k, v (B, S, KV, hd); lengths
    (B,) = position + 1.  ``softcap`` applies the tanh logit cap before
    masking; keys at ``kpos >= length`` are masked, and with ``window``
    those at ``kpos <= length - 1 - window`` too.  It reads every row of
    the cache, live or not."""
    S, hd = k.shape[1], k.shape[3]
    q32 = q.float() * hd ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", q32, k.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(S, device=k.device)[None, None, None, :]
    length = lengths.to(torch.int64)[:, None, None, None]
    ok = kpos < length
    if window is not None:
        ok = ok & (kpos > length - 1 - window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p / l.clamp(min=1e-30), v.float())
    lse = m + torch.log(l.clamp(min=1e-30))
    return o, lse


def lse_merge_ref(o_parts: torch.Tensor, lse_parts: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard flash-decode partials: o_parts (P, B, KV, G, hd),
    lse_parts (P, B, KV, G, 1) → (o, lse)."""
    m = lse_parts.amax(dim=0, keepdim=True)
    w = torch.exp(lse_parts - m)                       # (P, …, 1)
    denom = w.sum(dim=0)
    o = (o_parts * w).sum(dim=0) / denom.clamp(min=1e-30)
    lse = m[0] + torch.log(denom.clamp(min=1e-30))
    return o, lse
