"""Attention of the port (``repro.models.attention``): GQA/MQA with RoPE,
qk-norm, QKV bias, logit softcap, causal / sliding-window / bidirectional
masking, a chunked flash-style path for long rows, and single-token decode
against a KV cache.

Prefill attention (``naive_attention``, and ``flash_attention`` past
``flash_threshold`` rows) is plain torch, as the reference computes it in
jnp outside any Pallas kernel.  The serving engine's decode step
(:func:`attention_decode_slots`) goes through the ``flash_decode`` kernel.

Caches are updated in place: the reference returns new arrays, the port
writes the new rows into the tensors it was given and returns them, so the
serving engine keeps one (L, B, S, KV, hd) cache and never copies it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .config import ArchConfig
from .layers import apply_rope, dense_init, rms_norm, softcap

NEG_INF = -1e30


def init_attention(cfg: ArchConfig, gen: torch.Generator,
                   dtype: torch.dtype) -> Dict:
    hd = cfg.resolved_head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.num_heads * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dtype,
                              device=dev)
        p["bv"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dtype,
                              device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                 positions: Optional[torch.Tensor], use_rope: bool = True):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,KV,hd) with rope/qk-norm applied."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if use_rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, mode: str,
               window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) additive f32 bias: 0 where attendable, NEG_INF elsewhere.
    Padded KV slots carry the sentinel position 2^30 and padded queries −1;
    both stay masked in every mode (bidir included)."""
    valid_k = (k_pos >= 0) & (k_pos < 2 ** 29)
    zero = torch.zeros((), dtype=torch.float32, device=k_pos.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=k_pos.device)
    if mode == "bidir":
        ok = valid_k[None, :].expand(q_pos.shape[0], -1)
        return torch.where(ok, zero, neg)
    diff = q_pos[:, None] - k_pos[None, :]
    ok = (diff >= 0) & valid_k[None, :]
    if mode == "window" and window is not None:
        ok = ok & (diff < window)
    return torch.where(ok, zero, neg)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, k_positions: torch.Tensor,
                    mode: str = "causal", window: Optional[int] = None,
                    logit_softcap: Optional[float] = None,
                    block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """Grouped-query attention in (block_q × block_k) blocks with an online
    softmax over the KV blocks, so the scores never exist whole — plain
    torch, as ``repro.models.attention.flash_attention`` in jnp.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); H = KV · G.
    Returns (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    pad_q = (-Sq) % block_q
    pad_k = (-Sk) % block_k
    dev = q.device
    qpos = torch.cat([q_positions.to(torch.int64),
                      torch.full((pad_q,), -1, dtype=torch.int64, device=dev)])
    kpos = torch.cat([k_positions.to(torch.int64),
                      torch.full((pad_k,), 2 ** 30, dtype=torch.int64,
                                 device=dev)])
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (Sq + pad_q) // block_q, (Sk + pad_k) // block_k
    # (nq, B, KV, G, bq, hd) and (nk, B, KV, bk, hd)
    qb = qp.reshape(B, nq, block_q, KV, G, hd).permute(1, 0, 3, 4, 2, 5)
    kb = kp.reshape(B, nk, block_k, KV, hd).permute(1, 0, 3, 2, 4)
    vb = vp.reshape(B, nk, block_k, KV, hd).permute(1, 0, 3, 2, 4)
    outs = []
    for i in range(nq):
        qi = qb[i].float() * scale
        qpos_i = qpos[i * block_q:(i + 1) * block_q]
        m = torch.full((B, KV, G, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, block_q), dtype=torch.float32, device=dev)
        o = torch.zeros((B, KV, G, block_q, hd), dtype=torch.float32,
                        device=dev)
        for j in range(nk):
            s = torch.einsum("bkgqd,bksd->bkgqs", qi, kb[j].float())
            s = softcap(s, logit_softcap)
            s = s + _mask_bias(qpos_i, kpos[j * block_k:(j + 1) * block_k],
                               mode, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum("bkgqs,bksd->bkgqd", p,
                                                   vb[j].float())
            m = m_new
        outs.append(o / l.clamp(min=1e-30)[..., None])
    ob = torch.stack(outs)                       # (nq, B, KV, G, bq, hd)
    out = ob.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq + pad_q, H, hd)
    return out[:, :Sq].to(q.dtype)


def naive_attention(q, k, v, *, q_positions, k_positions, mode="causal",
                    window=None, logit_softcap=None) -> torch.Tensor:
    """The O(S²) path: all scores at once."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float() * hd ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = softcap(s, logit_softcap)
    s = s + _mask_bias(q_positions, k_positions, mode, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def attention_forward(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                      positions: torch.Tensor, *, mode: str = "causal",
                      window: Optional[int] = None, use_rope: bool = True,
                      return_kv: bool = False, flash_threshold: int = 1024):
    """Full-sequence attention (train / prefill).  Returns out (B,S,d) and
    optionally the (k, v) tensors for KV-cache seeding."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, params, x, positions, use_rope)
    kwargs = dict(q_positions=positions, k_positions=positions, mode=mode,
                  window=window, logit_softcap=cfg.attn_logit_softcap)
    if S <= flash_threshold:
        o = naive_attention(q, k, v, **kwargs)
    else:
        o = flash_attention(q, k, v, **kwargs)
    out = o.reshape(B, S, -1) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_max, KV, hd)
    v: torch.Tensor


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int,
                  dtype: torch.dtype, device=None) -> KVCache:
    hd = cfg.resolved_head_dim
    shape = (batch, max_seq, cfg.num_kv_heads, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _grouped(cfg: ArchConfig, q: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, hd) → (B, KV, G, hd): head h = kv · G + g."""
    B = q.shape[0]
    hd = cfg.resolved_head_dim
    return q.reshape(B, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                     hd)


def attention_decode(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                     cache: KVCache, position: int, *,
                     window: Optional[int] = None, use_rope: bool = True
                     ) -> Tuple[torch.Tensor, KVCache]:
    """Single-token decode, all rows at one host-known ``position``.
    x: (B, 1, d).  The new K/V row is written into ``cache`` in place and
    attention runs over the whole cache under a position mask (window-
    limited when set), in plain torch, as the reference.

    RING MODE: when the cache capacity is ≤ the sliding window, the new row
    lands at ``position % S`` and every resident row is inside the window by
    construction (row j holds the one p ≡ j (mod S) with p ≤ position), so
    a step reads O(S) rows, not O(max_seq).  Keys keep their absolute-
    position RoPE, so the scores equal the dense cache's."""
    B = x.shape[0]
    S = cache.k.shape[1]
    ring = window is not None and S <= window
    pos_arr = torch.full((B, 1), position, dtype=torch.int32,
                         device=x.device)
    q, k_new, v_new = _project_qkv(cfg, params, x,
                                   pos_arr if use_rope else None, use_rope)
    write_at = (position % S) if ring else position
    cache.k[:, write_at] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, write_at] = v_new[:, 0].to(cache.v.dtype)

    hd = cfg.resolved_head_dim
    qg = _grouped(cfg, q).float() * hd ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache.k.float())
    s = softcap(s, cfg.attn_logit_softcap)
    kpos = torch.arange(S, device=x.device)
    if ring:
        ok = (kpos <= position) | (position >= S)   # all slots once full
    else:
        ok = kpos <= position
        if window is not None:
            ok = ok & (kpos > position - window)
    s = torch.where(ok[None, None, None, :], s,
                    torch.full((), NEG_INF, device=x.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, cache.v.float())
    out = o.reshape(B, 1, cfg.num_heads * hd).to(x.dtype) @ params["wo"]
    return out, cache


def attention_decode_slots(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                           cache: KVCache, positions: torch.Tensor, *,
                           window: Optional[int] = None,
                           use_rope: bool = True,
                           active: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, KVCache]:
    """Continuous-batching decode: one token per slot at per-slot positions.

    x: (B, 1, d); positions: (B,) int32 device tensor, each slot's current
    index (its row count so far); active: (B,) bool, the slots holding a
    live decoding request.  The new K/V row of each slot is scattered into
    ``cache`` in place, and the contraction runs through the ``flash_decode``
    op, whose per-row ``lengths`` mask is the per-slot contract (window
    included; the serve cache is full ``max_seq``, no ring).

    Rows at index ≥ a slot's length may hold garbage of retired requests or
    padded prefill; they are never attended and are overwritten before they
    become visible.  Inactive slots write nothing: their positions may be
    stale, and a write there could clobber rows another request is being
    chunk-prefilled into.  The reference drops those writes with an
    out-of-bounds index; here every slot writes at its clamped position,
    an inactive slot the row's own old value, so there is no out-of-bounds
    index (an error on the CPU, a device assert on the card) and no host
    sync."""
    from ..kernels import ops as kops    # deferred: models import light
    B = x.shape[0]
    pos_arr = positions[:, None]                       # (B, 1) for RoPE
    q, k_new, v_new = _project_qkv(cfg, params, x,
                                   pos_arr if use_rope else None, use_rope)
    S = cache.k.shape[1]
    b_idx = torch.arange(B, device=x.device)
    at = positions.to(torch.int64).clamp(0, S - 1)
    writes = positions < S                 # the reference drops the rest too
    if active is not None:
        writes = writes & active
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        row = torch.where(writes[:, None, None], new[:, 0].to(buf.dtype),
                          buf[b_idx, at])
        buf[b_idx, at] = row

    hd = cfg.resolved_head_dim
    o, _ = kops.flash_decode(_grouped(cfg, q), cache.k, cache.v,
                             (positions + 1).to(torch.int32), window=window,
                             softcap=cfg.attn_logit_softcap)
    out = o.reshape(B, 1, cfg.num_heads * hd).to(x.dtype) @ params["wo"]
    return out, cache


def ring_place(k_stack: torch.Tensor, capacity: int) -> torch.Tensor:
    """Place prompt K/V rows (…, S, KV, hd) into a ring cache of
    ``capacity`` rows: the last ``capacity`` rows land at their
    position-mod-capacity rows."""
    S = k_stack.shape[-3]
    if S <= capacity:
        pad = [0, 0, 0, 0, 0, capacity - S]
        return torch.nn.functional.pad(k_stack, pad)
    rows = k_stack[..., S - capacity:, :, :]
    slots = torch.arange(S - capacity, S, device=k_stack.device) % capacity
    out = torch.zeros(k_stack.shape[:-3] + (capacity,) + k_stack.shape[-2:],
                      dtype=k_stack.dtype, device=k_stack.device)
    out[..., slots, :, :] = rows
    return out
