"""Attention of the port (``repro.models.attention``): GQA/MQA with RoPE,
qk-norm, QKV bias, logit softcap, causal / sliding-window / bidirectional
masking, a chunked flash-style path for long rows, whisper's cross-
attention against precomputed encoder K/V, and single-token decode against
a KV cache.  Projections promote mixed dtypes as jnp does
(``layers.matmul``).

Prefill attention (``naive_attention``, and ``flash_attention`` past
``flash_threshold`` rows) is plain torch, as the reference computes it in
jnp outside any Pallas kernel.  The serving engine's decode step
(:func:`attention_decode_slots`) goes through the ``flash_decode`` kernel.

Inside ``core.distributed.model_parallel`` (the placed train step)
:func:`attention_forward` runs on this rank's columns of ``wq`` / ``wk`` /
``wv`` (and ``bq`` / ``bk`` / ``bv``) and rows of ``wo``: on whole local
heads when the heads and KV heads divide over ``model``, else on a block
of whole-head rows (:func:`_attend_row_block`); the output projection's
parts are summed over ``model``.

Caches are updated in place: the reference returns new arrays, the port
writes the new rows into the tensors it was given and returns them, so the
serving engine keeps one (L, B, S, KV, hd) cache and never copies it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core.distributed import (ModelShard, cols_to_rows, copy_to_model,
                                gather_for_rows, model_shard,
                                reduce_from_model, rows_to_cols)
from .config import ArchConfig
from .layers import apply_rope, dense_init, matmul, rms_norm, softcap

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
    q = matmul(x, params["wq"])
    k = matmul(x, params["wk"])
    v = matmul(x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    q, k = _norm_rope(cfg, params, q, k, positions, positions,
                      use_rope and positions is not None, cfg.qk_norm)
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
    attend = naive_attention if S <= flash_threshold else flash_attention
    kwargs = dict(mode=mode, window=window,
                  logit_softcap=cfg.attn_logit_softcap)
    shard = model_shard()
    if shard is not None:
        if return_kv:
            raise NotImplementedError(
                "a K/V cache of a model-parallel attention (the placed "
                "prefill) is not ported; the placed step is the train step")
        return _attention_sharded(cfg, params, x, positions, use_rope,
                                  shard, attend, kwargs)
    q, k, v = _project_qkv(cfg, params, x, positions, use_rope)
    o = attend(q, k, v, q_positions=positions, k_positions=positions,
               **kwargs)
    out = matmul(o.reshape(B, S, -1), params["wo"])
    if return_kv:
        return out, (k, v)
    return out


def _attention_sharded(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                       positions: torch.Tensor, use_rope: bool, shard,
                       attend, kwargs) -> torch.Tensor:
    """:func:`attention_forward` on this rank's shards (``_sharded_heads``);
    ``wo``'s rows of its columns, the parts summed over ``model``.  The
    qk-norm weights, whole on every rank, get their grads summed over
    ``model``."""
    p = dict(params)
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = copy_to_model(p[name])
    x = copy_to_model(x)
    q, k, v = (matmul(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    o = _sharded_heads(cfg, p, q, k, v, positions, positions, use_rope,
                       cfg.qk_norm, shard, attend, kwargs)
    return reduce_from_model(matmul(o, p["wo"]))


def _norm_rope(cfg: ArchConfig, p: Dict, q, k, q_pos, k_pos,
               use_rope: bool, norm: bool):
    """Head-shaped q / k with the qk-norm (``norm``) and RoPE at their
    positions (``use_rope``) applied."""
    if norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, k_pos, cfg.rope_theta)
    return q, k


def _sharded_heads(cfg: ArchConfig, p: Dict, q: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                   k_pos: torch.Tensor, use_rope: bool, norm: bool, shard,
                   attend, kwargs) -> torch.Tensor:
    """Attention of this rank's projection columns — q (B, Sq, ·), k and v
    (B, Sk, ·), biases added — on its H/m heads and KV/m KV heads where
    both divide over ``model`` (head-parallel), else on a block of
    whole-head rows (:func:`_attend_row_block`).  Returns this rank's
    columns of the output (B, Sq, ·)."""
    B, Sq, _ = q.shape
    m, hd = shard.size, cfg.resolved_head_dim
    if cfg.num_heads % m or cfg.num_kv_heads % m:
        return _attend_row_block(cfg, p, q, k, v, q_pos, k_pos, use_rope,
                                 norm, shard, attend, kwargs)
    q = q.reshape(B, Sq, cfg.num_heads // m, hd)
    k, v = (t.reshape(B, t.shape[1], cfg.num_kv_heads // m, hd)
            for t in (k, v))
    q, k = _norm_rope(cfg, p, q, k, q_pos, k_pos, use_rope, norm)
    o = attend(q, k, v, q_positions=q_pos, k_positions=k_pos, **kwargs)
    return o.reshape(B, Sq, -1)


def _attend_row_block(cfg: ArchConfig, p: Dict, q: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                      k_pos: torch.Tensor, use_rope: bool, norm: bool, shard,
                      attend, kwargs) -> torch.Tensor:
    """Attention with heads that do not divide over ``model`` (qwen3's 40
    on 16 ranks): q's column shard of all B·Sq rows becomes every head of
    this rank's block of B·Sq/m rows (an all-to-all), K/V are gathered
    whole, the block's queries attend to their sequences' keys, and the
    output goes back to a column shard of every row.  A block is whole
    sequences or a run of positions of one sequence."""
    B, Sq, _ = q.shape
    Sk = k.shape[1]
    m, r = shard.size, shard.rank
    hd = cfg.resolved_head_dim
    T = B * Sq
    rows = T // m
    if T % m or (rows % Sq and Sq % rows):
        raise NotImplementedError(
            f"a row block of {T}/{m} tokens must be whole sequences of {Sq} "
            "or a run within one")
    q = cols_to_rows(q.reshape(T, -1))
    k, v = (gather_for_rows(t.reshape(B * Sk, -1)) for t in (k, v))
    first = r * rows
    seqs = max(rows // Sq, 1)
    b0 = first // Sq
    q_pos = q_pos if rows >= Sq else q_pos[first % Sq:first % Sq + rows]
    q = q.reshape(seqs, len(q_pos), cfg.num_heads, hd)
    k, v = (t.reshape(B, Sk, cfg.num_kv_heads, hd)[b0:b0 + seqs]
            for t in (k, v))
    q, k = _norm_rope(cfg, p, q, k, q_pos, k_pos, use_rope, norm)
    o = attend(q, k, v, q_positions=q_pos, k_positions=k_pos, **kwargs)
    return rows_to_cols(o.reshape(rows, -1)).reshape(B, Sq, -1)


def cross_attention_forward(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                            enc_k: torch.Tensor, enc_v: torch.Tensor
                            ) -> torch.Tensor:
    """Decoder cross-attention (whisper): queries of x (B, S, d), with the
    optional ``bq`` bias, against precomputed encoder K/V — (B, Se, KV, hd)
    from the cache or this rank's columns (B, Se, ·) (``encdec._cross_kv``)
    — unmasked.  ``naive_attention`` for Se <= 2 048, ``flash_attention``
    above, as the reference.  Inside ``model_parallel`` the queries, K/V
    and ``wo``'s rows are this rank's shards (``_sharded_heads``)."""
    B, S, _ = x.shape
    Se = enc_k.shape[1]
    attend = naive_attention if Se <= 2048 else flash_attention
    shard = model_shard() or ModelShard(None, 1, 0)
    q = matmul(copy_to_model(x), params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"]
    o = _sharded_heads(cfg, params, q, enc_k, enc_v,
                       torch.arange(S, device=x.device),
                       torch.arange(Se, device=x.device), False, False,
                       shard, attend, dict(mode="bidir"))
    return reduce_from_model(matmul(o, params["wo"]))


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_max, KV, hd)
    v: torch.Tensor


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int,
                  dtype: torch.dtype, device=None) -> KVCache:
    hd = cfg.resolved_head_dim
    shape = (batch, max_seq, cfg.num_kv_heads, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def check_capacity(position: int, capacity: int) -> None:
    """Refuse a decode step at a host ``position`` past the cache's rows."""
    if position >= capacity:
        raise ValueError(
            f"decode position {position} is past the KV cache's capacity "
            f"S={capacity} (rows 0..{capacity - 1}); allocate the cache with "
            f"max_seq > {position}")


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
    position RoPE, so the scores equal the dense cache's.

    Outside ring mode a ``position`` at or past the capacity S raises
    before anything is written.  The reference's ``dynamic_update_slice``
    clamps such a write onto row S - 1 and decodes on; the port refuses."""
    B = x.shape[0]
    S = cache.k.shape[1]
    ring = window is not None and S <= window
    if not ring:
        check_capacity(position, S)
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
