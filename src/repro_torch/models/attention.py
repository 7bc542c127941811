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

The placed serve steps (``launch.steps``) run these inside
``model_parallel(mesh, cache=...)`` too: a prefill returns this rank's
seq block of the ring-placed K/V (:func:`kv_block`: its rows sliced from
the K/V the row-block path gathers whole, or, from the head-parallel
path's local heads, an all-to-all over ``model``), and a decode step
(:func:`attention_decode`) gathers q, k and v whole over ``model``, writes
the new row into the block that holds its position, runs ``flash_decode``
on this rank's block with every head (the kernel on the card; the
reference computes the whole cache in plain jnp), merges the blocks'
(o, lse) partials over the cache's seq axes and takes this rank's columns
of o into the row-parallel ``wo``.

Caches are updated in place: the reference returns new arrays, the port
writes the new rows into the tensors it was given and returns them, so the
serving engine keeps one (L, B, S, KV, hd) cache and never copies it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core.distributed import (ModelShard, all_gather_dim,
                                all_to_all_model, cache_shard, cols_to_rows,
                                copy_to_model, gather_for_rows,
                                gather_from_model, merge_decode_partials,
                                model_shard, reduce_from_model, rows_to_cols)
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
                      return_kv: bool = False, flash_threshold: int = 1024,
                      capacity: Optional[int] = None):
    """Full-sequence attention (train / prefill).  Returns out (B,S,d) and
    optionally the (k, v) tensors for KV-cache seeding: (B, S, KV, hd),
    or, inside ``model_parallel``, this rank's block of their ring
    placement into ``capacity`` rows (:func:`kv_block`)."""
    B, S, _ = x.shape
    attend = naive_attention if S <= flash_threshold else flash_attention
    kwargs = dict(mode=mode, window=window,
                  logit_softcap=cfg.attn_logit_softcap)
    shard = model_shard()
    if shard is not None:
        out = _attention_sharded(cfg, params, x, positions, use_rope,
                                 shard, attend, kwargs, return_kv)
        if not return_kv:
            return out
        out, kv = out
        return out, kv_block(cfg, kv, capacity or S)
    q, k, v = _project_qkv(cfg, params, x, positions, use_rope)
    o = attend(q, k, v, q_positions=positions, k_positions=positions,
               **kwargs)
    out = matmul(o.reshape(B, S, -1), params["wo"])
    if return_kv:
        return out, (k, v)
    return out


def _attention_sharded(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                       positions: torch.Tensor, use_rope: bool, shard,
                       attend, kwargs, keep_kv: bool = False):
    """:func:`attention_forward` on this rank's shards (``_sharded_heads``);
    ``wo``'s rows of its columns, the parts summed over ``model``.  The
    qk-norm weights, whole on every rank, get their grads summed over
    ``model``.  ``keep_kv``: also the K/V this rank holds (``_sharded_heads``'
    second result)."""
    p = dict(params)
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = copy_to_model(p[name])
    x = copy_to_model(x)
    q, k, v = (matmul(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    o = _sharded_heads(cfg, p, q, k, v, positions, positions, use_rope,
                       cfg.qk_norm, shard, attend, kwargs, keep_kv)
    if keep_kv:
        o, kv = o
        return reduce_from_model(matmul(o, p["wo"])), kv
    return reduce_from_model(matmul(o, p["wo"]))


def _norm_rope(cfg: ArchConfig, p: Dict, q, k, q_pos, k_pos,
               use_rope: bool, norm: bool):
    """Head-shaped q / k with the qk-norm (``norm``) and RoPE at their
    positions (``use_rope``) applied."""
    return (_norm_rope_one(cfg, p, q, q_pos, use_rope, norm, "q_norm"),
            _norm_rope_one(cfg, p, k, k_pos, use_rope, norm, "k_norm"))


def _norm_rope_one(cfg: ArchConfig, p: Dict, t, pos, use_rope: bool,
                   norm: bool, weight: str):
    """:func:`_norm_rope` of one of q / k (``weight``: its norm's leaf)."""
    if norm:
        t = rms_norm(t, p[weight], cfg.norm_eps)
    if use_rope:
        t = apply_rope(t, pos, cfg.rope_theta)
    return t


def _sharded_heads(cfg: ArchConfig, p: Dict, q: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                   k_pos: torch.Tensor, use_rope: bool, norm: bool, shard,
                   attend, kwargs, keep_kv: bool = False):
    """Attention of this rank's projection columns — q (B, Sq, ·), k and v
    (B, Sk, ·), biases added — on its H/m heads and KV/m KV heads where
    both divide over ``model`` (head-parallel), else on a block of
    whole-head rows (:func:`_attend_row_block`).  Returns this rank's
    columns of the output (B, Sq, ·); ``keep_kv``: and ``(form, k, v)``,
    the normed and roped K/V it holds — ``"heads"``: its KV/m heads of
    every row, ``"whole"``: every head (the row-block path gathers them)."""
    B, Sq, _ = q.shape
    m, hd = shard.size, cfg.resolved_head_dim
    if cfg.num_heads % m or cfg.num_kv_heads % m:
        return _attend_row_block(cfg, p, q, k, v, q_pos, k_pos, use_rope,
                                 norm, shard, attend, kwargs, keep_kv)
    q = q.reshape(B, Sq, cfg.num_heads // m, hd)
    k, v = (t.reshape(B, t.shape[1], cfg.num_kv_heads // m, hd)
            for t in (k, v))
    q, k = _norm_rope(cfg, p, q, k, q_pos, k_pos, use_rope, norm)
    o = attend(q, k, v, q_positions=q_pos, k_positions=k_pos, **kwargs)
    if keep_kv:
        return o.reshape(B, Sq, -1), ("heads", k, v)
    return o.reshape(B, Sq, -1)


def _attend_row_block(cfg: ArchConfig, p: Dict, q: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                      k_pos: torch.Tensor, use_rope: bool, norm: bool, shard,
                      attend, kwargs, keep_kv: bool = False):
    """Attention with heads that do not divide over ``model`` (qwen3's 40
    on 16 ranks): q's column shard of all B·Sq rows becomes every head of
    this rank's block of B·Sq/m rows (an all-to-all), K/V are gathered
    whole, the block's queries attend to their sequences' keys, and the
    output goes back to a column shard of every row.  A block of whole
    sequences or of a run of positions of one sequence attends in one
    call; any other (B·Sq not a multiple of m: the rows padded with zeros
    to one; or a block across a sequence's end) in one call a sequence it
    touches (:func:`_attend_segments`).  ``keep_kv``: every sequence's K is
    normed and roped (the cache's rows), not only the block's, and
    ``("whole", k, v)`` comes back beside the output."""
    B, Sq, _ = q.shape
    Sk = k.shape[1]
    m, r = shard.size, shard.rank
    hd = cfg.resolved_head_dim
    T = B * Sq
    pad = (-T) % m
    rows = (T + pad) // m
    q = q.reshape(T, -1)
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
    q = cols_to_rows(q)
    k, v = (gather_for_rows(t.reshape(B * Sk, -1)) for t in (k, v))
    first = r * rows
    if pad or (rows % Sq and Sq % rows):
        k, v = (t.reshape(B, Sk, cfg.num_kv_heads, hd) for t in (k, v))
        k = _norm_rope_one(cfg, p, k, k_pos, use_rope, norm, "k_norm")
        o = _attend_segments(cfg, p, q, k, v, q_pos, k_pos, first, T,
                             use_rope, norm, attend, kwargs)
        out = rows_to_cols(o)[:T].reshape(B, Sq, -1)
        return (out, ("whole", k, v)) if keep_kv else out
    seqs = max(rows // Sq, 1)
    b0 = first // Sq
    q_pos = q_pos if rows >= Sq else q_pos[first % Sq:first % Sq + rows]
    q = q.reshape(seqs, len(q_pos), cfg.num_heads, hd)
    k, v = (t.reshape(B, Sk, cfg.num_kv_heads, hd) for t in (k, v))
    if not keep_kv:
        k, v = k[b0:b0 + seqs], v[b0:b0 + seqs]
    q, k = _norm_rope(cfg, p, q, k, q_pos, k_pos, use_rope, norm)
    kb, vb = (k[b0:b0 + seqs], v[b0:b0 + seqs]) if keep_kv else (k, v)
    o = attend(q, kb, vb, q_positions=q_pos, k_positions=k_pos, **kwargs)
    out = rows_to_cols(o.reshape(rows, -1)).reshape(B, Sq, -1)
    return (out, ("whole", k, v)) if keep_kv else out


def _attend_segments(cfg: ArchConfig, p: Dict, q: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                     k_pos: torch.Tensor, first: int, T: int, use_rope: bool,
                     norm: bool, attend, kwargs) -> torch.Tensor:
    """Every head of the query rows [first, first + len(q)) of the B·Sq
    flattened rows (q (rows, H·hd); k, v (B, Sk, KV, hd) normed and roped)
    attending to their own sequences' keys, one call a sequence the block
    touches; rows at or past T (padding) give zeros.  (rows, H·hd)."""
    Sq = len(q_pos)
    hd = cfg.resolved_head_dim
    rows = q.shape[0]
    outs = []
    at, end = first, min(first + rows, T)
    while at < end:
        b, s0 = divmod(at, Sq)
        n = min(Sq - s0, end - at)
        qs = q[at - first:at - first + n].reshape(1, n, cfg.num_heads, hd)
        qp = q_pos[s0:s0 + n]
        qs = _norm_rope_one(cfg, p, qs, qp, use_rope, norm, "q_norm")
        o = attend(qs, k[b:b + 1], v[b:b + 1], q_positions=qp,
                   k_positions=k_pos, **kwargs)
        outs.append(o.reshape(n, -1))
        at += n
    if end - first < rows:
        outs.append(q.new_zeros((rows - max(end - first, 0),
                                 cfg.num_heads * hd)))
    return torch.cat(outs)


def ring_rows(k: torch.Tensor, capacity: int, start: int,
              rows: int) -> torch.Tensor:
    """Rows [start, start + rows) of :func:`ring_place` of k (…, S, KV,
    hd) into ``capacity`` rows, built alone: a prompt of S ≤ capacity rows
    fills rows 0..S-1 (zeros past it), a longer one puts position p at row
    p mod capacity for its last ``capacity`` positions.  At most two
    slices; no index tensor."""
    S = k.shape[-3]
    out = k.new_zeros(k.shape[:-3] + (rows,) + k.shape[-2:])
    if S <= capacity:
        n = max(0, min(rows, S - start))
        if n:
            out[..., :n, :, :] = k[..., start:start + n, :, :]
        return out
    base = S - capacity           # row j holds p = base + (j - base) mod cap
    first = base + (start - base) % capacity
    n = min(rows, S - first)
    out[..., :n, :, :] = k[..., first:first + n, :, :]
    if n < rows:
        out[..., n:, :, :] = k[..., base:base + rows - n, :, :]
    return out


def kv_block(cfg: ArchConfig, kv, capacity: int):
    """This rank's seq block of the ring-placed K/V of a placed prefill
    (``capacity`` rows split over the ``CacheShard``'s ``kv_axes``), from
    ``_sharded_heads``' ``(form, k, v)``: ``"whole"`` K/V are sliced;
    ``"heads"`` (this rank's KV/m heads of every row) go through an
    all-to-all over ``model`` — the rank sends each peer of its ``model``
    group that peer's rows of its heads — or, with the seq dim whole on
    every rank, an all-gather of the heads.  Returns (k, v) blocks
    (B, rows, KV, hd)."""
    form, k, v = kv
    cs = cache_shard()
    axes = cs.kv_axes
    ways = cs.ways(axes)
    if capacity % ways:
        raise ValueError(f"a cache of {capacity} rows does not split over "
                         f"{axes}")
    rows = capacity // ways
    if form == "whole":
        start = cs.kv_start(rows)
        return tuple(ring_rows(t, capacity, start, rows) for t in (k, v))
    if not axes:
        return tuple(ring_rows(all_gather_dim(cs.mesh, t, 2, ("model",)),
                               capacity, 0, rows) for t in (k, v))
    if axes[-1] != "model":
        raise ValueError(f"the cache's seq axes {axes} must end with 'model'")
    m = cs.mesh.shape["model"]
    outer = cs.index(axes[:-1]) * m
    out = []
    for t in (k, v):
        sent = torch.stack([ring_rows(t, capacity, (outer + j) * rows, rows)
                            for j in range(m)])     # (m, B, rows, KV/m, hd)
        got = all_to_all_model(sent)                # block j: rank j's heads
        B, _, h, hd = got.shape[1:]
        out.append(got.permute(1, 2, 0, 3, 4).reshape(B, rows, m * h, hd))
    return tuple(out)


def cross_attention_forward(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                            enc_k: torch.Tensor, enc_v: torch.Tensor
                            ) -> torch.Tensor:
    """Decoder cross-attention (whisper): queries of x (B, S, d), with the
    optional ``bq`` bias, against precomputed encoder K/V — (B, Se, KV, hd)
    from the cache or this rank's columns (B, Se, ·) (``encdec._cross_kv``)
    — unmasked.  ``naive_attention`` for Se <= 2 048, ``flash_attention``
    above, as the reference.  Inside ``model_parallel`` the queries, K/V
    and ``wo``'s rows are this rank's shards (``_sharded_heads``); cached
    K/V there (4-D: a placed decode step's block) go through
    :func:`_cross_decode_placed`."""
    B, S, _ = x.shape
    Se = enc_k.shape[1]
    attend = naive_attention if Se <= 2048 else flash_attention
    if model_shard() is not None and enc_k.dim() == 4:
        return _cross_decode_placed(cfg, params, x, enc_k, enc_v,
                                    model_shard())
    shard = model_shard() or ModelShard(None, 1, 0)
    q = matmul(copy_to_model(x), params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"]
    o = _sharded_heads(cfg, params, q, enc_k, enc_v,
                       torch.arange(S, device=x.device),
                       torch.arange(Se, device=x.device), False, False,
                       shard, attend, dict(mode="bidir"))
    return reduce_from_model(matmul(o, params["wo"]))


def _cross_decode_placed(cfg: ArchConfig, params: Dict, x: torch.Tensor,
                         enc_k: torch.Tensor, enc_v: torch.Tensor, shard
                         ) -> torch.Tensor:
    """A placed decode step's cross-attention (x (B, 1, d)) against this
    rank's block of the cached cross K/V (B, Se_block, KV, hd), every row
    live: q gathered whole over ``model``, ``flash_decode`` on the block
    with every head, the blocks' partials merged over
    ``CacheShard.cross_axes``, this rank's columns of o into its rows of
    ``wo``, summed over ``model``."""
    from ..kernels import ops as kops    # deferred: models import light
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"a placed cross-attention against the cache takes "
                         f"one query a row, not {S}")
    hd = cfg.resolved_head_dim
    cs = cache_shard()
    q = matmul(x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"]
    q = gather_from_model(q).reshape(B, 1, cfg.num_heads, hd)
    lengths = torch.full((B,), enc_k.shape[1], dtype=torch.int32,
                         device=x.device)
    o, lse = kops.flash_decode(_grouped(cfg, q).contiguous(), enc_k, enc_v,
                               lengths)
    o, _ = merge_decode_partials(cs.mesh, o, lse, cs.cross_axes)
    cols = cfg.num_heads * hd // shard.size
    o = o.reshape(B, 1, cfg.num_heads * hd)[..., shard.rank * cols:
                                             (shard.rank + 1) * cols]
    return reduce_from_model(matmul(o.to(q.dtype), params["wo"]))


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
    clamps such a write onto row S - 1 and decodes on; the port refuses.

    Inside ``model_parallel`` the cache is this rank's seq block
    (:func:`_attention_decode_placed`)."""
    shard = model_shard()
    if shard is not None:
        return _attention_decode_placed(cfg, params, x, cache, position,
                                        window, use_rope, shard)
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


def _attention_decode_placed(cfg: ArchConfig, params: Dict,
                             x: torch.Tensor, cache: KVCache, position: int,
                             window: Optional[int], use_rope: bool, shard
                             ) -> Tuple[torch.Tensor, KVCache]:
    """:func:`attention_decode` with this rank's weight shards and seq
    block of the cache (rows [start, start + S) of the whole cache's
    S·ways, ``CacheShard.kv_axes``): q, k and v gathered whole over
    ``model`` (one all-gather), the new row written by the block that holds it, then
    ``flash_decode`` on the block with local lengths ``position + 1 -
    start`` (ring mode: ``min(position + 1, capacity) - start`` and no
    window), the blocks' partials merged over the seq axes, and this
    rank's columns of o through its rows of ``wo``, summed over
    ``model``."""
    from ..kernels import ops as kops    # deferred: models import light
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    cs = cache_shard()
    S = cache.k.shape[1]
    cap = S * cs.ways(cs.kv_axes)
    start = cs.kv_start(S)
    ring = window is not None and cap <= window
    if not ring:
        check_capacity(position, cap)
    q, k, v = (matmul(x, params[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    # one gather of the three column shards: (B, 1, m, qc + kc + vc)
    widths = [t.shape[-1] for t in (q, k, v)]
    qkv = gather_from_model(torch.cat([q, k, v], dim=-1))
    q, k, v = (t.reshape(B, 1, -1) for t in qkv.unflatten(
        -1, (shard.size, sum(widths))).split(widths, dim=-1))
    q = q.reshape(B, 1, cfg.num_heads, hd)
    k, v = (t.reshape(B, 1, cfg.num_kv_heads, hd) for t in (k, v))
    pos_arr = torch.full((B, 1), position, dtype=torch.int32,
                         device=x.device)
    q, k = _norm_rope(cfg, params, q, k, pos_arr, pos_arr, use_rope,
                      cfg.qk_norm)
    at = (position % cap if ring else position) - start
    if 0 <= at < S:
        cache.k[:, at] = k[:, 0].to(cache.k.dtype)
        cache.v[:, at] = v[:, 0].to(cache.v.dtype)
    length = (min(position + 1, cap) if ring else position + 1) - start
    lengths = torch.full((B,), length, dtype=torch.int32, device=x.device)
    o, lse = kops.flash_decode(_grouped(cfg, q).contiguous(), cache.k,
                               cache.v, lengths,
                               window=None if ring else window,
                               softcap=cfg.attn_logit_softcap)
    o, _ = merge_decode_partials(cs.mesh, o, lse, cs.kv_axes)
    cols = cfg.num_heads * hd // shard.size
    o = o.reshape(B, 1, cfg.num_heads * hd)[..., shard.rank * cols:
                                             (shard.rank + 1) * cols]
    out = reduce_from_model(o.to(x.dtype) @ params["wo"])
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
    return ring_rows(k_stack, capacity, 0, capacity)
