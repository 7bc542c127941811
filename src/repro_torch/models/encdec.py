"""Whisper-style encoder-decoder of the port (``repro.models.encdec``): the
audio family.

The mel-spectrogram and conv frontend are a stub, as in the reference: the
caller supplies frame embeddings (B, T_enc, d_model).  A bidirectional
encoder (sinusoidal positions, no RoPE) feeds a causal decoder whose layers
attend to the encoder output through cross-attention.

Layers are stacked on a leading L axis under ``enc_blocks`` and
``dec_blocks``, as the reference's ``vmap``-ed init leaves them; the
reference's ``lax.scan`` over layers is a Python loop over the stack's
per-layer views.  The cache is written in place and ``position`` is a host
int, as ``LMCache``'s.

Dtypes follow jnp's promotion: f32 frames against bf16 weights run the
encoder in f32 (``layers.matmul`` casts the weight up), so ``encode``'s
output and the cached cross K/V are f32 while the decoder stays in the
model dtype.  The serving loop draws f32 frames, as the reference's does.

Inside ``core.distributed.model_parallel`` (the placed train and serve
steps) the encoder's and decoder's attention, cross-attention and MLPs run
on this rank's ``model`` shards, as the dense decoder's; ``embed`` and
``lm_head`` stay whole when the vocabulary (whisper's 51 866) does not
divide over ``model``.  The placed prefill writes this rank's seq block of
the self K/V (``attention.kv_block``) and its block of the cross K/V rows
(``CacheShard.cross_axes``: whole where the 1 500 rows do not divide), the
cross K/V gathered whole over ``model`` first; the placed decode step runs
``flash_decode`` on both blocks (``attention_decode``,
``attention._cross_decode_placed``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from .attention import (KVCache, attention_decode, attention_forward,
                        check_capacity, cross_attention_forward,
                        init_attention)
from .config import ArchConfig
from ..core.distributed import (all_gather_dim, cache_shard, copy_to_model,
                                model_shard)
from .layers import (dtype_of, embed_init, embed_lookup, lm_logits, matmul,
                     rms_norm, sinusoidal_positions)
from .mlp import init_mlp, mlp_forward
from .transformer import _stacked_layers, layer_views, remat_wrap

Pytree = Any


def _enc_block(cfg: ArchConfig, gen: torch.Generator,
               dtype: torch.dtype) -> Dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    return {"ln1": zeros(), "attn": init_attention(cfg, gen, dtype),
            "ln2": zeros(), "mlp": init_mlp(cfg, gen, dtype)}


def _dec_block(cfg: ArchConfig, gen: torch.Generator,
               dtype: torch.dtype) -> Dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    return {"ln1": zeros(), "attn": init_attention(cfg, gen, dtype),
            "ln_x": zeros(), "cross": init_attention(cfg, gen, dtype),
            "ln2": zeros(), "mlp": init_mlp(cfg, gen, dtype)}


def init_whisper(cfg: ArchConfig, gen: torch.Generator) -> Pytree:
    """Random params on the generator's device, layer by layer; the
    reference's tree (``embed``, ``enc_blocks``, ``enc_norm``,
    ``dec_blocks``, ``final_norm``, ``lm_head``)."""
    dtype = dtype_of(cfg.dtype)
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    embed = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    enc = _stacked_layers(cfg, gen, dtype, (cfg.encoder_layers,), _enc_block)
    dec = _stacked_layers(cfg, gen, dtype, (cfg.num_layers,), _dec_block)
    head = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype).T.contiguous()
    return {"embed": embed, "enc_blocks": enc, "enc_norm": zeros(),
            "dec_blocks": dec, "final_norm": zeros(), "lm_head": head}


def encode(cfg: ArchConfig, params: Pytree, frames: torch.Tensor,
           remat=False) -> torch.Tensor:
    """frames (B, T_enc, d_model), the stub frontend's embeddings → the
    encoder output in frames' dtype (or wider, by promotion)."""
    T = frames.shape[1]
    pos = sinusoidal_positions(T, cfg.d_model, frames.device)
    x = frames + pos.to(frames.dtype)
    positions = torch.arange(T, device=frames.device)

    def body(h, p):
        a = rms_norm(h, p["ln1"], cfg.norm_eps)
        h = h + attention_forward(cfg, p["attn"], a, positions, mode="bidir",
                                  use_rope=False)
        m = rms_norm(h, p["ln2"], cfg.norm_eps)
        return h + mlp_forward(cfg, p["mlp"], m)

    body = remat_wrap(body, remat)
    for p in layer_views(params["enc_blocks"], cfg.encoder_layers):
        x = body(x, p)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(cfg: ArchConfig, p: Dict, enc_out: torch.Tensor):
    """The encoder K/V columns (B, T_enc, ·) of a cross-attention: this
    rank's inside ``model_parallel``."""
    enc_out = copy_to_model(enc_out)
    return matmul(enc_out, p["wk"]), matmul(enc_out, p["wv"])


def _embed_tokens(cfg: ArchConfig, params: Pytree,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus positions 0..S-1, in the embedding's dtype."""
    emb = params["embed"]
    pos = sinusoidal_positions(tokens.shape[1], cfg.d_model, emb.device)
    return embed_lookup(emb, tokens, cfg.vocab_size) + pos.to(emb.dtype)


def _dec_layer(cfg: ArchConfig, p: Dict, h: torch.Tensor,
               positions: torch.Tensor, enc_out: torch.Tensor,
               return_kv: bool = True, capacity=None):
    """One decoder layer over the full sequence: (h, (k, v), (ek, ev)),
    the cross K/V as columns (B, T_enc, ·); (k, v) is None without
    ``return_kv`` (training), this rank's block of a cache of ``capacity``
    rows when placed."""
    a = rms_norm(h, p["ln1"], cfg.norm_eps)
    out = attention_forward(cfg, p["attn"], a, positions, mode="causal",
                            use_rope=False, return_kv=return_kv,
                            capacity=capacity)
    attn, kv = out if return_kv else (out, None)
    h = h + attn
    c = rms_norm(h, p["ln_x"], cfg.norm_eps)
    ek, ev = _cross_kv(cfg, p["cross"], enc_out)
    h = h + cross_attention_forward(cfg, p["cross"], c, ek, ev)
    m = rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + mlp_forward(cfg, p["mlp"], m), kv, (ek, ev)


def _head(cfg: ArchConfig, params: Pytree, x: torch.Tensor) -> torch.Tensor:
    return lm_logits(rms_norm(x, params["final_norm"], cfg.norm_eps),
                     params["lm_head"], cfg.vocab_size)


def whisper_forward_train(cfg: ArchConfig, params: Pytree,
                          frames: torch.Tensor, tokens: torch.Tensor,
                          remat=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits (B, S, V) for tokens (B, S) given frames, and
    a zero aux loss; ``remat`` is the per-layer activation-checkpoint
    policy of the encoder's and the decoder's layers
    (``transformer.remat_wrap``)."""
    enc_out = encode(cfg, params, frames, remat)
    x = _embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    body = remat_wrap(
        lambda h, p: _dec_layer(cfg, p, h, positions, enc_out,
                                return_kv=False)[0], remat)
    for p in layer_views(params["dec_blocks"], cfg.num_layers):
        x = body(x, p)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(cfg, params, x), aux


class WhisperCache(NamedTuple):
    self_kv: KVCache          # (L, B, S_max, KV, hd), the model dtype
    cross_k: torch.Tensor     # (L, B, T_enc, KV, hd), the encoder's dtype
    cross_v: torch.Tensor
    position: int


def whisper_prefill(cfg: ArchConfig, params: Pytree, frames: torch.Tensor,
                    tokens: torch.Tensor, max_seq: int
                    ) -> Tuple[torch.Tensor, WhisperCache]:
    """Encode the audio and run the decoder prompt, building both caches:
    the prompt's self K/V in the first S of ``max_seq`` rows (model dtype),
    every layer's cross K/V (the encoder output's dtype).  Returns the last
    position's logits (B, V)."""
    enc_out = encode(cfg, params, frames)
    B, S = tokens.shape
    x = _embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)
    L, dtype = cfg.num_layers, dtype_of(cfg.dtype)
    placed = model_shard() is not None
    kc = vc = ck = cv = None
    for i, p in enumerate(layer_views(params["dec_blocks"], L)):
        x, (k, v), (ek, ev) = _dec_layer(cfg, p, x, positions, enc_out,
                                         capacity=max_seq)
        if placed:
            ek, ev = (_cross_block(t) for t in (ek, ev))
        ek, ev = (t.unflatten(-1, (cfg.num_kv_heads, -1)) for t in (ek, ev))
        if kc is None:
            rows = k.shape[1] if placed else max_seq
            kc, vc = (torch.zeros((L, B, rows) + tuple(k.shape[2:]),
                                  dtype=dtype, device=k.device)
                      for _ in range(2))
            ck, cv = (torch.empty((L,) + tuple(ek.shape), dtype=ek.dtype,
                                  device=ek.device) for _ in range(2))
        if placed:      # this rank's block of the ring-less cache rows
            kc[i] = k
            vc[i] = v
        else:
            kc[i, :, :S] = k
            vc[i, :, :S] = v
        ck[i] = ek
        cv[i] = ev
    logits = _head(cfg, params, x[:, -1:, :])[:, 0]
    return logits, WhisperCache(KVCache(kc, vc), ck, cv, S)


def _cross_block(t: torch.Tensor) -> torch.Tensor:
    """This rank's columns (B, T_enc, c) of a cross K/V as its block of
    whole-head rows (B, T_enc / ways, m·c) over ``CacheShard.cross_axes``
    (the columns gathered over ``model`` first)."""
    cs = cache_shard()
    whole = all_gather_dim(cs.mesh, t, 2, ("model",))
    ways = cs.ways(cs.cross_axes)
    rows = whole.shape[1] // ways
    return whole.narrow(1, cs.index(cs.cross_axes) * rows, rows)


def whisper_decode_step(cfg: ArchConfig, params: Pytree, token: torch.Tensor,
                        cache: WhisperCache
                        ) -> Tuple[torch.Tensor, WhisperCache]:
    """token (B,) → (logits (B, V), cache), every row at
    ``cache.position``; the self K/V row is written in place.  A position
    at or past the self cache's S_max rows raises before anything is
    written (the reference clamps its position row and K/V write there).
    ``max_target_positions`` is not enforced, as in the reference."""
    S = cache.self_kv.k.shape[2]
    cs = cache_shard()
    if cs is not None:       # placed: S rows of this rank's block
        S *= cs.ways(cs.kv_axes)
    pos = cache.position
    check_capacity(pos, S)
    emb = params["embed"]
    row = sinusoidal_positions(S, cfg.d_model, emb.device)[pos]
    x = embed_lookup(emb, token, cfg.vocab_size)[:, None, :] \
        + row.to(emb.dtype)
    for i, p in enumerate(layer_views(params["dec_blocks"], cfg.num_layers)):
        kv = KVCache(cache.self_kv.k[i], cache.self_kv.v[i])
        a = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + attention_decode(cfg, p["attn"], a, kv, pos,
                                 use_rope=False)[0]
        c = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + cross_attention_forward(cfg, p["cross"], c, cache.cross_k[i],
                                        cache.cross_v[i])
        m = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp_forward(cfg, p["mlp"], m)
    return _head(cfg, params, x)[:, 0], cache._replace(position=pos + 1)
