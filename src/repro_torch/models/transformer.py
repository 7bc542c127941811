"""Decoder-only LM of the port (``repro.models.transformer``): the dense,
MoE, SSM (RWKV6 or Mamba2) and hybrid (Zamba2) families, and the early-
fusion VLM's decoder (``repro_torch.models.vlm`` feeds it fused image and
text embeddings and decodes through ``decode_step``).

Layers are stacked on a leading L axis under ``params["blocks"]``, as the
reference's tree; the reference's ``lax.scan`` over layers is a Python loop
over the stack's per-layer views.  The Zamba2 hybrid stacks its Mamba2
layers on (n_groups, attn_every), the ``num_layers % attn_every`` last ones
on their own axis under ``blocks_rem``, and applies one SHARED attention +
MLP block (``shared_attn``) after every group.  Entry points:

  * ``forward_train`` — full-sequence teacher-forced logits (+ the MoE
    router's aux loss, 0 for the other families)
  * ``prefill``       — full prompt, last-token logits and a cache
  * ``decode_step``   — one token for every row against the cache
  * ``decode_slots``  — one token per slot at per-slot depths (the serving
    engine's step; its attention goes through the ``flash_decode`` kernel;
    KV-cache families only)
  * ``prefill_chunk`` — one chunk of a prompt into one slot of the engine's
    cache (KV-cache families only)

A ``moe`` layer holds ``moe`` (``repro_torch.models.moe``) where a dense
layer holds ``mlp``; an ``ssm`` layer holds ``rwkv``
(``repro_torch.models.rwkv``) or ``mamba`` (``repro_torch.models.ssd``).
The audio family (whisper) is an encoder-decoder and lives in
``repro_torch.models.encdec``; these functions raise for it, naming that
module.  Caches are updated in place and returned (the reference returns new arrays); ``LMCache.position`` is a
host int.  The recurrent states (``LMCache.ssm``) are stacked over
``num_layers`` with the hybrid's remainder layers at the tail, and the
hybrid's ``shared_kv`` over its groups: each application of the one shared
weight set has its own cache.

Inside ``core.distributed.model_parallel(mesh, cache=...)`` (the placed
serve steps of ``launch.steps``) ``prefill`` and ``decode_step`` run on
this rank's weight shards, its rows of the batch and its block of the
cache: each KV leaf's seq block (``CacheShard.kv_axes``; the attention's
``kv_block`` and placed decode), each recurrent state's block of heads
(``CacheShard.state_axes``, converted to and from the heads this rank's
head-parallel layer computes by :func:`_state_at` / :func:`_put_state`);
the conv state and the token shifts are whole over ``model``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core.distributed import (all_gather_dim, cache_shard,
                                model_shard)
from ..core.flatten import tree_leaves, tree_map, tree_unflatten
from ..device import DeviceLike, resolve_device
from .attention import (KVCache, _project_qkv, attention_decode,
                        attention_decode_slots, attention_forward,
                        flash_attention, init_attention, init_kv_cache,
                        naive_attention, ring_place)
from .config import ArchConfig
from .layers import dtype_of, embed_init, embed_lookup, lm_logits, rms_norm
from .mlp import init_mlp, mlp_forward
from .moe import init_moe, moe_forward
from .rwkv import init_rwkv6, init_rwkv_state, rwkv6_decode, rwkv6_forward
from .ssd import init_mamba2, init_ssm_state, mamba2_decode, mamba2_forward

Pytree = Any

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family these decoder-only functions do not run
    (``FAMILIES`` run; audio is ``repro_torch.models.encdec``'s)."""
    if cfg.family == "audio":
        raise NotImplementedError(
            f"model family 'audio' ({cfg.name}) is an encoder-decoder: use "
            "repro_torch.models.encdec (or get_model's bundle)")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"unknown model family {cfg.family!r} ({cfg.name}); the port "
            f"runs {FAMILIES}, audio and logreg")


# the ops whose outputs remat="dots" saves: the 2-D products (every
# projection and MLP matmul), as dots_with_no_batch_dims_saveable saves
# dots without batch dims; batched products (aten.bmm: attention, the MoE
# experts) and everything elementwise are recomputed
DOTS_SAVED_OPS = ("mm", "addmm")


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(
        [getattr(torch.ops.aten, op).default for op in DOTS_SAVED_OPS])


def remat_wrap(body: Callable, remat) -> Callable:
    """Apply the activation-checkpoint policy to a layer body, as
    ``repro.models.transformer.remat_wrap``: ``False``/``None`` → none;
    ``True``/``"full"`` → checkpoint everything (recompute the layer in the
    backward); ``"dots"`` → save the outputs of 2-D products
    (``DOTS_SAVED_OPS``) and recompute the rest.  Any other value raises
    ``ValueError``.  Remat changes memory, never values."""
    if not remat:
        return body
    from torch.utils.checkpoint import checkpoint
    if remat in (True, "full"):
        return lambda *args: checkpoint(body, *args, use_reentrant=False)
    if remat == "dots":
        return lambda *args: checkpoint(body, *args, use_reentrant=False,
                                        context_fn=_dots_context)
    raise ValueError(f"unknown remat policy {remat!r}")


# --------------------------------------------------------------------- init

def _init_block(cfg: ArchConfig, gen: torch.Generator,
                dtype: torch.dtype) -> Dict:
    """One layer's params (``moe`` in place of ``mlp`` for the moe family;
    ``rwkv`` or ``mamba`` alone for the ssm family and the hybrid's Mamba2
    layers)."""
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    if cfg.family == "ssm" and cfg.rwkv:
        return {"ln1": zeros(), "rwkv": init_rwkv6(cfg, gen, dtype)}
    if cfg.family in ("ssm", "hybrid"):
        return {"ln1": zeros(), "mamba": init_mamba2(cfg, gen, dtype)}
    block = {"ln1": zeros(), "ln2": zeros(),
             "attn": init_attention(cfg, gen, dtype)}
    if cfg.family == "moe":
        block["moe"] = init_moe(cfg, gen, dtype)
    else:
        block["mlp"] = init_mlp(cfg, gen, dtype)
    return block


def _stacked_layers(cfg: ArchConfig, gen: torch.Generator,
                    dtype: torch.dtype, lead: Tuple[int, ...],
                    make: Callable = _init_block) -> Pytree:
    """Layers of ``make(cfg, gen, dtype)`` (``_init_block`` by default)
    stacked on the leading dims ``lead``, drawn in row-major order, each
    apart and copied into its slice, so only one layer's f32 draws exist at
    a time."""
    blocks = None
    for i in range(math.prod(lead)):
        layer = make(cfg, gen, dtype)
        if blocks is None:
            blocks = tree_map(lambda a: torch.empty(
                lead + tuple(a.shape), dtype=a.dtype, device=a.device),
                layer)
        at = tuple(divmod(i, lead[1])) if len(lead) == 2 else i
        tree_map(lambda dst, src: dst[at].copy_(src), blocks, layer)
        del layer
    return blocks


def init_lm(cfg: ArchConfig, gen: torch.Generator) -> Pytree:
    """Random params on the generator's device, layer by layer (the full
    qwen3-14b is 29.5 GB in bf16, a deepseek-moe-16b layer's f32 draws
    about 2.3 GB).  The hybrid's tree holds ``blocks`` on (n_groups,
    attn_every), ``blocks_rem`` on the remainder layers when
    ``num_layers % attn_every`` is not 0, and ``shared_attn``."""
    check_family(cfg)
    dtype = dtype_of(cfg.dtype)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype).T.contiguous()
    if cfg.family != "hybrid":
        params["blocks"] = _stacked_layers(cfg, gen, dtype,
                                           (cfg.num_layers,))
        return params
    n_groups, rem = divmod(cfg.num_layers, cfg.attn_every)
    params["blocks"] = _stacked_layers(cfg, gen, dtype,
                                       (n_groups, cfg.attn_every))
    if rem:
        params["blocks_rem"] = _stacked_layers(cfg, gen, dtype, (rem,))
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    params["shared_attn"] = {"ln1": zeros(), "ln2": zeros(),
                             "attn": init_attention(cfg, gen, dtype),
                             "mlp": init_mlp(cfg, gen, dtype)}
    return params


def layer_views(blocks: Pytree, num_layers: int) -> List[Pytree]:
    """Per-layer views of the stacked leaves (no copy).  ``unbind`` makes
    them, so a backward writes each stacked leaf's grad once (one stack),
    not once a layer as a ``select``'s does."""
    cols = [a.unbind(0) for a in tree_leaves(blocks)]
    return [tree_unflatten(blocks, [c[i] for c in cols])
            for i in range(num_layers)]


# ------------------------------------------------------------------ forward

def _ffn(cfg: ArchConfig, p: Dict, h: torch.Tensor):
    """The layer's feed-forward: (out, aux), aux the MoE router's loss
    (None for an MLP layer)."""
    if "moe" in p:
        return moe_forward(cfg, p["moe"], h)
    return mlp_forward(cfg, p["mlp"], h), None


def _block_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                   positions: torch.Tensor, window: Optional[int],
                   state_in=None, return_kv: bool = False,
                   capacity: Optional[int] = None):
    """One layer. Returns (x, aux, extra): extra is the kv (or None) of an
    attention layer (placed: this rank's block of its ring placement into
    ``capacity`` rows), the new state of a recurrent one (``state_in`` its
    initial state, None for zeros)."""
    for name, forward in (("rwkv", rwkv6_forward), ("mamba", mamba2_forward)):
        if name in p:
            out, state = forward(cfg, p[name],
                                 rms_norm(x, p["ln1"], cfg.norm_eps),
                                 state_in)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            return x + out, aux, state
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mode = "window" if window is not None else "causal"
    out = attention_forward(cfg, p["attn"], h, positions, mode=mode,
                            window=window, return_kv=return_kv,
                            capacity=capacity)
    attn, kv = out if return_kv else (out, None)
    x = x + attn
    ff, aux = _ffn(cfg, p, rms_norm(x, p["ln2"], cfg.norm_eps))
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ff, aux, kv


def _logits(cfg: ArchConfig, params: Pytree, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return lm_logits(x, head, cfg.vocab_size)


def forward_train(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
                  window: Optional[int] = None, remat=False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V), aux_loss).  ``remat`` is the
    per-layer activation-checkpoint policy (:func:`remat_wrap`): every
    layer of the stack, or the hybrid's Mamba2 layers alone."""
    check_family(cfg)
    window = window if window is not None else cfg.sliding_window
    x = embed_lookup(params["embed"], tokens, cfg.vocab_size)
    if cfg.family == "hybrid":
        positions = torch.arange(x.shape[1], device=x.device)
        mode = "window" if window is not None else "causal"
        mamba = remat_wrap(
            lambda h, p: _block_forward(cfg, p, h, positions, None)[0], remat)
        x = _hybrid_pass(
            cfg, params, x, lambda h, p, _: mamba(h, p),
            lambda _, a: attention_forward(cfg, params["shared_attn"]["attn"],
                                           a, positions, mode=mode,
                                           window=window))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return _logits(cfg, params, x), aux
    return forward_embedded(cfg, params, x, window, remat)


def forward_embedded(cfg: ArchConfig, params: Pytree, x: torch.Tensor,
                     window: Optional[int], remat=False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stack of ``params["blocks"]`` over embeddings x (B, S, d) at
    positions 0..S-1: (logits (B, S, V), the summed aux loss), each layer
    under the ``remat`` policy."""
    positions = torch.arange(x.shape[1], device=x.device)
    body = remat_wrap(
        lambda h, p: _block_forward(cfg, p, h, positions, window)[:2], remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layer_views(params["blocks"], cfg.num_layers):
        x, a = body(x, p)
        aux = aux + a
    return _logits(cfg, params, x), aux


def _hybrid_pass(cfg: ArchConfig, params: Pytree, x: torch.Tensor,
                 mamba: Callable, attend: Callable) -> torch.Tensor:
    """Zamba2's layer order: each group's Mamba2 layers, then the shared
    attention + MLP block (the same weights every time), then the
    remainder layers.  ``mamba(x, p, layer)`` runs Mamba2 layer ``layer``
    (its index in ``num_layers`` order, as ``LMCache.ssm`` holds its
    state); ``attend(g, a)`` is group ``g``'s attention output for the
    normed input ``a``."""
    shared = params["shared_attn"]
    n_groups, rem = divmod(cfg.num_layers, cfg.attn_every)
    layers = [p for group in layer_views(params["blocks"], n_groups)
              for p in layer_views(group, cfg.attn_every)]
    if rem:
        layers += layer_views(params["blocks_rem"], rem)
    for i, p in enumerate(layers):
        x = mamba(x, p, i)
        if i < n_groups * cfg.attn_every and (i + 1) % cfg.attn_every == 0:
            g = i // cfg.attn_every
            x = x + attend(g, rms_norm(x, shared["ln1"], cfg.norm_eps))
            m = rms_norm(x, shared["ln2"], cfg.norm_eps)
            x = x + mlp_forward(cfg, shared["mlp"], m)
    return x


# ------------------------------------------------------------ prefill/decode

class LMCache(NamedTuple):
    """Per-family cache container (unused fields are None)."""
    kv: Optional[KVCache]            # (L, B, S, KVH, hd) stacked over layers
    ssm: Optional[Any]               # RWKVState / SSMState stacked over L
    shared_kv: Optional[KVCache]     # hybrid: (G, B, S, KVH, hd)
    position: int


def _state_at(stacked, i: int):
    """Layer ``i``'s views of a stacked RWKVState / SSMState; placed, its
    head-split field (``wkv`` / ``ssm``, the second) as the heads this
    rank's head-parallel layer computes (:func:`_state_heads`)."""
    st = type(stacked)(*(f[i] for f in stacked))
    if model_shard() is None:
        return st
    return st._replace(**{st._fields[1]: _state_heads(st[1], True)})


def _put_state(stacked, i: int, new) -> None:
    if model_shard() is not None:
        new = new._replace(**{new._fields[1]: _state_heads(new[1], False)})
    for dst, src in zip(stacked, new):
        dst[i].copy_(src)


def _state_heads(t: torch.Tensor, to_compute: bool) -> torch.Tensor:
    """A recurrent state's (B, H·, ...) head dim between the block this
    rank holds (heads split over ``CacheShard.state_axes``: 'model', or
    ('data', 'model') at batch 1, or whole) and the H/m heads its
    head-parallel layer computes (heads split over 'model').  The same
    split is the identity; another goes through the whole state."""
    cs, shard = cache_shard(), model_shard()
    axes = cs.state_axes
    if axes == ("model",):
        return t
    if to_compute:
        whole = all_gather_dim(cs.mesh, t, 1, axes) if axes else t
        h = whole.shape[1] // shard.size
        return whole.narrow(1, shard.rank * h, h).contiguous()
    whole = all_gather_dim(cs.mesh, t, 1, ("model",))
    if not axes:
        return whole
    h = whole.shape[1] // cs.ways(axes)
    return whole.narrow(1, cs.index(axes) * h, h).contiguous()


def cache_capacity(cfg: ArchConfig, max_seq: int) -> int:
    """KV-cache rows: a ring bounded by the sliding window."""
    if cfg.sliding_window is not None:
        return min(max_seq, cfg.sliding_window)
    return max_seq


def init_lm_cache(cfg: ArchConfig, batch: int, max_seq: int,
                  ring: bool = True, device: DeviceLike = "cuda") -> LMCache:
    """``ring=False`` allocates the full ``max_seq`` rows even for window-
    bounded archs — the serve engine's layout, where per-slot absolute
    positions index rows directly and the window is enforced by the
    ``flash_decode`` mask instead of ring placement."""
    check_family(cfg)
    dev = resolve_device(device)
    cap = cache_capacity(cfg, max_seq) if ring else max_seq
    dtype = dtype_of(cfg.dtype)
    cs = cache_shard()

    def stack(tree, n):
        # placed: a 5-D leaf is this rank's block (a KV leaf's seq dim, a
        # state's head dim: dim 2 of the stack)
        def block(z, kv):
            shape = (n,) + tuple(z.shape)
            if cs is not None and len(shape) == 5:
                ways = cs.ways(cs.kv_axes if kv else cs.state_axes)
                shape = shape[:2] + (shape[2] // ways,) + shape[3:]
            return torch.zeros(shape, dtype=z.dtype, device=dev)
        kv = isinstance(tree, KVCache)
        return type(tree)(*(block(z, kv) for z in tree))
    if cfg.family == "ssm":
        init_state = init_rwkv_state if cfg.rwkv else init_ssm_state
        ssm = stack(init_state(cfg, batch, dtype, "meta"), cfg.num_layers)
        return LMCache(None, ssm, None, 0)
    kv = init_kv_cache(cfg, batch, cap, dtype, "meta")
    if cfg.family == "hybrid":
        ssm = stack(init_ssm_state(cfg, batch, dtype, "meta"),
                    cfg.num_layers)
        shared = stack(kv, cfg.num_layers // cfg.attn_every)
        return LMCache(None, ssm, shared, 0)
    return LMCache(stack(kv, cfg.num_layers), None, None, 0)


def prefill(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
            max_seq: int, window: Optional[int] = None
            ) -> Tuple[torch.Tensor, LMCache]:
    """Run the full prompt, build the cache, return last-position logits."""
    check_family(cfg)
    B, S = tokens.shape
    window = window if window is not None else cfg.sliding_window
    x = embed_lookup(params["embed"], tokens, cfg.vocab_size)
    positions = torch.arange(S, device=tokens.device)
    if cfg.family in ("ssm", "hybrid"):
        cache = init_lm_cache(cfg, B, max_seq, device=tokens.device)
        if cfg.family == "hybrid":
            x = _hybrid_prefill(cfg, params, x, positions, window, cache)
        else:
            for i, p in enumerate(layer_views(params["blocks"],
                                              cfg.num_layers)):
                x, _, st = _block_forward(cfg, p, x, positions, None,
                                          state_in=_state_at(cache.ssm, i))
                _put_state(cache.ssm, i, st)
        logits = _logits(cfg, params, x[:, -1:, :])
        return logits[:, 0], cache._replace(position=S)
    return prefill_embedded(cfg, params, x, max_seq, window)


def prefill_embedded(cfg: ArchConfig, params: Pytree, x: torch.Tensor,
                     max_seq: int, window: Optional[int]
                     ) -> Tuple[torch.Tensor, LMCache]:
    """A KV-cache family's prefill over embeddings x (B, S, d): every
    layer's K/V ring-placed into a cache of ``cache_capacity`` rows, and
    the last position's logits."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    cap = cache_capacity(cfg, max_seq)
    dtype = dtype_of(cfg.dtype)
    if model_shard() is not None:
        # placed: each layer's block of rows straight into the cache block
        cache = init_lm_cache(cfg, x.shape[0], max_seq, device=x.device)
        for i, p in enumerate(layer_views(params["blocks"], cfg.num_layers)):
            x, _, kv = _block_forward(cfg, p, x, positions, window,
                                      return_kv=True, capacity=cap)
            for dst, new in zip(cache.kv, kv):
                dst[i].copy_(new)
        logits = _logits(cfg, params, x[:, -1:, :])
        return logits[:, 0], cache._replace(position=S)
    ks, vs = [], []
    for p in layer_views(params["blocks"], cfg.num_layers):
        x, _, (k, v) = _block_forward(cfg, p, x, positions, window,
                                      return_kv=True)
        ks.append(k)
        vs.append(v)
    kc = ring_place(torch.stack(ks), cap).to(dtype)
    vc = ring_place(torch.stack(vs), cap).to(dtype)
    logits = _logits(cfg, params, x[:, -1:, :])
    return logits[:, 0], LMCache(KVCache(kc, vc), None, None, S)


def _hybrid_prefill(cfg: ArchConfig, params: Pytree, x: torch.Tensor,
                    positions: torch.Tensor, window: Optional[int],
                    cache: LMCache) -> torch.Tensor:
    """The hybrid's prefill into ``cache`` (zero states): every Mamba2
    layer's final state at its layer index, each group's shared-block K/V
    ring-placed into its own ``shared_kv`` slice."""
    mode = "window" if window is not None else "causal"
    cs = cache_shard()
    capacity = cache.shared_kv.k.shape[2] * (
        cs.ways(cs.kv_axes) if cs is not None else 1)
    placed = model_shard() is not None

    def mamba(h, p, i):
        h, _, st = _block_forward(cfg, p, h, positions, None,
                                  state_in=_state_at(cache.ssm, i))
        _put_state(cache.ssm, i, st)
        return h

    def attend(g, a):
        out, kv = attention_forward(cfg, params["shared_attn"]["attn"], a,
                                    positions, mode=mode, window=window,
                                    return_kv=True, capacity=capacity)
        for dst, new in zip(cache.shared_kv, kv):
            dst[g].copy_(new if placed else ring_place(new, capacity))
        return out

    return _hybrid_pass(cfg, params, x, mamba, attend)


def _block_decode(cfg: ArchConfig, p: Dict, h: torch.Tensor, attend
                  ) -> torch.Tensor:
    a = rms_norm(h, p["ln1"], cfg.norm_eps)
    h = h + attend(a)
    m = rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + _ffn(cfg, p, m)[0]


def decode_step(cfg: ArchConfig, params: Pytree, token: torch.Tensor,
                cache: LMCache, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, LMCache]:
    """token (B,) → (logits (B, V), cache), every row at
    ``cache.position``; the cache's rows are written in place."""
    check_family(cfg)
    window = window if window is not None else cfg.sliding_window
    x = embed_lookup(params["embed"], token, cfg.vocab_size)[:, None, :]
    pos = cache.position
    if cfg.family == "hybrid":
        x = _hybrid_decode(cfg, params, x, cache, window)
        return _logits(cfg, params, x)[:, 0], cache._replace(position=pos + 1)
    if cfg.family == "ssm":
        for i, p in enumerate(layer_views(params["blocks"], cfg.num_layers)):
            x = _recurrent_decode(cfg, p, x, cache.ssm, i)
        return _logits(cfg, params, x)[:, 0], cache._replace(position=pos + 1)
    for i, p in enumerate(layer_views(params["blocks"], cfg.num_layers)):
        kv = KVCache(cache.kv.k[i], cache.kv.v[i])
        x = _block_decode(cfg, p, x, lambda a: attention_decode(
            cfg, p["attn"], a, kv, pos, window=window)[0])
    logits = _logits(cfg, params, x)
    return logits[:, 0], cache._replace(position=pos + 1)


def _recurrent_decode(cfg: ArchConfig, p: Dict, h: torch.Tensor, states,
                      i: int) -> torch.Tensor:
    """One RWKV6 or Mamba2 layer's step; its state (layer ``i`` of the
    stacked ``states``) is written in place."""
    step, name = ((rwkv6_decode, "rwkv") if "rwkv" in p
                  else (mamba2_decode, "mamba"))
    out, new = step(cfg, p[name], rms_norm(h, p["ln1"], cfg.norm_eps),
                    _state_at(states, i))
    _put_state(states, i, new)
    return h + out


def _hybrid_decode(cfg: ArchConfig, params: Pytree, x: torch.Tensor,
                   cache: LMCache, window: Optional[int]) -> torch.Tensor:
    """The hybrid's step: the shared block attends against its group's
    ``shared_kv`` slice through the plain ``attention_decode``, as the
    reference's."""
    def attend(g, a):
        kv = KVCache(cache.shared_kv.k[g], cache.shared_kv.v[g])
        return attention_decode(cfg, params["shared_attn"]["attn"], a, kv,
                                cache.position, window=window)[0]
    return _hybrid_pass(
        cfg, params, x,
        lambda h, p, i: _recurrent_decode(cfg, p, h, cache.ssm, i), attend)


def decode_slots(cfg: ArchConfig, params: Pytree, token: torch.Tensor,
                 cache: LMCache, positions: torch.Tensor,
                 window: Optional[int] = None,
                 active: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, LMCache]:
    """Continuous-batching decode step: token (B,), positions (B,) int32 —
    each row an independent request at its own depth (the serve engine's
    per-slot contract).  ``cache.position`` is ignored; ``active`` (B,)
    bool marks the slots holding a live request, and inactive slots write
    nothing.  Every layer's attention is one ``flash_decode`` launch.
    Returns (logits (B, V), cache), the cache written in place."""
    if cache.kv is None:
        raise ValueError("decode_slots needs a KV-cache family, got "
                         f"{cfg.family!r}")
    check_family(cfg)
    window = window if window is not None else cfg.sliding_window
    x = params["embed"][token][:, None, :]     # (B,1,d)
    for i, p in enumerate(layer_views(params["blocks"], cfg.num_layers)):
        kv = KVCache(cache.kv.k[i], cache.kv.v[i])
        x = _block_decode(cfg, p, x, lambda a: attention_decode_slots(
            cfg, p["attn"], a, kv, positions, window=window,
            active=active)[0])
    logits = _logits(cfg, params, x)
    return logits[:, 0], cache


def prefill_chunk(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
                  cache: LMCache, slot: int, start: int,
                  window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, LMCache]:
    """One chunk of an incremental single-request prefill into ``slot``.

    tokens (C,) occupy absolute positions [start, start+C) of the slot's
    rows.  Their K/V rows are written into the engine's cache (allocated
    ``ring=False``), and the chunk's queries attend to the slot's whole row
    space under a causal/window mask: rows past the chunk are unwritten or
    retired-request garbage, but their positions lie above every query's,
    so the mask excludes them.  Returns (logits (C, V), cache).

    Only the rows inside the cache, [start, min(start+C, S)), are written.
    The reference writes the whole chunk with ``dynamic_update_slice``,
    which XLA clamps to start S−C when a zero-padded last chunk overhangs
    the cache, so its rows land shifted over earlier prompt rows; here a
    chunk that overhangs writes its real rows where they belong."""
    if cache.kv is None:
        raise ValueError("prefill_chunk needs a KV-cache family, got "
                         f"{cfg.family!r}")
    check_family(cfg)
    window = window if window is not None else cfg.sliding_window
    slot, start = int(slot), int(start)
    C = tokens.shape[0]
    S = cache.kv.k.shape[2]
    n = max(0, min(C, S - start))
    dev = tokens.device
    positions = start + torch.arange(C, device=dev)
    k_positions = torch.arange(S, device=dev)
    x = params["embed"][tokens][None]          # (1, C, d)
    mode = "window" if window is not None else "causal"
    attend = naive_attention if S <= 1024 else flash_attention
    for i, p in enumerate(layer_views(params["blocks"], cfg.num_layers)):
        ck, cv = cache.kv.k[i], cache.kv.v[i]  # (B, S, KV, hd)
        a = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k_new, v_new = _project_qkv(cfg, p["attn"], a, positions[None])
        ck[slot, start:start + n] = k_new[0, :n].to(ck.dtype)
        cv[slot, start:start + n] = v_new[0, :n].to(cv.dtype)
        o = attend(q, ck[slot:slot + 1], cv[slot:slot + 1],
                   q_positions=positions, k_positions=k_positions, mode=mode,
                   window=window, logit_softcap=cfg.attn_logit_softcap)
        x = x + o.reshape(1, C, -1) @ p["attn"]["wo"]
        m = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, p, m)[0]
    logits = _logits(cfg, params, x)
    return logits[0], cache
