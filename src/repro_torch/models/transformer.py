"""Decoder-only LM of the port (``repro.models.transformer``), dense family.

Layers are stacked on a leading L axis under ``params["blocks"]``, as the
reference's tree; the reference's ``lax.scan`` over layers is a Python loop
over the stack's per-layer views.  Entry points:

  * ``forward_train`` — full-sequence teacher-forced logits (+ aux loss 0)
  * ``prefill``       — full prompt, last-token logits and a cache
  * ``decode_step``   — one token for every row against the cache
  * ``decode_slots``  — one token per slot at per-slot depths (the serving
    engine's step; its attention goes through the ``flash_decode`` kernel)
  * ``prefill_chunk`` — one chunk of a prompt into one slot of the engine's
    cache

The moe, ssm and hybrid families raise ``NotImplementedError`` naming the
reference module that holds them.  Caches are updated in place and
returned (the reference returns new arrays); ``LMCache.position`` is a host
int.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core.flatten import tree_map
from ..device import DeviceLike, resolve_device
from .attention import (KVCache, _project_qkv, attention_decode,
                        attention_decode_slots, attention_forward,
                        flash_attention, init_attention,
                        naive_attention, ring_place)
from .config import ArchConfig
from .layers import dtype_of, embed_init, rms_norm
from .mlp import init_mlp, mlp_forward

Pytree = Any

_NOT_PORTED = {
    "moe": "reference: repro.models.moe; ROADMAP queue 1",
    "ssm": "reference: repro.models.rwkv, repro.models.ssd; ROADMAP queue 1",
    "hybrid": "reference: repro.models.ssd (the shared-attention hybrid); "
              "ROADMAP queue 1",
    "vlm": "reference: repro.models.vlm; ROADMAP queue 1",
    "audio": "reference: repro.models.encdec; ROADMAP queue 1",
}


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family the port does not run yet (only ``dense`` runs)."""
    if cfg.family != "dense":
        item = _NOT_PORTED.get(cfg.family, "ROADMAP queue 1")
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{item}")


# --------------------------------------------------------------------- init

def _init_block(cfg: ArchConfig, gen: torch.Generator,
                dtype: torch.dtype) -> Dict:
    """One layer's params."""
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    return {"ln1": zeros(), "ln2": zeros(),
            "attn": init_attention(cfg, gen, dtype),
            "mlp": init_mlp(cfg, gen, dtype)}


def init_lm(cfg: ArchConfig, gen: torch.Generator) -> Pytree:
    """Random params on the generator's device.  Each layer is drawn apart
    and copied into its slice of the stacked leaves, so only one layer's
    f32 draws exist at a time (the full qwen3-14b is 29.5 GB in bf16)."""
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
    blocks = None
    for i in range(cfg.num_layers):
        layer = _init_block(cfg, gen, dtype)
        if blocks is None:
            blocks = tree_map(lambda a: torch.empty(
                (cfg.num_layers,) + tuple(a.shape), dtype=a.dtype,
                device=a.device), layer)
        tree_map(lambda dst, src: dst[i].copy_(src), blocks, layer)
        del layer
    params["blocks"] = blocks
    return params


def layer_views(blocks: Pytree, num_layers: int) -> List[Pytree]:
    """Per-layer views of the stacked leaves (no copy)."""
    return [tree_map(lambda a: a[i], blocks) for i in range(num_layers)]


# ------------------------------------------------------------------ forward

def _block_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                   positions: torch.Tensor, window: Optional[int],
                   return_kv: bool = False):
    """One layer. Returns (x, aux, kv or None)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mode = "window" if window is not None else "causal"
    out = attention_forward(cfg, p["attn"], h, positions, mode=mode,
                            window=window, return_kv=return_kv)
    attn, kv = out if return_kv else (out, None)
    x = x + attn
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp_forward(cfg, p["mlp"], h)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), kv


def _logits(cfg: ArchConfig, params: Pytree, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def forward_train(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
                  window: Optional[int] = None, remat=False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V), aux_loss).  Activation
    checkpointing (``remat``) waits for the training slice and raises."""
    check_family(cfg)
    if remat:
        raise NotImplementedError(
            f"remat={remat!r} waits for the training slice of repro_torch "
            "(reference: repro.models.transformer forward_train(remat=...); "
            "ROADMAP queue 1); only remat=False runs")
    S = tokens.shape[1]
    window = window if window is not None else cfg.sliding_window
    x = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for p in layer_views(params["blocks"], cfg.num_layers):
        x, a, _ = _block_forward(cfg, p, x, positions, window)
        aux = aux + a
    return _logits(cfg, params, x), aux


# ------------------------------------------------------------ prefill/decode

class LMCache(NamedTuple):
    """Per-family cache container (unused fields are None)."""
    kv: Optional[KVCache]            # (L, B, S, KVH, hd) stacked over layers
    ssm: Optional[Any]
    shared_kv: Optional[KVCache]
    position: int


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
    shape = (cfg.num_layers, batch, cap, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dtype = dtype_of(cfg.dtype)
    kv = KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                 torch.zeros(shape, dtype=dtype, device=dev))
    return LMCache(kv, None, None, 0)


def prefill(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
            max_seq: int, window: Optional[int] = None
            ) -> Tuple[torch.Tensor, LMCache]:
    """Run the full prompt, build the cache, return last-position logits."""
    check_family(cfg)
    S = tokens.shape[1]
    window = window if window is not None else cfg.sliding_window
    x = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device)
    ks, vs = [], []
    for p in layer_views(params["blocks"], cfg.num_layers):
        x, _, (k, v) = _block_forward(cfg, p, x, positions, window,
                                      return_kv=True)
        ks.append(k)
        vs.append(v)
    cap = cache_capacity(cfg, max_seq)
    dtype = dtype_of(cfg.dtype)
    kc = ring_place(torch.stack(ks), cap).to(dtype)
    vc = ring_place(torch.stack(vs), cap).to(dtype)
    logits = _logits(cfg, params, x[:, -1:, :])
    return logits[:, 0], LMCache(KVCache(kc, vc), None, None, S)


def _block_decode(cfg: ArchConfig, p: Dict, h: torch.Tensor, attend
                  ) -> torch.Tensor:
    a = rms_norm(h, p["ln1"], cfg.norm_eps)
    h = h + attend(a)
    m = rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + mlp_forward(cfg, p["mlp"], m)


def decode_step(cfg: ArchConfig, params: Pytree, token: torch.Tensor,
                cache: LMCache, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, LMCache]:
    """token (B,) → (logits (B, V), cache), every row at
    ``cache.position``; the cache's rows are written in place."""
    check_family(cfg)
    window = window if window is not None else cfg.sliding_window
    x = params["embed"][token][:, None, :]     # (B,1,d)
    pos = cache.position
    for i, p in enumerate(layer_views(params["blocks"], cfg.num_layers)):
        kv = KVCache(cache.kv.k[i], cache.kv.v[i])
        x = _block_decode(cfg, p, x, lambda a: attention_decode(
            cfg, p["attn"], a, kv, pos, window=window)[0])
    logits = _logits(cfg, params, x)
    return logits[:, 0], cache._replace(position=pos + 1)


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
        x = x + mlp_forward(cfg, p["mlp"], m)
    logits = _logits(cfg, params, x)
    return logits[0], cache
