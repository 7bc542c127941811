"""Analytic roofline model per arch × shape × mesh
(``repro.launch.analytic``), line for line.

The reference built this model because XLA's ``cost_analysis()`` counts a
``while``-loop body once, whatever its trip count, so a scanned model's
artifact undercounts by ~L (``repro/launch/analytic.py:4-14``).  The port
has no such artifact: ``launch.hlo_analysis.TraceCost`` counts an eager
trace, every layer dispatched.  The formulas stay as the reference's, for
every input, so both packages' first-order terms can be set side by side
and against the card's measured steps (``chip_smoke.py``'s ``roofline``
phase).  Every count (``flops``, ``hbm_bytes``, ``coll_bytes``,
``model_flops``, ``useful_ratio``) equals the reference's; only the seconds
change, through the H100 constants of ``launch.hlo_analysis`` (the
reference's TPU v5e constants replaced: 989 TFLOP/s bf16, 3.35 TB/s HBM,
450 GB/s of NVLink in one direction in place of four ICI links).

The reference's quirks are kept (``ROADMAP.md`` queue 3): the dead
``if False`` in whisper's decoder context, whisper's decode bytes without
its cross K/V, and the cohort combine's all-reduce counted on a one-chip
train shape.

All quantities are PER DEVICE per step.  Formulas are intentionally
first-order (matmul FLOPs + the dominant HBM streams); constants are
documented inline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..models.config import ArchConfig
from .hlo_analysis import HBM_BW, LINK_BW, PEAK_FLOPS
from .shapes import InputShape

BF16 = 2
F32 = 4


def _layer_flops_per_token(cfg: ArchConfig, ctx: int,
                           window: Optional[int]) -> float:
    """Forward matmul FLOPs per token for ONE layer (no embedding/head)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    gates = 2 if cfg.activation in ("silu", "geglu") else 1

    if cfg.family == "ssm" and cfg.rwkv:
        P = cfg.rwkv_head_dim
        Q = max(cfg.ssm_chunk // 4, 16)
        proj = 2 * d * d * 5 + 2 * d * d          # r,k,v,g,w-lora≈d² + out
        # per token: intra-chunk pair products ≈ 2·Q·P + state update 4·P²
        wkv = cfg.rwkv_num_heads * (2 * Q * P + 4 * P * P)
        ffn = 2 * d * cfg.d_ff * 2 + 2 * d * d    # k² path + receptance
        return proj + wkv + ffn

    if cfg.family in ("ssm", "hybrid") and cfg.ssm_state:
        di, N = cfg.ssm_d_inner, cfg.ssm_state
        Hs, P = cfg.ssm_num_heads, cfg.ssm_head_dim
        Q = cfg.ssm_chunk
        proj = 2 * d * (2 * di + 2 * N + Hs) + 2 * di * d
        conv = 2 * cfg.ssm_conv_width * (di + 2 * N)
        # SSD per token: CB row (2·Q·N), M@x (2·Q·P per head … already per
        # token), state in/out (4·P·N per head)
        ssd = Hs * (2 * Q * N / 1 + 2 * Q * P + 4 * P * N)
        return proj + conv + ssd

    attn_ctx = min(ctx, window) if window else ctx
    attn = (2 * d * (H + 2 * KV) * hd + 2 * H * hd * d        # projections
            + 2 * 2 * attn_ctx * H * hd * 0.5)                # QKᵀ + PV causal
    if cfg.family == "moe":
        ff = (2 * d * cfg.d_ff * (gates + 1)
              * (cfg.experts_per_token + cfg.num_shared_experts)
              + 2 * d * cfg.num_experts)
    else:
        ff = 2 * d * cfg.d_ff * (gates + 1)
    return attn + ff


def _hybrid_layer_mix(cfg: ArchConfig, ctx: int, window):
    """Zamba2: L mamba layers + shared attention block every attn_every."""
    mamba = _layer_flops_per_token(
        cfg.with_overrides(family="ssm", rwkv=False), ctx, None)
    attn_cfg = cfg.with_overrides(family="dense", ssm_state=0)
    attn = _layer_flops_per_token(attn_cfg, ctx, window)
    n_shared = cfg.num_layers // cfg.attn_every
    return cfg.num_layers * mamba + n_shared * attn


def model_forward_flops(cfg: ArchConfig, shape: InputShape,
                        window: Optional[int]) -> float:
    """GLOBAL forward FLOPs for one step of this shape."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        tokens = B
        ctx = S
    else:
        tokens = B * S
        ctx = S
    d, V = cfg.d_model, cfg.vocab_size

    if cfg.family == "hybrid":
        per_tok = _hybrid_layer_mix(cfg, ctx, window) / max(cfg.num_layers, 1)
        layers = _hybrid_layer_mix(cfg, ctx, window)
    elif cfg.family == "audio":
        dec = _layer_flops_per_token(cfg, min(ctx, cfg.max_target_positions
                                              if False else ctx), window)
        cross = 2 * d * 2 * cfg.num_kv_heads * cfg.resolved_head_dim \
            + 2 * 2 * cfg.max_source_positions * cfg.num_heads \
            * cfg.resolved_head_dim
        layers = cfg.num_layers * (dec + cross)
        if shape.kind != "decode":
            enc_tokens = cfg.max_source_positions
            enc = _layer_flops_per_token(
                cfg.with_overrides(family="dense"), enc_tokens, None)
            return (tokens * layers + 2 * tokens * d * V
                    + B * enc_tokens * cfg.encoder_layers * enc)
    else:
        layers = cfg.num_layers * _layer_flops_per_token(cfg, ctx, window)
    head = 2 * d * V
    return tokens * (layers + head)


@dataclass
class AnalyticRoofline:
    flops: float          # per device
    hbm_bytes: float      # per device
    coll_bytes: float     # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float   # MODEL_FLOPS(6·N_active·D) / analytic flops

    def to_dict(self):
        return self.__dict__.copy()


def analytic_roofline(cfg: ArchConfig, shape: InputShape, *,
                      data: int = 16, model: int = 16, pods: int = 1,
                      aggregator: str = "contextual",
                      gram_scope_bytes: Optional[float] = None,
                      remat="full", dp_only: bool = False,
                      ring_kv: bool = False) -> AnalyticRoofline:
    """Three roofline terms per device (DESIGN.md §7 sharding scheme).

    Variant knobs mirror the implementation's §Perf levers:
      * ``remat``   — False | "full" (recompute everything) | "dots"
                      (matmul outputs saved; ~15% of fwd recomputed);
      * ``dp_only`` — params replicated, all axes data-parallel (no TP
                      collectives; combine is a full-size all-reduce);
      * ``ring_kv`` — window-bounded ring KV cache for decode.
    """
    chips = data * model * pods
    window = cfg.sliding_window
    B, S = shape.global_batch, shape.seq_len
    n_params = cfg.param_count_estimate()
    n_active = cfg.active_param_count()
    p_bytes = n_params * BF16
    d = cfg.d_model
    p_shard = 1 if dp_only else chips      # param residency divisor
    model_eff = 1 if dp_only else model

    fwd = model_forward_flops(cfg, shape, window)
    if shape.kind == "train":
        flops_global = 3.0 * fwd                    # fwd + 2×bwd
        if remat in (True, "full"):
            flops_global += fwd                     # full recompute
        elif remat == "dots":
            flops_global += 0.15 * fwd              # elementwise-only recompute
    else:
        flops_global = fwd
    flops_dev = flops_global / chips

    # ---- HBM traffic per device ------------------------------------------
    tokens = B * S if shape.kind != "decode" else B
    dp_ways = chips if dp_only else data * pods
    tok_dev = tokens / dp_ways if tokens >= dp_ways else tokens
    act_bytes_layer = tok_dev * d * BF16
    if shape.kind == "train":
        # params read fwd+bwd (+1 recompute), grads written, updates combined
        hbm = (3 * p_bytes / p_shard) * 2 + 2 * p_bytes / p_shard \
            + cfg.num_layers * act_bytes_layer * (8 if remat else 4) \
            + tok_dev * cfg.vocab_size * F32 / model_eff * 2
    elif shape.kind == "prefill":
        hbm = p_bytes / chips + cfg.num_layers * act_bytes_layer * 6 \
            + 2 * cfg.num_layers * tok_dev * cfg.num_kv_heads \
            * cfg.resolved_head_dim * BF16
    else:
        # decode: read all (sharded) params once + stream the KV cache
        if cfg.family == "ssm":
            state = (cfg.rwkv_num_heads * cfg.rwkv_head_dim ** 2 if cfg.rwkv
                     else cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state)
            cache_bytes = cfg.num_layers * B * state * F32
        else:
            eff_S = min(S, window) if (window and ring_kv) else S
            n_caches = (cfg.num_layers // cfg.attn_every
                        if cfg.family == "hybrid" else cfg.num_layers)
            cache_bytes = (n_caches * B * eff_S * cfg.num_kv_heads
                           * cfg.resolved_head_dim * 2 * BF16)
            if cfg.family == "hybrid":
                state = cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state
                cache_bytes += cfg.num_layers * B * state * F32
        hbm = p_bytes / chips + cache_bytes / chips

    # ---- collective traffic per device ------------------------------------
    # ring all-reduce of x bytes ≈ 2x on the wire per device.
    coll = 0.0
    if shape.kind == "train":
        if not dp_only:
            # per-layer TP: attn out + mlp out all-reduce (fwd) + same in bwd
            tp_layer = 2 * act_bytes_layer * 2 * 2
            coll += cfg.num_layers * tp_layer
        # cohort combine: α-weighted all-reduce of the update
        coll += 2 * (n_params / model_eff) * BF16
        if aggregator == "contextual":
            scope = gram_scope_bytes if gram_scope_bytes is not None else \
                cfg.vocab_size * d * F32          # lm_head slice (f32)
            C = dp_ways
            coll += (C - 1) / C * scope / model_eff  # all-gather scoped slices
        if n_params >= 7e9 and not dp_only:        # FSDP param all-gathers
            coll += 2 * p_bytes / chips * 2       # fwd + bwd gather
    elif shape.kind == "prefill":
        coll += cfg.num_layers * 2 * act_bytes_layer * 2
    else:
        # decode TP all-reduce of (B_loc, d) per layer ×2 blocks + LSE merge
        bloc = max(B / (data * pods), 1)
        coll += cfg.num_layers * 2 * 2 * bloc * d * BF16
        coll += cfg.num_layers * 2 * bloc * cfg.num_heads \
            * (cfg.resolved_head_dim + 1) * F32    # (o, lse) partial merge

    compute_s = flops_dev / PEAK_FLOPS
    memory_s = hbm / HBM_BW
    coll_s = coll / LINK_BW                        # NVLink 4, one direction
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)

    if shape.kind == "train":
        mf = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        mf = 2.0 * n_active * tokens
    else:
        mf = 2.0 * n_active * B
    return AnalyticRoofline(flops_dev, hbm, coll, compute_s, memory_s,
                            coll_s, bottleneck, mf / chips,
                            (mf / chips) / max(flops_dev, 1e-9))
