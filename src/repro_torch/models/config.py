"""Unified architecture configuration.

One dataclass covers the whole assigned pool (dense / MoE / SSM / hybrid /
VLM / audio / the paper's own logistic model); family-specific fields are
zero/None when unused.  ``repro_torch.configs`` instantiates one of
these per ported architecture.  A copy of ``repro.models.config``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio | logreg
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0               # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0

    # attention details
    rope_theta: float = 10_000.0
    qk_norm: bool = False           # qwen3
    qkv_bias: bool = False          # qwen2.5
    attn_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None   # set -> windowed attention variant
    activation: str = "silu"        # silu (SwiGLU) | geglu | gelu

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # RWKV6
    rwkv: bool = False
    rwkv_head_dim: int = 64

    # hybrid (zamba2): shared attention block applied every `attn_every` layers
    attn_every: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    max_source_positions: int = 1500
    max_target_positions: int = 448

    # VLM (chameleon): leading image-patch embeddings consumed via projector
    num_image_tokens: int = 0

    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # logistic-regression (paper model)
    input_dim: int = 0
    num_classes: int = 0

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def rwkv_num_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k eligibility: SSM/hybrid natively; dense /
        moe / vlm via the sliding-window variant; whisper never."""
        return self.family != "audio"

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family variant for CPU smoke tests (≤2 layers,
        d_model ≤ 512, ≤4 experts)."""
        small = dict(
            num_layers=min(self.num_layers, 2) or self.num_layers,
            d_model=min(self.d_model, 256) if self.d_model else self.d_model,
            d_ff=min(self.d_ff, 512) if self.d_ff else self.d_ff,
            vocab_size=min(self.vocab_size, 512) if self.vocab_size else self.vocab_size,
            dtype="float32",
        )
        if self.num_heads:
            small["num_heads"] = min(self.num_heads, 4)
            small["num_kv_heads"] = min(self.num_kv_heads, min(self.num_heads, 4))
            small["head_dim"] = 64 if self.head_dim else 0
        if self.num_experts:
            small["num_experts"] = min(self.num_experts, 4)
            small["experts_per_token"] = min(self.experts_per_token, 2)
            small["num_shared_experts"] = min(self.num_shared_experts, 1)
        if self.ssm_state:
            small["ssm_state"] = min(self.ssm_state, 16)
            small["ssm_chunk"] = 32
        if self.rwkv:
            small["rwkv_head_dim"] = 32
        if self.encoder_layers:
            small["encoder_layers"] = min(self.encoder_layers, 2)
            small["max_source_positions"] = 64
        if self.attn_every:
            small["attn_every"] = 2
        if self.num_image_tokens:
            small["num_image_tokens"] = 16
        if self.sliding_window:
            small["sliding_window"] = min(self.sliding_window, 64)
        small.update(overrides)
        return dataclasses.replace(self, name=self.name + "-smoke", **small)

    def with_overrides(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)

    def param_count_estimate(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS = 6·N·D)."""
        if self.family == "logreg":
            return self.input_dim * self.num_classes + self.num_classes
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm" and self.rwkv:
            per = 4 * d * d + 2 * d * self.d_ff + d * d // 8
            return emb + L * per
        if self.family in ("ssm", "hybrid") and self.ssm_state:
            di = self.ssm_d_inner
            per_m = d * (2 * di + 2 * self.ssm_state + self.ssm_num_heads) + di * d
            if self.family == "hybrid":
                attn = (d * (self.num_heads + 2 * self.num_kv_heads) * hd
                        + self.num_heads * hd * d + 3 * d * self.d_ff)
                return emb + L * per_m + attn
            return emb + L * per_m
        attn = d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d
        n_gate = 2 if self.activation in ("silu", "geglu") else 1
        if self.family == "moe":
            ff = (self.num_experts + self.num_shared_experts) * (n_gate + 1) * d * self.d_ff
            ff += d * self.num_experts  # router
        else:
            ff = (n_gate + 1) * d * self.d_ff
        layers = L * (attn + ff)
        if self.is_encoder_decoder:
            layers += self.encoder_layers * (attn + ff) + L * attn  # cross-attn
        return emb + layers

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count_estimate()
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        attn = d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d
        n_gate = 2 if self.activation in ("silu", "geglu") else 1
        ff_active = (self.experts_per_token + self.num_shared_experts) * (n_gate + 1) * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + ff_active + d * self.num_experts)
