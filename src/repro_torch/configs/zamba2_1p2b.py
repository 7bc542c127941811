"""Zamba2-1.2B [arXiv:2411.15242] — Mamba2 backbone + shared attention block.

38 layers, d_model 2048, 32 heads (GQA kv=32), d_ff 8192, vocab 32000,
ssm_state 64.  The shared transformer block (attention + MLP, single weight
set) is interleaved between Mamba2 groups — here every 6 mamba layers.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    attn_every=6,
    activation="silu", rope_theta=10_000.0, dtype="bfloat16",
)
