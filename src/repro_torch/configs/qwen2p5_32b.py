"""Qwen2.5-32B [hf:Qwen/Qwen2.5 family card] — dense, GQA kv=8, QKV bias.

64 layers, d_model 5120, 40 heads (kv=8), d_ff 27648, vocab 152064.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=27648, vocab_size=152_064,
    qkv_bias=True, activation="silu", rope_theta=1_000_000.0,
    dtype="bfloat16",
)
