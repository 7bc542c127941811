"""Qwen3-14B [hf:Qwen/Qwen3-8B family card] — dense, qk_norm, GQA kv=8.

40 layers, d_model 5120, 40 heads (kv=8), d_ff 17408, vocab 151936.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=17408, vocab_size=151_936,
    qk_norm=True, activation="silu", rope_theta=1_000_000.0,
    dtype="bfloat16",
)
