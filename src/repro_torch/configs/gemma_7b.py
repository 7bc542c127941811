"""Gemma-7B [arXiv:2403.08295] — GeGLU, head_dim 256, GQA kv=16.

28 layers, d_model 3072, 16 heads (kv=16), d_ff 24576, vocab 256000.
Embeddings tied (gemma shares input/output embedding).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
    head_dim=256, d_ff=24576, vocab_size=256_000,
    activation="geglu", tie_embeddings=True, rope_theta=10_000.0,
    dtype="bfloat16",
)
