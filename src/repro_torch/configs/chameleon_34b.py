"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM, VQ image tokens.

48 layers, d_model 8192, 64 heads (GQA kv=8), d_ff 22016, vocab 65536.
Image tokenizer stubbed: input_specs supplies 1024 patch-code embeddings.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65_536, num_image_tokens=1024,
    qk_norm=True,    # chameleon uses qk-norm for stability
    activation="silu", rope_theta=10_000.0, dtype="bfloat16",
)
