"""RWKV6-1.6B "Finch" [arXiv:2404.05892] — attention-free, data-dependent decay.

24 layers, d_model 2048, d_ff 7168, vocab 65536.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm", rwkv=True,
    num_layers=24, d_model=2048, d_ff=7168, vocab_size=65_536,
    rwkv_head_dim=64, ssm_chunk=128,
    dtype="bfloat16",
)
