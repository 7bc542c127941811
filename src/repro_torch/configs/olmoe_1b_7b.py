"""OLMoE-1B-7B [arXiv:2409.02060] — 64 experts top-8, no shared experts.

16 layers, d_model 2048, 16 heads (kv=16), per-expert d_ff 1024, vocab 50304.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50_304,
    num_experts=64, experts_per_token=8, num_shared_experts=0,
    qk_norm=True, activation="silu", rope_theta=10_000.0, dtype="bfloat16",
)
