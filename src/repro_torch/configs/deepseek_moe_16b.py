"""DeepSeekMoE-16B [arXiv:2401.06066] — fine-grained MoE.

28 layers, d_model 2048, 16 heads (kv=16), per-expert d_ff 1408,
vocab 102400; 64 routed experts top-6 + 2 shared experts.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102_400,
    num_experts=64, experts_per_token=6, num_shared_experts=2,
    activation="silu", rope_theta=10_000.0, dtype="bfloat16",
)
