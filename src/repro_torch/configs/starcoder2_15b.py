"""StarCoder2-15B [arXiv:2402.19173] — dense, GQA kv=4, RoPE.

40 layers, d_model 6144, 48 heads (kv=4), d_ff 24576, vocab 49152.
(The public model uses LN+GELU; we keep the assigned dims with the
framework's RMSNorm/gated-MLP stack — gelu activation preserved.)
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    d_ff=24576, vocab_size=49152,
    activation="gelu", rope_theta=100_000.0, dtype="bfloat16",
    sliding_window=4096,   # starcoder2 trains with 4k sliding window
)
