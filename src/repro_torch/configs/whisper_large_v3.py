"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder audio backbone.

32 decoder layers (+32 encoder), d_model 1280, 20 heads (kv=20), d_ff 5120,
vocab 51866.  Conv/mel frontend STUBBED: input_specs supplies 1500 frame
embeddings.  The decoder context, 448, is not enforced (as in the reference).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio", is_encoder_decoder=True,
    num_layers=32, encoder_layers=32, d_model=1280, num_heads=20,
    num_kv_heads=20, d_ff=5120, vocab_size=51_866,
    max_source_positions=1500, max_target_positions=448,
    activation="gelu", dtype="bfloat16",
)
