"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

62L d_model=5376 32H (kv=16) d_ff=21504 vocab=262144; local layers use a
1024-token sliding window, every 6th layer is global.
[hf:google/gemma-3-1b-pt family card]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    num_layers=62, d_model=5376, vocab_size=262144,
    num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=21504, mlp_act="gelu",
    sliding_window=1024, global_every=6, rope_theta=1_000_000.0,
    tie_embeddings=True,
)
