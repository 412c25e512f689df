"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000 ssm_state=64.
[arXiv:2411.15242]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, vocab_size=32000,
    num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    attn_every=6,
    tie_embeddings=True,
)
