"""yi-9b [dense] — llama-architecture GQA. 48L d_model=4096 32H (kv=4)

d_ff=11008 vocab=64000. [arXiv:2403.04652]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, vocab_size=64000,
    num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=11008, rope_theta=5_000_000.0,
    tie_embeddings=False,
)
