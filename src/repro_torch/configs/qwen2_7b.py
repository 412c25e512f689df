"""qwen2-7b [dense] — GQA with QKV bias. 28L d_model=3584 28H (kv=4)

d_ff=18944 vocab=152064. [arXiv:2407.10671]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, vocab_size=152064,
    num_heads=28, num_kv_heads=4, head_dim=128, qkv_bias=True,
    d_ff=18944, rope_theta=1_000_000.0,
    tie_embeddings=False,
)
