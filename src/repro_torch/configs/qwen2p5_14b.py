"""qwen2.5-14b [dense] — GQA with QKV bias. 48L d_model=5120 40H (kv=8)

d_ff=13824 vocab=152064. [hf:Qwen/Qwen2.5-0.5B family card]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, vocab_size=152064,
    num_heads=40, num_kv_heads=8, head_dim=128, qkv_bias=True,
    d_ff=13824, rope_theta=1_000_000.0,
    tie_embeddings=False,
)
