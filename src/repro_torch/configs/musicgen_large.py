"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048; conditioning
frame embeddings are a stub prefix. [arXiv:2306.05284]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, vocab_size=2048,
    num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, mlp_act="gelu",
    frontend="audio", num_prefix_tokens=64,
    tie_embeddings=False,
)
