"""paligemma-3b [vlm] — SigLIP vision stub + gemma decoder.

18L d_model=2048 8H (kv=1, MQA) d_ff=16384 vocab=257216; 256 image
patch tokens attend bidirectionally (prefix-LM). [arXiv:2407.07726]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, vocab_size=257216,
    num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, mlp_act="gelu",
    frontend="vision", num_prefix_tokens=256,
    tie_embeddings=True,
)
