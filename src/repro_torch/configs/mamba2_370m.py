"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1024 ssm_state=128 vocab=50280. [arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    tie_embeddings=True,
)
