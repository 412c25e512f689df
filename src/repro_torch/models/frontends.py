"""Stub modality frontends (counterpart of `repro.models.frontends`).

The vision (paligemma: SigLIP ViT) and audio (musicgen: EnCodec codec)
encoders are not implemented, as in the reference: the model takes
precomputed patch/frame embeddings of the right shape as
``prefix_embeds``. These helpers give that shape and deterministic
synthetic embeddings for smoke runs.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

# paligemma: 224x224 / 14px SigLIP patches -> 256 image tokens.
VLM_PREFIX_TOKENS = 256
# musicgen: conditioning frames from the text/melody encoder (T5-style),
# a short prefix of continuous embeddings.
AUDIO_PREFIX_TOKENS = 64


def prefix_tokens(cfg: ModelConfig) -> int:
    if cfg.frontend == "vision":
        return cfg.num_prefix_tokens or VLM_PREFIX_TOKENS
    if cfg.frontend == "audio":
        return cfg.num_prefix_tokens or AUDIO_PREFIX_TOKENS
    return 0


def prefix_shape(cfg: ModelConfig, batch: int) -> tuple[int, int, int]:
    return (batch, prefix_tokens(cfg), cfg.d_model)


def synthetic_prefix(cfg: ModelConfig, batch: int, seed: int = 0,
                     device=None) -> torch.Tensor:
    """Deterministic stand-in for encoder outputs: standard normal rows
    drawn in fp32 from ``torch.Generator(device).manual_seed(seed)`` on
    ``device`` (the card by default), each normalised to unit length,
    cast to ``cfg.dtype``.

    The reference draws from ``jax.random.normal(PRNGKey(seed))``, which
    torch cannot reproduce: the shape, the type and the unit rows are the
    reference's, the values are not (parity tests feed the reference's
    arrays to both packages)."""
    p = prefix_tokens(cfg)
    if p == 0:
        raise ValueError(f"{cfg.name} has no frontend")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, p, cfg.d_model), generator=gen, device=device,
                    dtype=torch.float32)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x.to(getattr(torch, cfg.dtype))
