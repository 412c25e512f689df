"""Architecture config registry.

One module per assigned architecture (exact hyper-parameters from the
assignment, source in each file's docstring), plus `reduce()` which maps
any full config to a CPU-smoke-testable variant of the SAME family
(2 layers, d_model <= 512, <= 4 experts) per the brief.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "zamba2_1p2b",
    "yi_9b",
    "qwen2p5_14b",
    "qwen2_7b",
    "phi3p5_moe",
    "paligemma_3b",
    "musicgen_large",
    "mamba2_370m",
    "gemma3_27b",
    "granite_moe_1b",
]

# CLI aliases (the assignment's naming).
ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "yi-9b": "yi_9b",
    "qwen2.5-14b": "qwen2p5_14b",
    "qwen2-7b": "qwen2_7b",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe",
    "paligemma-3b": "paligemma_3b",
    "musicgen-large": "musicgen_large",
    "mamba2-370m": "mamba2_370m",
    "gemma3-27b": "gemma3_27b",
    "granite-moe-1b-a400m": "granite_moe_1b",
}


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS} "
                       f"(aliases: {sorted(ALIASES)})")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduce(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    kw: dict = dict(
        name=cfg.name + "-reduced",
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        vocab_size=min(cfg.vocab_size, 512),
        dtype="float32",  # CPU smoke tests check numerics in f32
    )
    if cfg.uses_attention and cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
                  head_dim=32)
    if cfg.d_ff:
        kw.update(d_ff=min(cfg.d_ff, 512))
    if cfg.uses_moe:
        kw.update(num_experts=4,
                  experts_per_token=min(cfg.experts_per_token, 2),
                  expert_d_ff=min(cfg.expert_d_ff, 128))
    if cfg.uses_ssm:
        kw.update(ssm_state=min(cfg.ssm_state, 16), ssm_head_dim=16,
                  ssm_chunk=16)
    if cfg.family == "hybrid":
        kw.update(attn_every=1)  # 2 layers -> shared attn after each
    if cfg.sliding_window:
        kw.update(sliding_window=16)
    if cfg.global_every:
        kw.update(global_every=2)
    if cfg.num_prefix_tokens or cfg.frontend != "none":
        kw.update(num_prefix_tokens=8)
    return dataclasses.replace(cfg, **kw)
