"""Model configuration covering every assigned architecture family.

One ModelConfig describes dense GQA transformers, MoE, Mamba2 (SSD),
hybrid (Mamba2 + shared attention), and stub-fronted VLM / audio
decoders. src/repro_torch/configs/<arch>.py instantiate these with the exact
assigned hyper-parameters and provide reduced variants for CPU smoke
tests.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    vocab_size: int

    # --- attention ---
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    # 0 = full attention; otherwise window size of local layers.
    sliding_window: int = 0
    # For mixed local/global stacks (gemma3): one global layer every
    # `global_every` layers, the rest local with `sliding_window`.
    global_every: int = 0
    rope_theta: float = 10_000.0

    # --- mlp ---
    d_ff: int = 0
    mlp_act: Literal["silu", "gelu"] = "silu"

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    expert_d_ff: int = 0
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2-style): shared attention block cadence ---
    attn_every: int = 0  # apply the shared attention block every k layers

    # --- frontends (stubs; see DESIGN.md carve-out) ---
    frontend: Literal["none", "vision", "audio"] = "none"
    num_prefix_tokens: int = 0  # patch/frame embeddings prepended

    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # ----- derived -----
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def uses_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic decode: SSM/hybrid, or sliding-window dense."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def validate(self) -> None:
        if self.uses_attention and self.num_heads:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, \
                f"{self.name}: num_heads must be divisible by num_kv_heads"
        if self.uses_moe:
            assert 0 < self.experts_per_token <= self.num_experts
            assert self.expert_d_ff > 0
        if self.uses_ssm:
            assert self.ssm_state > 0
            assert self.ssm_inner % self.ssm_head_dim == 0
        if self.global_every:
            assert self.sliding_window > 0, \
                f"{self.name}: local/global pattern needs a window size"

    def param_count(self) -> int:
        """Total parameter count N (analytic; used for 6ND roofline)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        return _param_count(self, active_only=True)


def _param_count(c: ModelConfig, active_only: bool) -> int:
    n = c.vocab_size * c.d_model  # embeddings
    if not c.tie_embeddings:
        n += c.vocab_size * c.d_model
    per_layer = 0
    attn = 0
    if c.uses_attention and c.num_heads:
        attn = c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
        if c.qkv_bias:
            attn += c.q_dim + 2 * c.kv_dim
    mlp_dense = 3 * c.d_model * c.d_ff if c.d_ff else 0
    if c.family in ("dense", "vlm", "audio"):
        per_layer = attn + mlp_dense + 2 * c.d_model
        n += c.num_layers * per_layer
    elif c.family == "moe":
        experts = c.experts_per_token if active_only else c.num_experts
        moe = experts * 3 * c.d_model * c.expert_d_ff + c.d_model * c.num_experts
        n += c.num_layers * (attn + moe + 2 * c.d_model)
    elif c.family == "ssm":
        n += c.num_layers * (_ssm_params(c) + c.d_model)
    elif c.family == "hybrid":
        n += c.num_layers * (_ssm_params(c) + c.d_model)
        # one shared attention+mlp block (parameters counted once)
        n += attn + mlp_dense + 2 * c.d_model
    n += c.d_model  # final norm
    return int(n)


def _ssm_params(c: ModelConfig) -> int:
    di, ds, nh = c.ssm_inner, c.ssm_state, c.ssm_heads
    in_proj = c.d_model * (2 * di + 2 * ds + nh)  # z, x, B, C, dt
    conv = c.ssm_conv * (di + 2 * ds)
    out_proj = di * c.d_model
    extras = nh * 2 + di  # A_log, dt_bias, D (skip)
    return in_proj + conv + out_proj + extras
