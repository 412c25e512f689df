"""Shared layer primitives: RMSNorm, RoPE, MLP, embeddings, losses
(counterpart of `repro.models.layers`).

Parameters are plain dicts of tensors with the reference's names and
shapes: `(in, out)` dense weights, `(vocab, d_model)` token embeddings.
Every layer is a free function over such a dict, so the transformer in
`transformer.py` can keep its blocks stacked on a leading layer axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import shard_ctx

Params = dict


def _dense_init(gen: torch.Generator, shape, scale=None,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """normal * 1/sqrt(fan_in) (or ``scale``), drawn in fp32 from ``gen``
    on ``device`` (the generator's device by default), cast to ``dtype``."""
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    device = gen.device if device is None else device
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Computed in fp32, cast back to the input's type."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * p["scale"]
    return out.to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # theta ** x in fp32, made on the device: no host-to-device copy
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, num_heads, head_dim); positions: (..., seq), e.g.
    (1, S) for a prefill or (B, 1) per-slot positions at decode."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device=None) -> Params:
    return {
        "w_gate": _dense_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_up": _dense_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_down": _dense_init(gen, (d_ff, d_model), dtype=dtype,
                              device=device),
    }


def _act(act: str):
    if act == "silu":
        return F.silu
    # jax.nn.gelu defaults to the tanh approximation
    return lambda h: F.gelu(h, approximate="tanh")


def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = _act(act)(shard_ctx.constrain_channels(x @ p["w_gate"])) * \
        shard_ctx.constrain_channels(x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               tie: bool, device=None) -> Params:
    p = {"tok": _dense_init(gen, (vocab, d_model), scale=0.02, dtype=dtype,
                            device=device)}
    if not tie:
        p["unembed"] = _dense_init(gen, (d_model, vocab), dtype=dtype,
                                   device=device)
    return p


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the token table. A DTensor table split over its vocabulary
    is looked up on each rank's own rows (`shard_ctx.row_lookup`), not
    gathered."""
    tok = shard_ctx.unshard(p["tok"])
    if shard_ctx.is_dtensor(tok):
        return shard_ctx.row_lookup(tok, tokens)
    return tok[tokens]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in p:
        return x @ shard_ctx.unshard(p["unembed"])
    return x @ shard_ctx.unshard(p["tok"]).T.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def logsumexp_last(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim; DTensor logits split over the
    vocabulary reduce their max and sum over those ranks instead of
    being gathered."""
    if shard_ctx.is_dtensor(logits):
        return shard_ctx.last_dim_logsumexp(logits)
    return torch.logsumexp(logits, dim=-1)


def label_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[..., labels]: (..., V), (...) -> (...). DTensor logits
    split over the vocabulary gather on each rank's own slice of it,
    zero where the label lies elsewhere, and sum over those ranks (the
    vocab-parallel gather)."""
    if shard_ctx.is_dtensor(logits):
        return shard_ctx.last_dim_gather(logits, labels.long())
    return torch.gather(logits, -1, labels[..., None].long())[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy. logits (..., V), labels (...)."""
    logits = logits.float()
    nll = logsumexp_last(logits) - label_logits(logits, labels)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
