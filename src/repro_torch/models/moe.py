"""Mixture-of-Experts layer (counterpart of `repro.models.moe`;
phi3.5-moe: 16 experts, top-2; granite: 32 experts, top-8).

Two dispatch paths:
  * "gather" (default) -- sort-based grouped dispatch with a fixed
    capacity per expert and per batch row, cap = int(cf * T * k / E) + 1:
    each row's (token, choice) slots are sorted stably by expert, the
    first cap of each expert's group are kept and the rest dropped, the
    experts run as batched products (`torch.bmm`) over (E, rows * cap)
    buffers in which an unfilled slot reads a zero row, and each token
    sums its k gated outputs in a fixed order (the (T, k) layout
    restored, then a reduction over k; no atomics, so two runs on a card
    agree bit for bit). FLOPs are the active ones.
  * "dense" -- every expert on every token, one-hot combine (the oracle).

The router adds the Switch-style load-balancing loss E * sum_e f_e * p_e,
per batch row on the gather path (then the mean over rows), over all
tokens on the dense path, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _act, _dense_init

IMPLS = ("gather", "dense")


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype,
             device=None) -> Params:
    """The reference's draws: the router fp32 at scale 0.02; the experts'
    (E, in, out) matrices at 1/sqrt(E), since `_dense_init` takes the
    leading dimension as the fan-in."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.expert_d_ff
    return {
        "router": _dense_init(gen, (d, e), scale=0.02, dtype=torch.float32,
                              device=device),
        "w_gate": _dense_init(gen, (e, d, f), dtype=dtype, device=device),
        "w_up": _dense_init(gen, (e, d, f), dtype=dtype, device=device),
        "w_down": _dense_init(gen, (e, f, d), dtype=dtype, device=device),
    }


def _one_hot(idx: torch.Tensor, e: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(e, device=idx.device)).to(dtype)


def _route(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Top-k routing over the token axis -2. x (..., T, D) -> gates
    (..., T, k) in x's type, experts (..., T, k), aux loss (...)."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    e = cfg.num_experts
    me = probs.mean(dim=-2)  # mean router probability per expert
    n = idx.shape[-2] * idx.shape[-1]
    counts = _one_hot(idx.flatten(-2), e, torch.float32).sum(-2)
    aux = e * torch.sum(me * (counts / n), dim=-1)
    return gate.to(x.dtype), idx, aux


def _experts(p: Params, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """xe (E, M, D) -> (E, M, D): each expert's gated MLP on its rows."""
    act = _act(cfg.mlp_act)
    h = torch.bmm(xe, p["w_gate"])
    u = torch.bmm(xe, p["w_up"])
    return torch.bmm(act(h) * u, p["w_down"])


def _moe_dense(p: Params, cfg: ModelConfig, x2d, gate, idx):
    """Oracle path: every expert on every token, one-hot combine."""
    e = cfg.num_experts
    y = _experts(p, cfg, x2d.expand(e, *x2d.shape))      # (E, T, D)
    comb = torch.einsum("tk,tke->te", gate.to(y.dtype),
                        _one_hot(idx, e, y.dtype))
    return torch.einsum("te,etd->td", comb, y)


def _moe_gather(p: Params, cfg: ModelConfig, x, gate, idx,
                capacity_factor: float):
    """Sort-based grouped dispatch with a fixed capacity per expert and
    per row. x (B, T, D); gate, idx (B, T, k)."""
    b, t, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = int(capacity_factor * t * k / e) + 1
    n, dev = t * k, x.device
    flat_e = idx.reshape(b, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = order // k                     # token of each sorted slot
    count = _one_hot(flat_e, e, torch.long).sum(dim=1)   # (B, E)
    start = torch.cumsum(count, dim=1) - count           # group starts

    # Slot c of expert j holds sorted entry start[j] + c while c < count[j];
    # an unfilled slot reads the zero row at index t.
    c = torch.arange(cap, device=dev)
    filled = c < count[..., None]                        # (B, E, cap)
    src = torch.where(filled, start[..., None] + c, 0).reshape(b, e * cap)
    tok = torch.where(filled.reshape(b, e * cap),
                      torch.gather(stok, 1, src), t)
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    rows = torch.arange(b, device=dev)[:, None]
    xe = x_pad[rows, tok].reshape(b, e, cap, d).transpose(0, 1)
    y = _experts(p, cfg, xe.reshape(e, b * cap, d))
    y = y.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)

    # Each (token, choice)'s place in its expert's group, in the original
    # (T, k) order: sorted rank minus the group's start, unsorted.
    pos_sorted = torch.arange(n, device=dev) - torch.gather(start, 1, se)
    pos = torch.gather(pos_sorted, 1, torch.argsort(order, dim=-1))
    keep = pos < cap                      # dropped tokens contribute zero
    slot = torch.where(keep, flat_e * cap + pos, 0)
    w = torch.where(keep, gate.reshape(b, n), 0)
    contrib = w[..., None] * y[rows, slot]               # (B, T*k, D)
    return contrib.reshape(b, t, k, d).sum(dim=2)


def moe(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
        impl: str = "gather", capacity_factor: float = 1.25):
    """x (B,S,D) -> (out (B,S,D), aux_loss 0-d fp32).

    The gather path routes per batch row, with the capacity per row, as
    the reference's `vmap` over rows does."""
    if impl not in IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}; have {IMPLS}")
    b, s, d = x.shape
    if impl == "dense":
        x2d = x.reshape(b * s, d)
        gate, idx, aux = _route(p, cfg, x2d)
        return _moe_dense(p, cfg, x2d, gate, idx).reshape(b, s, d), aux
    gate, idx, aux = _route(p, cfg, x)
    return _moe_gather(p, cfg, x, gate, idx, capacity_factor), aux.mean()
