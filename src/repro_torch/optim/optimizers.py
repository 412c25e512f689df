"""SGD over the flat silo-parameter matrix and over per-leaf trees,
AdamW, a cosine schedule and global-norm clipping (counterpart of
`repro.optim.optimizers`)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.launch.mesh import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable    # (w) -> state
    update: Callable  # (w, g, state, lr_scale=1.0) -> (w, state)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """SGD(+momentum) leaf by leaf over a (nested) dict of tensors, the
    legacy runtime's layout. The same ops as `flat_sgd`, each its own
    tensor op, so a leaf's update equals its slice of the flat update bit
    for bit (torch's eager ops never contract a multiply into an add).
    """
    def init(params):
        state = {"step": 0}
        if momentum != 0.0:
            state["mu"] = tree_map(torch.zeros_like, params)
        return state

    def update(params, grads, state, lr_scale=1.0):
        step = state["step"] + 1
        lr_t = lr * lr_scale
        if momentum == 0.0:
            return tree_map(lambda p, g: p - (lr_t * g), params, grads), \
                {"step": step}
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        new = tree_map(lambda p, m: p - (lr_t * m), params, mu)
        return new, {"step": step, "mu": mu}

    return Optimizer(init, update)


def flat_sgd(lr: float, momentum: float = 0.0,
             weight_decay: float = 0.0) -> Optimizer:
    """SGD(+momentum) over a flat `(N, T)` silo-parameter matrix.

    Every multiply and add is its own tensor op, so each product is
    rounded before the add: ``w - (lr * g)`` is the reference's
    momentum-0 update bit for bit. (``torch.add(w, g, alpha=-lr)`` would
    fuse the two and round once.) The step counter is a shared integer,
    identical across silos in DPASGD's synchronized rounds.
    """

    def init(w):
        state = {"step": 0}
        if momentum != 0.0:
            state["mu"] = w.new_zeros(w.shape)
        return state

    def update(w, g, state, lr_scale=1.0):
        step = state["step"] + 1
        lr_t = lr * lr_scale
        if weight_decay:
            g = g + weight_decay * w
        if momentum == 0.0:
            return w - (lr_t * g), {"step": step}
        mu = momentum * state["mu"] + g
        return w - (lr_t * mu), {"step": step, "mu": mu}

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW leaf by leaf over a (nested) dict of tensors: m and v in
    fp32, the update computed in fp32 and cast back to each parameter's
    type. The step counter is one shared integer (a tree with a leading
    silo axis updates every silo at the same step), and the bias
    corrections 1 - b**t are fp32, as the reference computes them."""
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"step": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(params, grads, state, lr_scale=1.0):
        step = state["step"] + 1
        t = np.float32(step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        lr_t = lr * lr_scale

        def upd(p, m_, v_):
            delta = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            return (p.float() - lr_t * delta).to(p.dtype)

        return tree_map(upd, params, m, v), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup: int = 0) -> Callable:
    """step -> learning rate: linear warm-up over ``warmup`` steps, then
    a cosine decay to 0 at ``total_steps``; computed in fp32."""
    f32 = np.float32

    def lr(step):
        step = f32(step)
        warm = np.minimum(step / f32(max(warmup, 1)), f32(1))
        prog = np.clip((step - f32(warmup)) / f32(max(total_steps - warmup,
                                                      1)), f32(0), f32(1))
        return float(f32(base_lr) * warm * f32(0.5)
                     * (f32(1) + np.cos(f32(np.pi) * prog)))

    return lr


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by min(1, max_norm / ||grads||), the norm taken in
    fp32 over all leaves; each leaf keeps its type. Returns (grads,
    norm)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
