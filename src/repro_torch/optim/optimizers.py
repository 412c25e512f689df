"""SGD over the flat silo-parameter matrix and over per-leaf trees
(counterparts of `repro.optim.optimizers.flat_sgd` and `sgd`)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.launch.mesh import tree_map


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
