"""Optimizers over the flat silo-parameter matrix and per-leaf trees."""

from repro_torch.optim.optimizers import Optimizer, flat_sgd, sgd

__all__ = ["Optimizer", "flat_sgd", "sgd"]
