"""Optimizers over the flat silo-parameter matrix."""

from repro_torch.optim.optimizers import Optimizer, flat_sgd

__all__ = ["Optimizer", "flat_sgd"]
