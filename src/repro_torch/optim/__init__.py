"""Optimizers over the flat silo-parameter matrix and per-leaf trees,
with a learning-rate schedule and gradient clipping."""

from repro_torch.optim.optimizers import (Optimizer, adamw, clip_by_global_norm,
                                          cosine_schedule, flat_sgd, sgd)

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "cosine_schedule",
           "flat_sgd", "sgd"]
