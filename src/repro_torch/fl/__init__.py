"""Federated learning over the multigraph: round plans, the flat
whole-cycle runtime, the training loop and gossip over the silo axis."""

from repro_torch.fl.dpasgd import RoundPlan, make_round_schedule
from repro_torch.fl.gossip import (gossip_dense, gossip_ring_ppermute,
                                   init_ring_buffers, ring_coefficients,
                                   ring_matrix)
from repro_torch.fl.runtime import (FlatFLState, FlatRuntime, init_flat_state,
                                    make_cycle_fn, make_flat_runtime)
from repro_torch.fl.trainer import FLConfig, FLResult, run_fl, train

__all__ = ["RoundPlan", "make_round_schedule", "FlatFLState", "FlatRuntime",
           "init_flat_state", "make_cycle_fn", "make_flat_runtime",
           "FLConfig", "FLResult", "run_fl", "train", "gossip_dense",
           "gossip_ring_ppermute", "init_ring_buffers", "ring_coefficients",
           "ring_matrix"]
