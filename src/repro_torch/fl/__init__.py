"""Federated learning over the multigraph: round plans, the flat
whole-cycle runtime, its legacy per-round oracle and its mesh-sharded
twin, LoRA deltas, the training loop and gossip over the silo axis."""

from repro_torch.fl.dpasgd import (FLSimState, RoundPlan, fl_round_step,
                                   init_fl_state, make_round_schedule)
from repro_torch.fl.gossip import (gossip_dense, gossip_ring_ppermute,
                                   init_ring_buffers, ring_coefficients,
                                   ring_matrix)
from repro_torch.fl.lora import LoRAAdapter, make_lora_adapter
from repro_torch.fl.mesh import (MeshRuntime, gather_flat_state,
                                 init_mesh_state, make_mesh_runtime)
from repro_torch.fl.runtime import (FlatFLState, FlatRuntime, init_flat_state,
                                    make_cycle_fn, make_flat_runtime,
                                    unpack_buffers, unpack_params)
from repro_torch.fl.trainer import FLConfig, FLResult, run_fl, train

__all__ = ["RoundPlan", "make_round_schedule", "FLSimState", "init_fl_state",
           "fl_round_step", "FlatFLState", "FlatRuntime", "init_flat_state",
           "make_cycle_fn", "make_flat_runtime", "unpack_buffers",
           "unpack_params", "FLConfig", "FLResult", "run_fl", "train",
           "MeshRuntime", "make_mesh_runtime", "init_mesh_state",
           "gather_flat_state", "LoRAAdapter", "make_lora_adapter",
           "gossip_dense",
           "gossip_ring_ppermute", "init_ring_buffers", "ring_coefficients",
           "ring_matrix"]
