"""Eight silos over mamba2-370m: one ring gossip round per multigraph
state, run on the card (counterpart of `repro.launch.fl8`).

    PYTHONPATH=src python -m repro_torch.launch.fl8 [--rounds 3]

Eight silos each hold a full mamba2-370m replica and aggregate with
their ring neighbours through `fl.gossip.gossip_ring_ppermute` and the
CUDA `gossip_combine`, once per multigraph state type:

  "overlay"  -- both ring directions strong (full gossip)
  "half"     -- the right direction weak (half the silo-axis bytes)
  "isolated" -- every edge weak (nothing crosses the silo axis; stale
                buffers only)

The reference lowers these rounds on 512 fake host devices and reads the
collective-permute bytes from the HLO; here they run, and each state
reports ms per round, the bytes that crossed the silo axis per round,
the `gossip_combine` launches and the peak device memory. `main` prints
one JSON line per state and writes nothing.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.fl.gossip import (gossip_ring_ppermute, init_ring_buffers,
                                   ring_coefficients)
from repro_torch.kernels.gossip_combine import ops
from repro_torch.launch.mesh import StackedSilos, tree_bytes
from repro_torch.models import transformer as tf

N_SILOS = 8
ARCH = "mamba2-370m"
#: (name, active_left, active_right) per multigraph state type.
STATES = (("overlay", True, True), ("half", True, False),
          ("isolated", False, False))


def build_step(cfg, active_left: bool, active_right: bool, axis,
               use_kernel: bool = True):
    """One gossip round over ``axis`` (the aggregation half of a DPASGD
    round): step(params, buffers) -> (params, buffers)."""
    del cfg  # the round is the same for every model
    cs, cl, cr = ring_coefficients(axis.size)

    def step(params, buffers):
        return gossip_ring_ppermute(
            params, buffers, coeff_self=cs, coeff_left=cl, coeff_right=cr,
            axis=axis, active_left=active_left, active_right=active_right,
            use_kernel=use_kernel)

    return step


def init_silos(cfg, axis, device, seed: int = 0):
    """Each local silo s gets `transformer.init_params` from its own
    generator on ``device``, seeded ``seed + s``."""
    def make(s):
        gen = torch.Generator(device=device).manual_seed(seed + s)
        return tf.init_params(cfg, gen, device=device)

    return axis.from_silos(make)


def run_state(name: str, arch: str, active_left: bool, active_right: bool,
              *, axis, device=None, rounds: int = 3) -> dict:
    """One warm-up round and ``rounds`` timed gossip rounds of one state
    from fresh weights; the report of the timed rounds: ms per round,
    silo-axis bytes, kernel launches and peak memory."""
    device = resolve_device(device)
    cfg = get_config(arch)
    params = init_silos(cfg, axis, device)
    buffers = init_ring_buffers(params)
    step = build_step(cfg, active_left, active_right, axis)
    cuda = device.type == "cuda"
    params, buffers = step(params, buffers)    # warm-up, not counted
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    axis.bytes_moved = 0
    ops.gossip_combine.launches = 0
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        params, buffers = step(params, buffers)
        if cuda:
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return dict(
        state=name, arch=cfg.name, silos=axis.size, rounds=rounds,
        active=[active_left, active_right],
        device=torch.cuda.get_device_name(device) if cuda else str(device),
        ms_per_round=1e3 * sum(times) / rounds,
        ms_runs=[1e3 * t for t in times],
        bytes_per_round=axis.bytes_moved / rounds,
        replica_bytes=tree_bytes(params) // len(axis.local_silos()),
        gossip_combine_launches=ops.gossip_combine.launches,
        launches_per_round=ops.gossip_combine.launches / rounds,
        max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                              if cuda else None))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device()
    axis = StackedSilos(N_SILOS)
    for name, left, right in STATES:
        print(json.dumps(run_state(name, ARCH, left, right, axis=axis,
                                   device=device, rounds=args.rounds)),
              flush=True)


if __name__ == "__main__":
    main()
