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

Two paths:

* the run path (`run_state`): the rounds run on `StackedSilos(8)`, and
  each state reports ms per round, the bytes that crossed the silo axis
  per round (``bytes_per_round``, the axis's `bytes_moved`), the
  `gossip_combine` launches and the peak device memory;
* the dry path (`dry_state`), the reference's `lower_state`: rank 0 of a
  fake (8, 8, 8) ("pod", "data", "model") world holds its shard of one
  silo's replica (`param_specs(pod_stacked=True)` on that mesh) and runs
  the round over the pod axis (`GroupSilos` on the pod group: each rank
  permutes its own shard, "data" and "model" stay as they lie), with
  `hlo_analysis.CollectiveCounter` on. It reports ``collectives`` and
  ``pod_permute_bytes`` (the collective-permute bytes over "pod"), and
  ``shard_bytes``, rank 0's share of one replica.

The two agree under this conversion, which `tests/test_torch_fl8_dry.py`
holds exactly: a round sends each active direction's replica once, so

    pod_permute_bytes / shard_bytes
        == bytes_per_round / (N_SILOS * replica_bytes)
        == the number of active directions (2, 1, 0).

`main` prints one JSON line per state and writes nothing; ``--dry``
takes the dry path (no card needed).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.fl.gossip import (gossip_ring_ppermute, init_ring_buffers,
                                   ring_coefficients)
from repro_torch.kernels.gossip_combine import ops
from repro_torch.launch import hlo_analysis
from repro_torch.launch import sharding as shrules
from repro_torch.launch.mesh import (GroupSilos, StackedSilos, fake_world,
                                     make_debug_mesh, tree_bytes, tree_map)
from repro_torch.launch.specs import params_shape
from repro_torch.models import transformer as tf

N_SILOS = 8
ARCH = "mamba2-370m"
#: the dry path's mesh: one pod per silo
DRY_MESH = ((N_SILOS, 8, 8), ("pod", "data", "model"))
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
    cfg = get_config(arch) if isinstance(arch, str) else arch
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


def dry_state(name: str, arch, active_left: bool, active_right: bool) -> dict:
    """One gossip round of a state as rank 0 of a fake DRY_MESH world
    (the reference's `lower_state`): its collectives, the pod axis's
    collective-permute bytes and rank 0's shard bytes of one replica.
    ``arch``: a name or a config."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape, axes = DRY_MESH
    stacked = tree_map(lambda x: torch.empty(
        (N_SILOS,) + tuple(x.shape), dtype=x.dtype, device="meta"),
        params_shape(cfg))
    rep = {"variant": f"D_{name}", "arch": cfg.name, "state": name,
           "active": [active_left, active_right], "mesh": list(shape)}
    t0 = time.perf_counter()
    with fake_world(N_SILOS * 64):
        mesh = make_debug_mesh(shape, axes, device_type="cpu")
        specs = shrules.param_specs(cfg, stacked, pod_stacked=True, mesh=mesh)
        axis = GroupSilos(mesh.get_group("pod"))
        step = build_step(cfg, active_left, active_right, axis)
        counter = hlo_analysis.CollectiveCounter(mesh)
        # the ring coefficients, made with the step, are real tensors
        with FakeTensorMode(allow_non_fake_inputs=True):
            def shard(meta, spec):  # rank 0's shard of its pod's silo
                local = shrules.local_shape(meta.shape, mesh, spec)
                return torch.empty(local[1:], dtype=meta.dtype)

            params = shrules.spec_map(shard, stacked, specs)
            bufs = {"left": shrules.spec_map(shard, stacked, specs),
                    "right": shrules.spec_map(shard, stacked, specs)}
            with counter:
                step(params, bufs)
            shard_bytes = tree_bytes(params)
    stats = counter.stats()
    rep.update(status="ok", trace_s=time.perf_counter() - t0,
               collectives=stats.summary(), shard_bytes=shard_bytes,
               pod_permute_bytes=stats.bytes_by_axis.get("pod", 0)
               if stats.bytes_by_kind.get("collective-permute") else 0)
    return rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--dry", action="store_true",
                    help="the reference's lowering: each state's collectives "
                         "on a fake (8, 8, 8) world, no card")
    args = ap.parse_args(argv)
    if args.dry:
        for name, left, right in STATES:
            print(json.dumps(dry_state(name, ARCH, left, right)), flush=True)
        return
    device = resolve_device()
    axis = StackedSilos(N_SILOS)
    for name, left, right in STATES:
        print(json.dumps(run_state(name, ARCH, left, right, axis=axis,
                                   device=device, rounds=args.rounds)),
              flush=True)


if __name__ == "__main__":
    main()
