"""Federated training of the LLM architectures, reduced (counterpart of
`repro.launch.train`).

N silos federally train a REDUCED variant of any architecture
(`configs.reduce`: 2 layers, d_model <= 256, fp32) on synthetic per-silo
LM streams, under any Table-1 topology: DPASGD local steps
(`sgd(lr, momentum=0.9)`), the multigraph state schedule and stale
weak-edge buffers through `fl/dpasgd.fl_round_step`, whose aggregation
runs every leaf through `edge_aggregate` (the CUDA kernel on the card),
plus the cycle-time simulator for the wall-clock axis. The round draws
and the LM data are the reference's numpy streams. Initial parameters
come from `transformer.init_params` with a `torch.Generator` seeded by
``seed`` on the run's device (torch cannot draw the reference's
`jax.random` stream); every silo starts from them.

With ``mesh=`` (an int D, "auto" or a shard axis, `fl/options.py`) the
silos train on the whole-cycle flat runtime sharded over a shard axis
(`fl/mesh.py`, `flat_sgd(lr, momentum=0.9)`), as the reference's mesh
branch does; ``lora_rank > 0`` (mesh only) trains LoRA deltas
(`fl/lora.py`) over a frozen base that `fl/lora.lora_base` draws from
a CPU generator seeded ``seed + 1``, and its checkpoints record that draw as
``base_init="torch-cpu"`` so that the serving fleet rebuilds the base.
Both write FL checkpoints, traces and the simulated axis as the legacy
path does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --silos 6 --rounds 30 --topology multigraph [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, save_fl_checkpoint
from repro_torch.configs import get_config, reduce as reduce_cfg
from repro_torch.core.delay import FEMNIST, WORKLOADS
from repro_torch.core.simulator import simulate
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.device import pin_fp32, resolve_device
from repro_torch.fl import dpasgd
from repro_torch.fl import flat as flatmod
from repro_torch.fl import mesh as flmesh
from repro_torch.fl import runtime as flrt
from repro_torch.fl.lora import BASE_INIT, lora_base, make_lora_adapter
from repro_torch.fl.options import RuntimeOptions, adopt_runtime_options
from repro_torch.launch.mesh import shard_axis, tree_bytes
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import synthetic_prefix
from repro_torch.networks.registry import get_network
from repro_torch.networks.zoo import NetworkSpec
from repro_torch.obs import TraceRecorder, write_trace
from repro_torch.optim import flat_sgd, sgd


def _sub_network(net: NetworkSpec, n: int) -> NetworkSpec:
    keep = np.arange(min(n, net.num_silos))
    return NetworkSpec(name=f"{net.name}[{n}]",
                       silos=tuple(net.silos[i] for i in keep),
                       latency_ms=net.latency_ms[np.ix_(keep, keep)])


@dataclasses.dataclass
class TrainConfig:
    """The reference's `TrainConfig`, field for field and default for
    default."""

    arch: str = "mamba2-370m"
    topology: str = "multigraph"
    network: str = "gaia"
    silos: int = 4
    rounds: int = 30
    t: int = 5
    seq_len: int = 32
    batch_size: int = 4
    lr: float = 3e-3
    seed: int = 0
    reduced: bool = True
    options: RuntimeOptions | None = None
    mesh: object = None
    gossip: str = "halo"
    metrics: object = None
    trace: str | None = None
    lora_rank: int = 0
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    ckpt_keep: int = 8

    def __post_init__(self):
        adopt_runtime_options(self)
        if self.metrics is not None:
            raise ValueError("TrainConfig does not thread in-scan "
                             "metrics; use FLConfig(metrics=...)")


def initial_params(mcfg: ModelConfig, seed: int, device) -> dict:
    """Every silo's starting parameters: `init_params` from a generator
    seeded with ``seed`` on ``device``."""
    return tf.init_params(
        mcfg, torch.Generator(device=device).manual_seed(seed), device=device)


def run_reduced_fl(cfg: TrainConfig, device=None) -> dict:
    """Train, and return the reference's output dict: arch, topology,
    silos, loss_first, loss_last, losses (one a round, the mean over
    silos), train_seconds, the simulated sim_mean_cycle_ms and
    sim_total_time_s, and ckpt_dir/ckpt_steps and trace when asked for.
    Runs on the card unless ``device`` names another, in full fp32 there
    (`pin_fp32`, as `run_fl`). Under a process group (``mesh="auto"``)
    every rank trains its shards and only the root writes checkpoints and
    the trace, and returns their keys."""
    if cfg.mesh is None and cfg.lora_rank:
        raise ValueError("lora_rank requires the mesh runtime "
                         "(set mesh=, e.g. mesh='auto')")
    device = resolve_device(device)
    pin_fp32(device)
    mcfg = reduce_cfg(get_config(cfg.arch))
    net = _sub_network(get_network(cfg.network), cfg.silos)
    n = net.num_silos
    wl = WORKLOADS["femnist"]

    plan, tplan = dpasgd.make_round_schedule(cfg.topology, net, wl, t=cfg.t,
                                             rounds=cfg.rounds, seed=cfg.seed)
    # under a process group every rank trains its shards and the root
    # alone writes the trace and the checkpoints
    axis = None if cfg.mesh is None else shard_axis(cfg.mesh, device)
    root = axis is None or axis.root
    recorder = None
    if cfg.trace and root:
        recorder = TraceRecorder()
        recorder.meta.update(arch=cfg.arch, topology=cfg.topology,
                             network=net.name, rounds=cfg.rounds,
                             seed=cfg.seed)

    def span(name, **args):
        if recorder is None:
            return contextlib.nullcontext()
        return recorder.host_span(name, **args)

    data = make_lm_dataset(mcfg.vocab_size, cfg.seq_len, n,
                           samples_per_silo=64, seed=cfg.seed)
    prefix = None
    if mcfg.frontend != "none":
        prefix = torch.stack([synthetic_prefix(mcfg, cfg.batch_size, seed=s,
                                               device=device)
                              for s in range(n)])[None]  # (1, N, B, P, D)

    def loss_fn(p, batch):
        loss, _ = tf.loss_fn(p, mcfg, batch)
        return loss

    rng = np.random.default_rng(cfg.seed)

    def draw_round():
        return np.stack([
            data[s][rng.integers(0, len(data[s]), cfg.batch_size)]
            for s in range(n)])  # (N, B, S+1)

    losses: list[float] = []
    t0 = time.time()
    ckpt_mgr = None
    if cfg.ckpt_dir:
        if root:
            ckpt_mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
        ckpt_cum_ms = np.cumsum(tplan.cycle_times(cfg.rounds))

    def emit_ckpt(k, rows):
        """Save the (N, T) flat rows: the LoRA delta rows when lora_rank >
        0, whose base `lora_base` rebuilds (``base_init``)."""
        kind = dict(params_kind="lora_delta", base_init=BASE_INIT) \
            if cfg.lora_rank else dict(params_kind="full")
        with span("checkpoint", round=k):
            save_fl_checkpoint(
                ckpt_mgr, k, rows,
                round=k, arch=cfg.arch, network=cfg.network,
                dataset="synthetic-lm", workload="femnist",
                topology=cfg.topology, t=cfg.t, seed=cfg.seed,
                num_silos=n, lora_rank=cfg.lora_rank, **kind,
                seq_len=cfg.seq_len, lr=cfg.lr,
                sim_time_ms=float(ckpt_cum_ms[k - 1]) if k else 0.0,
                loss_tail=[float(x) for x in losses[-8:]])

    def due(k):
        return bool(cfg.ckpt_dir) and (
            k == cfg.rounds
            or (cfg.ckpt_every > 0 and k % cfg.ckpt_every == 0))

    r_cycle = plan.num_rounds_cycle
    if cfg.mesh is not None:
        # the mesh-sharded whole-cycle flat runtime; with lora_rank > 0
        # the trainable per-silo state is the LoRA delta over a frozen
        # base shared by every silo (fl/lora.py)
        cycle_loss = loss_fn
        if cfg.lora_rank > 0:
            adapter = make_lora_adapter(lora_base(mcfg, cfg.seed, device),
                                        cfg.lora_rank)
            params0 = adapter.init(torch.Generator().manual_seed(cfg.seed))
            cycle_loss = adapter.wrap_loss(loss_fn)
        else:
            params0 = initial_params(mcfg, cfg.seed, device)
        opt = flat_sgd(cfg.lr, momentum=0.9)
        rt = flrt.make_flat_runtime(plan, params0, n)
        mrt = flmesh.make_mesh_runtime(rt, axis, device=device)
        state = flmesh.init_mesh_state(flatmod.ravel(rt.spec, params0), opt,
                                       mrt)
        cycle = flrt.make_cycle_fn(mrt, loss_fn=cycle_loss, opt=opt,
                                   gossip=cfg.gossip)
        plan_t = {k: torch.as_tensor(getattr(rt, k), device=device)
                  for k in ("strong", "coeffs", "diag")}
        k = 0
        while k < cfg.rounds:
            chunk = min(r_cycle, cfg.rounds - k)
            if cfg.ckpt_dir and cfg.ckpt_every > 0:
                chunk = min(chunk, (k // cfg.ckpt_every + 1)
                            * cfg.ckpt_every - k)
            toks = torch.as_tensor(
                np.stack([draw_round() for _ in range(chunk)]), device=device)
            batches = {"tokens": toks[:, None, :, :, :-1],
                       "labels": toks[:, None, :, :, 1:]}
            if prefix is not None:
                batches["prefix_embeds"] = prefix[None].expand(
                    (chunk,) + tuple(prefix.shape))
            pks = torch.as_tensor([(k + j) % r_cycle for j in range(chunk)],
                                  device=device)
            with span("compile+dispatch" if k == 0 else "dispatch",
                      start_round=k, rounds=chunk):
                state, chunk_losses = cycle(
                    state, batches, plan_t["strong"][pks],
                    plan_t["coeffs"][pks], plan_t["diag"][pks])
                losses.extend(chunk_losses.tolist())
            k += chunk
            if due(k):
                # the single-device rows: pad rows and the block-padded
                # edge layout never reach the checkpoint
                rows = flmesh.gather_flat_state(mrt, state).w  # every rank
                if root:
                    emit_ckpt(k, rows)
        # bytes a silo communicates per round: the flat row (the LoRA
        # delta when lora_rank > 0, not the frozen base)
        param_bytes = rt.spec.size * 4
    else:
        params0 = initial_params(mcfg, cfg.seed, device)
        opt = sgd(cfg.lr, momentum=0.9)
        state = dpasgd.init_fl_state(params0, opt, n, plan.src)
        plan_t = {k: torch.as_tensor(np.ascontiguousarray(getattr(plan, k)),
                                     device=device)
                  for k in ("strong", "coeffs", "diag")}
        if cfg.ckpt_dir:
            ckpt_spec = flatmod.make_flat_spec(params0)
        for k in range(cfg.rounds):
            toks = torch.as_tensor(draw_round(), device=device)
            batches = {"tokens": toks[None, :, :, :-1],
                       "labels": toks[None, :, :, 1:]}
            if prefix is not None:
                batches["prefix_embeds"] = prefix
            pk = k % r_cycle
            with span("compile+dispatch" if k == 0 else "dispatch",
                      start_round=k, rounds=1):
                state, loss = dpasgd.fl_round_step(
                    state, batches, plan.src, plan.dst,
                    plan_t["strong"][pk], plan_t["coeffs"][pk],
                    plan_t["diag"][pk], loss_fn=loss_fn, opt=opt,
                    local_updates=1)
                loss = float(loss)
            losses.append(loss)
            if due(k + 1):
                emit_ckpt(k + 1, flatmod.ravel_stacked(ckpt_spec,
                                                       state.silo_params))
        param_bytes = tree_bytes(state.silo_params) / n

    # simulated wall-clock (model-size-aware workload)
    wl_model = dataclasses.replace(
        FEMNIST, name=cfg.arch, model_size_mbits=param_bytes * 8 / 1e6)
    sim = simulate(cfg.topology, net, wl_model, num_rounds=cfg.rounds, **(
        {"t": cfg.t} if cfg.topology == "multigraph" else {}))
    out = {
        "arch": cfg.arch, "topology": cfg.topology, "silos": n,
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": losses,
        "train_seconds": round(time.time() - t0, 1),
        "sim_mean_cycle_ms": sim.mean_cycle_ms,
        "sim_total_time_s": sim.total_time_s,
    }
    if ckpt_mgr is not None:
        out["ckpt_dir"] = str(ckpt_mgr.dir)
        out["ckpt_steps"] = ckpt_mgr.steps()
    if recorder is not None:
        recorder.add_sim_spans(tplan, cfg.rounds)
        write_trace(cfg.trace, recorder)
        out["trace"] = cfg.trace
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--topology", default="multigraph")
    ap.add_argument("--network", default="gaia")
    ap.add_argument("--silos", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--t", type=int, default=5)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default=None,
                    help="silo shards: an int, 'auto', or unset for the "
                         "legacy per-round runtime")
    ap.add_argument("--lora-rank", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="emit FL checkpoints (per-silo flat rows + "
                         "metadata) into this directory")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every K rounds (0 = only at the end)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Perfetto trace-event JSON of the run "
                         "(open at ui.perfetto.dev)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="dotted config override (repeatable), e.g. "
                         "--set seed=3 --set batch_size=8")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)
    from repro_torch.config_cli import apply_overrides
    mesh = args.mesh
    if mesh is not None and mesh != "auto":
        mesh = int(mesh)
    cfg = TrainConfig(
        arch=args.arch, topology=args.topology, network=args.network,
        silos=args.silos, rounds=args.rounds, t=args.t,
        seq_len=args.seq_len, batch_size=args.batch_size, lr=args.lr,
        mesh=mesh, lora_rank=args.lora_rank, trace=args.trace,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    out = run_reduced_fl(apply_overrides(cfg, args.overrides),
                         device=args.device)
    out.pop("losses")
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
