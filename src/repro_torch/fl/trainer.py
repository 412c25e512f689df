"""FL training loop (counterpart of `repro.fl.trainer`).

`run_fl` trains one of the paper's models on synthetic federated data
over any Table-1 topology and pairs the learning curve with the
simulated wall clock of the same `TimingPlan` (paper Fig. 5). Two
runtimes share the loop (`FLConfig.runtime`):

  * "flat" (default): the whole-cycle runtime (`fl/runtime.py`), one
    cycle-function call per chunk of rounds, chunks split at eval and
    checkpoint boundaries so both keep per-round granularity. It takes
    the hooks: in-cycle metrics (``metrics=``), a Perfetto trace
    (``trace=``: host spans around dispatch, eval and checkpoint, the
    plan's simulated spans and the metrics as counters) and FL
    checkpoints (``ckpt_dir=``/``ckpt_every``/``ckpt_keep``). With
    ``mesh=`` (`fl/options.py`) the cycle runs sharded over a shard axis
    (`fl/mesh.py`, ``gossip=`` picks its collective): evaluation and
    checkpoints read the gathered single-device rows, so a mesh run
    evaluates and saves what the flat run would;
  * "legacy": one `dpasgd.fl_round_step` a round over per-leaf trees,
    the flat runtime's oracle (bit-equal on the CPU); it takes no hook
    and no mesh, as in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, save_fl_checkpoint
from repro_torch.core.delay import WORKLOADS
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.device import pin_fp32, resolve_device
from repro_torch.faults.degrade import removed_network
from repro_torch.fl import dpasgd
from repro_torch.fl import flat as flatmod
from repro_torch.fl import mesh as flmesh
from repro_torch.fl import runtime as flrt
from repro_torch.fl.options import RuntimeOptions, adopt_runtime_options
from repro_torch.launch.mesh import tree_map
from repro_torch.models.small import SMALL_MODELS, SmallModelSpec
from repro_torch.networks.registry import get_network
from repro_torch.obs import MetricsSpec, TraceRecorder, write_trace
from repro_torch.optim import flat_sgd, sgd

_DATASET_MODEL = {"femnist": "femnist_cnn", "sent140": "sent140_lstm",
                  "inat": "inat_resnet"}
_DATASET_WL = {"femnist": "femnist", "sent140": "sentiment140",
               "inat": "inaturalist"}


@dataclasses.dataclass
class FLConfig:
    """The reference's `FLConfig`, field for field and default for
    default."""

    dataset: str = "femnist"
    network: str = "gaia"
    topology: str = "multigraph"
    t: int = 5
    rounds: int = 200
    local_updates: int = 1
    batch_size: int = 32
    lr: float = 0.05
    momentum: float = 0.0
    seed: int = 0
    eval_every: int = 20
    samples_per_silo: int = 128
    alpha: float = 0.5          # Dirichlet non-IID level
    # Table 4 ablation: remove silos from the RING overlay.
    remove_silos: int = 0
    remove_strategy: str = "none"  # none | random | inefficient
    runtime: str = "flat"
    options: RuntimeOptions | None = None
    mesh: object = None
    gossip: str = "halo"
    metrics: object = None
    trace: str | None = None
    multiplicity: tuple[int, ...] | None = None
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    ckpt_keep: int = 8

    def __post_init__(self):
        adopt_runtime_options(self)


@dataclasses.dataclass
class FLResult:
    config: FLConfig
    round_losses: list[float]
    eval_rounds: list[int]
    eval_accs: list[float]
    cycle_times_ms: list[float]
    mean_cycle_ms: float
    total_time_s: float
    metrics: np.ndarray | None = None
    metric_columns: tuple[str, ...] = ()

    def final_acc(self) -> float:
        return self.eval_accs[-1] if self.eval_accs else float("nan")

    def wallclock_axis_s(self) -> np.ndarray:
        return np.cumsum(self.cycle_times_ms) / 1e3


def _sample_round(data, n: int, cfg: FLConfig, rng) -> tuple[np.ndarray,
                                                             np.ndarray]:
    """One round of micro batches, (u, N, b, ...), drawn in the
    reference's order from the same numpy stream."""
    xs, ys = [], []
    for _ in range(cfg.local_updates):
        per_silo = [data.sample_batch(s, cfg.batch_size, rng)
                    for s in range(n)]
        xs.append(np.stack([b["x"] for b in per_silo]))
        ys.append(np.stack([b["y"] for b in per_silo]))
    return np.stack(xs), np.stack(ys)


def _check_ported(cfg: FLConfig) -> None:
    """The reference's refusals."""
    if (cfg.metrics is not None or cfg.trace) and cfg.runtime != "flat":
        raise ValueError("metrics=/trace= need the flat whole-cycle "
                         "runtime (the legacy path has no in-cycle hook)")
    if cfg.ckpt_dir and cfg.runtime != "flat":
        raise ValueError("ckpt_dir= needs the flat runtime (the flat "
                         "(N, T) rows ARE the checkpoint format)")
    if cfg.runtime not in ("flat", "legacy"):
        raise ValueError(f"unknown runtime {cfg.runtime!r}")
    if cfg.mesh is not None and cfg.runtime == "legacy":
        raise ValueError("mesh= requires runtime='flat'")
    if cfg.metrics is not None and not isinstance(cfg.metrics, MetricsSpec):
        raise TypeError(f"metrics must be an obs.MetricsSpec, got "
                        f"{type(cfg.metrics).__name__}")


def run_fl(cfg: FLConfig, device=None) -> FLResult:
    """Train ``cfg`` on ``device`` (the card unless told otherwise)."""
    return train(cfg, device=device)


def train(cfg: FLConfig, *, device=None,
          aggregator: str = "kernel") -> FLResult:
    """`run_fl` with the flat runtime's aggregation path named: "kernel"
    (the CUDA kernel on a card), "reference" (its plain version) or
    "dense" (uniform in-degree overlays), which is how the paths are held
    against each other on the card. The legacy runtime aggregates leaf by
    leaf with the plain ordered sum and takes only the default."""
    _check_ported(cfg)
    if cfg.runtime == "legacy" and aggregator != "kernel":
        raise ValueError("aggregator= picks the flat runtime's aggregation; "
                         "the legacy runtime aggregates leaf by leaf")
    dev = resolve_device(device)
    pin_fp32(dev)
    wl = WORKLOADS[_DATASET_WL[cfg.dataset]]
    net = get_network(cfg.network)
    if cfg.remove_strategy != "none" and cfg.remove_silos > 0:
        # Table 4 ablation: train and time the network without k silos.
        net, _ = removed_network(net, wl, k=cfg.remove_silos,
                                 strategy=cfg.remove_strategy, seed=cfg.seed)
    n = net.num_silos
    spec: SmallModelSpec = SMALL_MODELS[_DATASET_MODEL[cfg.dataset]]
    data = make_federated_dataset(cfg.dataset, n,
                                  samples_per_silo=cfg.samples_per_silo,
                                  alpha=cfg.alpha, seed=cfg.seed)

    # One schedule, two views: the RoundPlan drives training, the
    # TimingPlan it was built from drives the wall-clock axis.
    plan, tplan = dpasgd.make_round_schedule(cfg.topology, net, wl, t=cfg.t,
                                             rounds=cfg.rounds, seed=cfg.seed,
                                             multiplicity=cfg.multiplicity)
    params0 = spec.init(torch.Generator().manual_seed(cfg.seed))
    test_batch = {"x": torch.as_tensor(data.test_x, device=dev),
                  "y": torch.as_tensor(data.test_y, dtype=torch.long,
                                       device=dev)}

    def accuracy(params) -> float:
        with torch.no_grad():
            return float(spec.accuracy(params, test_batch))

    rng = np.random.default_rng(cfg.seed + 1)
    if cfg.runtime == "legacy":
        round_losses, eval_rounds, eval_accs = _train_legacy(
            cfg, plan, spec, params0, data, n, rng, dev, accuracy)
        metrics, metric_cols = None, ()
    else:
        round_losses, eval_rounds, eval_accs, metrics, metric_cols = \
            _train_flat(cfg, plan, tplan, spec, params0, data, n, rng, dev,
                        accuracy, aggregator)

    # One TimingPlan, one report: the per-round axis and the scalar totals.
    cycle = tplan.cycle_times(cfg.rounds)
    rep = tplan.report(cfg.rounds)
    return FLResult(config=cfg, round_losses=round_losses,
                    eval_rounds=eval_rounds, eval_accs=eval_accs,
                    cycle_times_ms=cycle.tolist(),
                    mean_cycle_ms=rep.mean_cycle_ms,
                    total_time_s=rep.total_time_s,
                    metrics=metrics, metric_columns=tuple(metric_cols))


def _train_flat(cfg, plan, tplan, spec, params0, data, n, rng, dev,
                accuracy, aggregator):
    """The flat whole-cycle runtime: one cycle-function call per chunk of
    rounds, chunks split at eval and checkpoint boundaries; then the
    trace, if asked for: host spans, the plan's simulated spans and the
    metrics as counters at each round's simulated start. Under ``mesh=``
    every process of a group trains its shards, and the root writes the
    files."""
    rt = flrt.make_flat_runtime(plan, params0, n)
    opt = flat_sgd(cfg.lr, momentum=cfg.momentum)
    w0 = flatmod.ravel(rt.spec, params0).to(dev)
    if cfg.mesh is not None:
        mrt = flmesh.make_mesh_runtime(rt, cfg.mesh, device=dev)
        state = flmesh.init_mesh_state(w0, opt, mrt)
        cycle_fn = flrt.make_cycle_fn(mrt, loss_fn=spec.loss, opt=opt,
                                      aggregator=aggregator,
                                      gossip=cfg.gossip, metrics=cfg.metrics)
        # the single-device rows: pad rows and the block-padded edge
        # layout never reach evaluation or a checkpoint
        rows = lambda st: flmesh.gather_flat_state(mrt, st).w
        root = mrt.axis.root
    else:
        state = flrt.init_flat_state(w0, opt, rt)
        cycle_fn = flrt.make_cycle_fn(rt, loss_fn=spec.loss, opt=opt,
                                      aggregator=aggregator,
                                      metrics=cfg.metrics)
        rows = lambda st: st.w
        root = True
    plan_t = {k: torch.as_tensor(getattr(rt, k), device=dev)
              for k in ("strong", "coeffs", "diag")}

    recorder = None
    if cfg.trace and root:
        recorder = TraceRecorder()
        recorder.meta.update(dataset=cfg.dataset, network=cfg.network,
                             topology=cfg.topology, rounds=cfg.rounds,
                             seed=cfg.seed)

    def span(name, **args):
        if recorder is None:
            return contextlib.nullcontext()
        return recorder.host_span(name, **args)

    round_losses, eval_rounds, eval_accs = [], [], []
    metrics_chunks: list[np.ndarray] = []
    cum_ms = np.cumsum(tplan.cycle_times(cfg.rounds))  # simulated clock
    ckpt_mgr = None
    if cfg.ckpt_dir:
        ckpt_mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)

        def emit_ckpt(k, state):
            w = rows(state)  # a collective under a group: every rank
            if not root:
                return
            save_fl_checkpoint(
                ckpt_mgr, k, w,
                round=k, network=cfg.network, dataset=cfg.dataset,
                topology=cfg.topology, t=cfg.t, seed=cfg.seed,
                num_silos=n, multiplicity=cfg.multiplicity,
                lr=cfg.lr, momentum=cfg.momentum, alpha=cfg.alpha,
                sim_time_ms=float(cum_ms[k - 1]) if k else 0.0,
                loss_tail=[float(x) for x in round_losses[-8:]],
                eval_accs=[float(x) for x in eval_accs[-4:]])

    r_cycle = plan.num_rounds_cycle
    k = 0
    while k < cfg.rounds:
        next_stop = min((k // cfg.eval_every + 1) * cfg.eval_every,
                        cfg.rounds)
        if ckpt_mgr is not None and cfg.ckpt_every > 0:
            next_stop = min(next_stop,
                            (k // cfg.ckpt_every + 1) * cfg.ckpt_every)
        chunk = min(r_cycle, next_stop - k)
        per_round = [_sample_round(data, n, cfg, rng) for _ in range(chunk)]
        batches = {
            "x": torch.as_tensor(np.stack([x for x, _ in per_round]),
                                 device=dev),
            "y": torch.as_tensor(np.stack([y for _, y in per_round]),
                                 dtype=torch.long, device=dev)}
        pks = torch.as_tensor([(k + j) % r_cycle for j in range(chunk)],
                              device=dev)
        # The first chunk also builds the CUDA extension on first use.
        with span("compile+dispatch" if k == 0 else "dispatch",
                  start_round=k, rounds=chunk):
            out = cycle_fn(state, batches, plan_t["strong"][pks],
                           plan_t["coeffs"][pks], plan_t["diag"][pks])
            state, losses = out[:2]
            if cfg.metrics is not None:
                metrics_chunks.append(out[2].cpu().numpy())
            losses = losses.tolist()
        round_losses.extend(losses)
        k += chunk
        if k % cfg.eval_every == 0 or k == cfg.rounds:
            with span("eval", round=k):
                eval_accs.append(accuracy(
                    flatmod.unravel(rt.spec, rows(state).mean(dim=0))))
            eval_rounds.append(k)
        if ckpt_mgr is not None and (
                k == cfg.rounds or
                (cfg.ckpt_every > 0 and k % cfg.ckpt_every == 0)):
            with span("checkpoint", round=k):
                emit_ckpt(k, state)
    metrics, cols = None, ()
    if cfg.metrics is not None:
        metrics, cols = np.concatenate(metrics_chunks), cycle_fn.metric_columns
    if recorder is not None:
        recorder.add_sim_spans(tplan, cfg.rounds)
        if metrics is not None:
            recorder.add_metrics(metrics, cols,
                                 np.concatenate([[0.0], cum_ms[:-1]]))
        write_trace(cfg.trace, recorder)
    return round_losses, eval_rounds, eval_accs, metrics, cols


def _train_legacy(cfg, plan, spec, params0, data, n, rng, dev, accuracy):
    """The legacy per-round runtime: one `fl_round_step` a round over
    per-leaf stacked trees (the flat runtime's oracle)."""
    opt = sgd(cfg.lr, momentum=cfg.momentum)
    params0 = tree_map(lambda x: x.to(dev), params0)
    state = dpasgd.init_fl_state(params0, opt, n, plan.src)
    plan_t = {k: torch.as_tensor(np.ascontiguousarray(getattr(plan, k)),
                                 device=dev)
              for k in ("strong", "coeffs", "diag")}
    r_cycle = plan.num_rounds_cycle
    round_losses, eval_rounds, eval_accs = [], [], []
    for k in range(cfg.rounds):
        xs, ys = _sample_round(data, n, cfg, rng)
        batches = {"x": torch.as_tensor(xs, device=dev),
                   "y": torch.as_tensor(ys, dtype=torch.long, device=dev)}
        pk = k % r_cycle
        state, loss = dpasgd.fl_round_step(
            state, batches, plan.src, plan.dst, plan_t["strong"][pk],
            plan_t["coeffs"][pk], plan_t["diag"][pk], loss_fn=spec.loss,
            opt=opt, local_updates=cfg.local_updates)
        round_losses.append(float(loss))
        if (k + 1) % cfg.eval_every == 0 or k == cfg.rounds - 1:
            eval_accs.append(accuracy(tree_map(
                lambda x: x.mean(dim=0), state.silo_params)))
            eval_rounds.append(k + 1)
    return round_losses, eval_rounds, eval_accs
