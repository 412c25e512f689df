"""FL training loop (counterpart of `repro.fl.trainer`, flat runtime).

`run_fl` trains one of the paper's models on synthetic federated data
over any Table-1 topology and pairs the learning curve with the
simulated wall clock of the same `TimingPlan` (paper Fig. 5). The loop
advances a whole cycle of rounds per call of the cycle function and
splits cycles at eval boundaries, so evaluation keeps per-round
granularity.

Ported: the three datasets (femnist, sent140, inat), the five networks,
every topology (star, mst, dmbst, ring, matcha, matcha_plus,
multigraph), explicit multiplicities and silo removal, on the flat
runtime and one device. The legacy runtime, mesh sharding, metrics,
traces and checkpoints raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.delay import WORKLOADS
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.device import pin_fp32, resolve_device
from repro_torch.faults.degrade import removed_network
from repro_torch.fl import dpasgd
from repro_torch.fl import flat as flatmod
from repro_torch.fl import runtime as flrt
from repro_torch.fl.options import RuntimeOptions, adopt_runtime_options
from repro_torch.models.small import SMALL_MODELS, SmallModelSpec
from repro_torch.networks.registry import get_network
from repro_torch.optim import flat_sgd

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
    if cfg.runtime == "legacy":
        raise NotImplementedError("runtime='legacy' is not ported")
    if cfg.runtime != "flat":
        raise ValueError(f"unknown runtime {cfg.runtime!r}")
    for name in ("mesh", "metrics", "trace", "ckpt_dir"):
        if getattr(cfg, name) is not None:
            raise NotImplementedError(f"{name}= is not ported")


def run_fl(cfg: FLConfig, device=None) -> FLResult:
    """Train ``cfg`` on ``device`` (the card unless told otherwise)."""
    return train(cfg, device=device)


def train(cfg: FLConfig, *, device=None,
          aggregator: str = "kernel") -> FLResult:
    """`run_fl` with the aggregation path named: "kernel" (the CUDA
    kernel on a card) or "reference" (its plain version), which is how
    the two are held against each other on the card."""
    _check_ported(cfg)
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
    rt = flrt.make_flat_runtime(plan, params0, n)
    opt = flat_sgd(cfg.lr, momentum=cfg.momentum)
    state = flrt.init_flat_state(flatmod.ravel(rt.spec, params0).to(dev),
                                 opt, rt)
    cycle_fn = flrt.make_cycle_fn(rt, loss_fn=spec.loss, opt=opt,
                                  aggregator=aggregator)
    test_batch = {"x": torch.as_tensor(data.test_x, device=dev),
                  "y": torch.as_tensor(data.test_y, dtype=torch.long,
                                       device=dev)}
    plan_t = {k: torch.as_tensor(getattr(rt, k), device=dev)
              for k in ("strong", "coeffs", "diag")}

    rng = np.random.default_rng(cfg.seed + 1)
    r_cycle = plan.num_rounds_cycle
    round_losses, eval_rounds, eval_accs = [], [], []
    k = 0
    while k < cfg.rounds:
        next_stop = min((k // cfg.eval_every + 1) * cfg.eval_every,
                        cfg.rounds)
        chunk = min(r_cycle, next_stop - k)
        per_round = [_sample_round(data, n, cfg, rng) for _ in range(chunk)]
        batches = {
            "x": torch.as_tensor(np.stack([x for x, _ in per_round]),
                                 device=dev),
            "y": torch.as_tensor(np.stack([y for _, y in per_round]),
                                 dtype=torch.long, device=dev)}
        pks = torch.as_tensor([(k + j) % r_cycle for j in range(chunk)],
                              device=dev)
        state, losses = cycle_fn(state, batches, plan_t["strong"][pks],
                                 plan_t["coeffs"][pks], plan_t["diag"][pks])
        round_losses.extend(losses.tolist())
        k += chunk
        if k % cfg.eval_every == 0 or k == cfg.rounds:
            with torch.no_grad():
                params = flatmod.unravel(rt.spec, state.w.mean(dim=0))
                eval_accs.append(float(spec.accuracy(params, test_batch)))
            eval_rounds.append(k)

    cycle = tplan.cycle_times(cfg.rounds)
    rep = tplan.report(cfg.rounds)
    return FLResult(config=cfg, round_losses=round_losses,
                    eval_rounds=eval_rounds, eval_accs=eval_accs,
                    cycle_times_ms=cycle.tolist(),
                    mean_cycle_ms=rep.mean_cycle_ms,
                    total_time_s=rep.total_time_s)
