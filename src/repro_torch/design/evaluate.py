"""Time-to-accuracy evaluation of topology designs (counterpart of
`repro.design.evaluate`, DESIGN.md §13).

The paper's objective is wall-clock training time, not cycle time: a
design that shaves the mean Eq. 4/5 cycle but starves communication can
converge SLOWER per second (Marfoq et al., Throughput-Optimal Topology
Design for Cross-Silo FL — the throughput/convergence trade-off cannot
be read off the communication schedule alone). This module closes the
loop: a candidate multiplicity vector is trained end-to-end with
`fl/trainer.run_fl` (the flat whole-cycle runtime, whose aggregation is
the `edge_aggregate` kernel on the card) and scored by the simulated
wall-clock seconds its loss curve needs to reach a target, where the
wall-clock axis is the SAME TimingPlan cycle times the cycle-time
search scored it with.

Protocol (deterministic, so a design search can assert that a searched
design matches or beats Algorithm 1):

* every candidate trains with an identical `FLConfig` apart from the
  multiplicity vector — same seed, same data stream, same round count —
  so loss curves differ only through the communication schedule;
* the target loss defaults to the REFERENCE design's final smoothed
  loss, which the reference reaches by construction (finite TTA);
* time-to-target is the cumulative cycle time through the first round
  whose trailing-mean loss is at or below the target (`inf` if never
  reached — such a candidate loses to the reference, never to a crash).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core.delay import WORKLOADS
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.device import pin_fp32, resolve_device
from repro_torch.fl import dpasgd
from repro_torch.fl import flat as flatmod
from repro_torch.fl import runtime as flrt
from repro_torch.fl.trainer import (FLConfig, _DATASET_MODEL, _sample_round,
                                    run_fl)
from repro_torch.models.small import SMALL_MODELS
from repro_torch.networks.registry import get_network
from repro_torch.optim import flat_sgd

#: workload name (core/delay.WORKLOADS) -> trainer dataset name
WL_TO_DATASET = {"femnist": "femnist", "sentiment140": "sent140",
                 "inaturalist": "inat"}

#: trailing-mean window for the loss curve; per-round DPASGD losses are
#: minibatch-noisy, a raw first-crossing would reward lucky batches.
TTA_WINDOW = 5


def smoothed_losses(losses, window: int = TTA_WINDOW) -> np.ndarray:
    """Trailing mean over ``window`` rounds (shorter at the start)."""
    x = np.asarray(losses, np.float64)
    if x.size == 0:
        return x
    c = np.concatenate([[0.0], np.cumsum(x)])
    k = np.arange(1, x.size + 1)
    lo = np.maximum(k - window, 0)
    return (c[k] - c[lo]) / (k - lo)


def time_to_target(losses, cycle_times_ms, target: float,
                   window: int = TTA_WINDOW) -> tuple[int, float]:
    """(round, seconds) of the first trailing-mean loss <= ``target``.

    ``round`` is the 0-based round index whose smoothed loss first
    crosses the target; the time is the cumulative cycle time THROUGH
    that round (you pay for the round that gets you there). Returns
    ``(-1, inf)`` if the curve never reaches the target.
    """
    s = smoothed_losses(losses, window)
    hit = np.flatnonzero(s <= target)
    if hit.size == 0:
        return -1, math.inf
    k = int(hit[0])
    return k, float(np.sum(np.asarray(cycle_times_ms[:k + 1]))) / 1e3


@dataclasses.dataclass(frozen=True)
class TTAResult:
    """One trained candidate on the time-to-accuracy axis."""

    name: str
    network: str
    dataset: str
    rounds: int
    target_loss: float
    reached_round: int      # -1 if the target was never reached
    tta_s: float            # inf if never reached
    final_loss: float       # trailing-mean loss at the last round
    final_acc: float
    mean_cycle_ms: float
    total_time_s: float     # simulated wall clock of the whole run
    train_s: float          # host seconds spent actually training
    # Mean strong-pair density of the trained vector (mean(1/m_e)): on a
    # frontier each candidate sits at its own density, and this field
    # makes the trade-off readable straight off the result rows.
    density: float = 0.0

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d["tta_s"] = None if math.isinf(self.tta_s) else round(self.tta_s, 6)
        return d


def evaluate_frontier(network: str, workload: str, named_vectors, *,
                      rounds: int = 60, window: int = TTA_WINDOW,
                      lr: float = 0.05, batch_size: int = 16,
                      samples_per_silo: int = 64, local_updates: int = 1,
                      seed: int = 0, recorder=None,
                      device=None) -> list[TTAResult]:
    """Train a FRONTIER of multiplicity vectors with one cycle function.

    ``named_vectors`` is ``[(name, vector), ...]``; the FIRST entry is
    the reference whose final smoothed loss becomes every candidate's
    target. All vectors live over the same Christofides overlay, so
    their RoundPlans share the directed-edge structure (src/dst/CSR) and
    differ only in the per-round strong/coeffs/diag values, which are
    arguments of the flat whole-cycle function. So one cycle function is
    built, from the first runtime, and every candidate runs through it:
    one call of all ``rounds`` each. Vectors that disagree on the edge
    structure raise `ValueError`. Each candidate starts from the row
    `run_fl` starts from for the same `FLConfig` and draws the same
    data stream (a fresh ``default_rng(seed + 1)``, `run_fl`'s order),
    so candidate k's losses are those of
    ``run_fl(FLConfig(multiplicity=vector_k, ...))`` bit for bit on one
    device.

    ``recorder`` — an `obs.TraceRecorder`: one host wall-clock span per
    candidate around its cycle call (the first includes building the
    CUDA extension on first use). ``device`` — the card unless the
    caller names another.
    """
    dev = resolve_device(device)
    pin_fp32(dev)
    net = get_network(network)
    wl = WORKLOADS[workload]
    dataset = WL_TO_DATASET.get(workload, workload)
    n = net.num_silos
    spec = SMALL_MODELS[_DATASET_MODEL[dataset]]
    cfg = FLConfig(dataset=dataset, network=network, topology="multigraph",
                   rounds=rounds, eval_every=rounds, lr=lr,
                   batch_size=batch_size, samples_per_silo=samples_per_silo,
                   local_updates=local_updates, seed=seed)
    data = make_federated_dataset(dataset, n,
                                  samples_per_silo=samples_per_silo,
                                  alpha=cfg.alpha, seed=seed)
    opt = flat_sgd(lr, momentum=cfg.momentum)
    params0 = spec.init(torch.Generator().manual_seed(seed))
    test_batch = {"x": torch.as_tensor(data.test_x, device=dev),
                  "y": torch.as_tensor(data.test_y, dtype=torch.long,
                                       device=dev)}

    schedules = [dpasgd.make_round_schedule("multigraph", net, wl,
                                            multiplicity=vec)
                 for _, vec in named_vectors]
    runtimes = [flrt.make_flat_runtime(plan, params0, n)
                for plan, _ in schedules]
    if not runtimes:
        return []
    rt0 = runtimes[0]
    for rt in runtimes[1:]:
        # One cycle function needs one edge structure. All vectors
        # address the same overlay, so this fires only on vectors from
        # different overlays.
        if not (np.array_equal(rt.src_sorted, rt0.src_sorted)
                and np.array_equal(rt.row_ptr, rt0.row_ptr)):
            raise ValueError("frontier vectors disagree on the overlay "
                             "edge structure; cannot share a cycle "
                             "function")
    cycle_fn = flrt.make_cycle_fn(rt0, loss_fn=spec.loss, opt=opt)
    w0 = flatmod.ravel(rt0.spec, params0).to(dev)

    out: list[TTAResult] = []
    target: float | None = None
    for (name, vec), (_, tplan), rt in zip(named_vectors, schedules,
                                           runtimes):
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed + 1)
        per_round = [_sample_round(data, n, cfg, rng)
                     for _ in range(rounds)]
        batches = {
            "x": torch.as_tensor(np.stack([x for x, _ in per_round]),
                                 device=dev),
            "y": torch.as_tensor(np.stack([y for _, y in per_round]),
                                 dtype=torch.long, device=dev)}
        pks = torch.as_tensor([j % rt.num_rounds_cycle
                               for j in range(rounds)], device=dev)
        plan_t = [torch.as_tensor(getattr(rt, k), device=dev)[pks]
                  for k in ("strong", "coeffs", "diag")]
        state = flrt.init_flat_state(w0, opt, rt)
        if recorder is not None:
            span = recorder.host_span(
                "compile+dispatch" if not out else "dispatch",
                candidate=name, rounds=rounds)
        else:
            span = contextlib.nullcontext()
        with span:
            state, losses = cycle_fn(state, batches, *plan_t)
            losses = losses.tolist()
        with torch.no_grad():
            acc = float(spec.accuracy(
                flatmod.unravel(rt.spec, state.w.mean(dim=0)), test_batch))
        train_s = time.perf_counter() - t0
        cycle_ms = tplan.cycle_times(rounds)
        rep = tplan.report(rounds)
        smooth = smoothed_losses(losses, window)
        final_loss = float(smooth[-1])
        if target is None:            # first entry sets the bar
            target = final_loss
        k, tta_s = time_to_target(losses, cycle_ms, target, window)
        out.append(TTAResult(
            name=name, network=network, dataset=dataset, rounds=rounds,
            target_loss=target, reached_round=k, tta_s=tta_s,
            final_loss=final_loss, final_acc=acc,
            mean_cycle_ms=rep.mean_cycle_ms,
            total_time_s=rep.total_time_s, train_s=train_s,
            density=float(np.mean(1.0 / np.asarray(vec, np.float64)))))
    return out


def evaluate_design(network: str, workload: str, *,
                    multiplicity=None, t: int = 5,
                    name: str = "multigraph",
                    rounds: int = 60, target_loss: float | None = None,
                    window: int = TTA_WINDOW,
                    lr: float = 0.05, batch_size: int = 16,
                    samples_per_silo: int = 64, local_updates: int = 1,
                    seed: int = 0, device=None) -> TTAResult:
    """Train one multigraph design with `run_fl` and score its
    time-to-accuracy.

    ``multiplicity=None`` trains Algorithm 1's hand-built design at
    ``t`` (the reference); a vector trains the searched schedule through
    the same `timing.multiplicity_vector_plan` constructor a search
    scores it with. ``target_loss=None`` targets the run's OWN final
    smoothed loss — use that for the reference, then feed its
    ``target_loss`` to every candidate so all TTAs share one bar.
    ``device`` — the card unless the caller names another.
    """
    dataset = WL_TO_DATASET.get(workload, workload)
    cfg = FLConfig(dataset=dataset, network=network, topology="multigraph",
                   t=t, rounds=rounds, eval_every=rounds, lr=lr,
                   batch_size=batch_size, samples_per_silo=samples_per_silo,
                   local_updates=local_updates, seed=seed,
                   multiplicity=(None if multiplicity is None
                                 else tuple(int(m) for m in multiplicity)))
    t0 = time.perf_counter()
    res = run_fl(cfg, device=device)
    train_s = time.perf_counter() - t0
    smooth = smoothed_losses(res.round_losses, window)
    final_loss = float(smooth[-1])
    if target_loss is None:
        target_loss = final_loss
    k, tta_s = time_to_target(res.round_losses, res.cycle_times_ms,
                              target_loss, window)
    return TTAResult(name=name, network=network, dataset=dataset,
                     rounds=rounds, target_loss=float(target_loss),
                     reached_round=k, tta_s=tta_s, final_loss=final_loss,
                     final_acc=res.final_acc(),
                     mean_cycle_ms=res.mean_cycle_ms,
                     total_time_s=res.total_time_s, train_s=train_s,
                     density=(0.0 if multiplicity is None else float(
                         np.mean(1.0 / np.asarray(multiplicity,
                                                  np.float64)))))
