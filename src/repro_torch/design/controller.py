"""Self-healing topology controller (counterpart of
`repro.design.controller`, DESIGN.md §14).

Train under a fault scenario (`faults`), watch the observed per-pair
delays, and when they deviate from what the current schedule was planned
for, re-run the batched multiplicity search on the OBSERVED window and
swap the schedule live.

The swap changes arguments, never structure. Every candidate vector
lives over the same Christofides overlay, so every RoundPlan shares the
directed edge structure (src/dst/CSR), and the flat whole-cycle function
takes strong/coeffs/diag as arguments. So one cycle function, built once
per harness, runs every (scenario, policy) run and every swapped
schedule; `_runtime_for` asserts the shared CSR structure. The
reference counts `jax.jit` traces (`trace_count`,
`assert_single_trace`); eager PyTorch has no trace, so those would be a
counter that is always 1 and are left out. The tests count
`make_cycle_fn` builds instead.

Under the nominal scenario the observed window equals the nominal
delays bit for bit, the deviation is exactly zero, the controller never
swaps, and the adaptive run is bit-exact with the static one. The swap
sequence is decided in numpy on simulated time, so it is the
reference's exactly; training runs on the card unless the harness is
given another device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import timing
from repro_torch.core.delay import WORKLOADS
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.design import evaluate as eval_mod
from repro_torch.design.catalog import ring_topology
from repro_torch.design.search import (evolve_population, hill_climb,
                                       make_scorer, strong_fraction)
from repro_torch.device import pin_fp32, resolve_device
from repro_torch.faults import (DegradePolicy, FaultedSession, Scenario,
                                get_scenario)
from repro_torch.fl import dpasgd
from repro_torch.fl import flat as flatmod
from repro_torch.fl import mesh as flmesh
from repro_torch.fl import runtime as flrt
from repro_torch.fl.options import RuntimeOptions, adopt_runtime_options
from repro_torch.fl.trainer import FLConfig, _DATASET_MODEL, _sample_round
from repro_torch.models.small import SMALL_MODELS
from repro_torch.networks.registry import get_network
from repro_torch.obs import TraceRecorder, write_trace
from repro_torch.optim import flat_sgd


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """One scenario-matrix experiment (shared by every run of a harness)."""

    network: str = "gaia"
    workload: str = "femnist"
    rounds: int = 48
    replan_every: int = 12   # segment length; must divide rounds
    t: int = 5               # Algorithm 1 multiplicity cap (initial plan)
    t_max: int = 8           # search space cap for re-planning: a faulted
    #                          pair's observed delay can warrant a larger
    #                          multiplicity than the nominal cap allows
    density_slack: float = 0.8  # floor = slack * strong_fraction(vec0);
    #                          slack < 1 admits single +1 hill-climb moves
    #                          (each strictly lowers the strong fraction)
    #                          while still bounding how much communication
    #                          a re-plan may shed
    lr: float = 0.05
    batch_size: int = 16
    samples_per_silo: int = 64
    local_updates: int = 1
    seed: int = 0
    replan_threshold: float = 0.05  # max relative pair-delay deviation
    replan_iters: int = 4           # hill-climb steps per re-plan
    # Re-planning runs the same population engine as the offline search
    # (design/search.py): hill-climb replay seeds the pool, then a few
    # annealed mutate/swap/crossover generations widen it. Segments are
    # short and candidate counts small, so the host grid scores by
    # default; "torch" moves the per-segment search onto the device grid
    # (on the harness's device).
    replan_generations: int = 2
    replan_pop: int = 8
    replan_backend: str = "numpy"
    # Shared runtime knobs (fl/options.py): mesh sharding (fl/mesh.py),
    # its gossip collective, trace. The live-swap contract is unchanged
    # under mesh: swapped schedules are still new arguments to the one
    # cycle function.
    options: RuntimeOptions | None = None
    mesh: object = None
    gossip: str = "halo"
    metrics: object = None
    trace: str | None = None

    def __post_init__(self):
        adopt_runtime_options(self)
        if self.metrics is not None:
            raise ValueError("ControllerConfig does not thread in-cycle "
                             "metrics; use FLConfig(metrics=...) or the "
                             "recorder= argument of ControllerHarness.run")
        if self.rounds % self.replan_every:
            raise ValueError(
                f"replan_every={self.replan_every} must divide "
                f"rounds={self.rounds}: every segment runs the same "
                "number of rounds through the one cycle function")


@dataclasses.dataclass(frozen=True)
class ControlledRun:
    """One trained run of the harness under (scenario, policy)."""

    scenario: str
    adaptive: bool
    losses: np.ndarray          # (R,) f64 per-round mean training loss
    cycle_times_ms: np.ndarray  # (R,) f64 realized (faulted) cycle times
    swap_rounds: tuple[int, ...]   # global rounds where a swap happened
    vectors: tuple[tuple[int, ...], ...]  # schedule history, initial first
    demoted_rounds: int         # pair-rounds demoted planned-strong -> weak
    final_acc: float

    @property
    def total_time_s(self) -> float:
        return float(self.cycle_times_ms.sum()) / 1e3

    def tta_s(self, target: float,
              window: int = eval_mod.TTA_WINDOW) -> float:
        return eval_mod.time_to_target(self.losses, self.cycle_times_ms,
                                       target, window)[1]


def _alg1_vector(est: np.ndarray, t_max: int) -> tuple[int, ...]:
    """Algorithm 1 on OBSERVED pair delays (same rounding as
    `core/multigraph.build_multigraph`, which only speaks nominal)."""
    d_min = float(est.min())
    if d_min <= 0.0:
        return (1,) * len(est)
    return tuple(max(1, int(min(t_max, int(np.round(d / d_min)))))
                 for d in est.tolist())


class ControllerHarness:
    """Build the expensive parts once, run the whole scenario matrix.

    One network + workload + data stream + cycle function shared across
    every `(scenario, adaptive)` run: runs are comparable (identical
    batches, identical initial row). ``device`` is where training runs:
    the card unless the caller names another.
    """

    def __init__(self, cfg: ControllerConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        pin_fp32(dev)
        self.net = get_network(cfg.network)
        self.wl = WORKLOADS[cfg.workload]
        self.dataset = eval_mod.WL_TO_DATASET.get(cfg.workload, cfg.workload)
        n = self.net.num_silos
        self.overlay = ring_topology(self.net, self.wl).graph
        self._spec = spec = SMALL_MODELS[_DATASET_MODEL[self.dataset]]
        self._opt = flat_sgd(cfg.lr, momentum=0.0)
        # `run_fl`'s initial row for the same seed (`evaluate_frontier`)
        self._params0 = spec.init(torch.Generator().manual_seed(cfg.seed))

        # Initial schedule: the paper's Algorithm-1 design over the
        # shared overlay, expressed as a multiplicity VECTOR so every
        # later swap goes through the identical constructor.
        tplan0 = timing.multigraph_timing_plan(self.net, self.wl, t=cfg.t,
                                               overlay=self.overlay)
        self.vec0 = tuple(int(tplan0.mg.multiplicity[p])
                          for p in self.overlay.pairs)
        self.tplan0 = tplan0
        plan0, _, _ = dpasgd.multigraph_plan(self.net, tplan0)
        self.rt0 = flrt.make_flat_runtime(plan0, self._params0, n)
        self._w0 = flatmod.ravel(self.rt0.spec, self._params0).to(dev)
        if cfg.mesh is not None:
            mrt = flmesh.make_mesh_runtime(self.rt0, cfg.mesh, device=dev)
            self._cycle_fn = flrt.make_cycle_fn(
                mrt, loss_fn=spec.loss, opt=self._opt, gossip=cfg.gossip)
            self._init_state = lambda: flmesh.init_mesh_state(
                self._w0, self._opt, mrt)
            # evaluate the single-device rows, as with mesh=None
            self._get_w = lambda st: flmesh.gather_flat_state(mrt, st).w
        else:
            self._cycle_fn = flrt.make_cycle_fn(self.rt0, loss_fn=spec.loss,
                                                opt=self._opt)
            self._init_state = lambda: flrt.init_flat_state(
                self._w0, self._opt, self.rt0)
            self._get_w = lambda st: st.w
        self.density_floor = (cfg.density_slack
                              * strong_fraction(self.vec0) - 1e-12)

        fl_cfg = FLConfig(dataset=self.dataset, network=cfg.network,
                          topology="multigraph", rounds=cfg.rounds,
                          eval_every=cfg.rounds, lr=cfg.lr,
                          batch_size=cfg.batch_size,
                          samples_per_silo=cfg.samples_per_silo,
                          local_updates=cfg.local_updates, seed=cfg.seed)
        data = make_federated_dataset(self.dataset, n,
                                      samples_per_silo=cfg.samples_per_silo,
                                      alpha=fl_cfg.alpha, seed=cfg.seed)
        # Same draw order as trainer.run_fl / evaluate_frontier: runs
        # across the matrix consume the identical batch tensors, put on
        # the device once.
        rng = np.random.default_rng(cfg.seed + 1)
        per_round = [_sample_round(data, n, fl_cfg, rng)
                     for _ in range(cfg.rounds)]
        self._batches = {
            "x": torch.as_tensor(np.stack([x for x, _ in per_round]),
                                 device=dev),
            "y": torch.as_tensor(np.stack([y for _, y in per_round]),
                                 dtype=torch.long, device=dev)}
        test_batch = {"x": torch.as_tensor(data.test_x, device=dev),
                      "y": torch.as_tensor(data.test_y, dtype=torch.long,
                                           device=dev)}

        @torch.no_grad()
        def acc_fn(w: torch.Tensor) -> float:
            return float(spec.accuracy(
                flatmod.unravel(self.rt0.spec, w.mean(dim=0)), test_batch))

        self._acc_fn = acc_fn

    # -- re-planning ------------------------------------------------------

    def _replan_vector(self, vec: tuple[int, ...], est: np.ndarray,
                       comp_est: np.ndarray,
                       horizon: int) -> tuple[int, ...]:
        """Best multiplicity vector for the OBSERVED delay window.

        The online twin of `search.population_search`, sized for a
        segment boundary: the current vector and Algorithm 1 recomputed
        from the observed delays seed a short hill climb
        (``replan_iters``), the scored pool becomes a small population,
        and ``replan_generations`` annealed mutate/swap/crossover
        generations widen it — all scored by one `make_scorer` under
        ``d0_override``/``comp_override``, holding the usual density
        floor so the controller can never starve communication to
        cheat the clock. The pool argmin keeps the hill climb's
        matches-or-beats containment: evolution can only improve on
        the seeds.
        """
        cfg = self.cfg
        seeds = [vec]
        alg1 = _alg1_vector(est, cfg.t_max)
        if alg1 not in seeds:
            seeds.append(alg1)
        seeds = [s for s in seeds
                 if strong_fraction(s) >= self.density_floor] or [vec]
        score_fn = make_scorer(self.net, self.wl, self.overlay,
                               rounds=horizon, d0_override=est,
                               comp_override=comp_est,
                               backend=cfg.replan_backend,
                               device=self.device)
        pool: dict[tuple[int, ...], float] = {}
        best, best_ms, _, _ = hill_climb(score_fn, seeds,
                                         t_max=cfg.t_max,
                                         floor=self.density_floor,
                                         max_iters=cfg.replan_iters,
                                         pool=pool)
        if cfg.replan_generations > 0 and cfg.replan_pop > 1:
            ranked = sorted((ms, v) for v, ms in pool.items())
            population = [v for _, v in ranked[:cfg.replan_pop]]
            # Seeded per re-plan (segment horizons differ), so the
            # whole scenario matrix stays deterministic.
            rng = np.random.default_rng([cfg.seed, horizon])
            evolve_population(score_fn, pool, population,
                              t_max=cfg.t_max, floor=self.density_floor,
                              rng=rng,
                              generations=cfg.replan_generations,
                              temp0=max(best_ms, 1e-9) * 0.05)
            best_ms, best = min((ms, v) for v, ms in pool.items())
        return best

    def _runtime_for(self, vec: tuple[int, ...]):
        """(TimingPlan, FlatRuntime) for a vector — NOMINAL constructor
        (the session carries observed conditions itself). The CSR
        structure must be the initial runtime's: the one cycle function
        was built for it."""
        tplan = timing.multiplicity_vector_plan(
            self.net, self.wl, self.overlay, vec, name="controller")
        plan, _, _ = dpasgd.multigraph_plan(self.net, tplan)
        rt = flrt.make_flat_runtime(plan, self._params0, self.net.num_silos)
        if not (np.array_equal(rt.src_sorted, self.rt0.src_sorted)
                and np.array_equal(rt.row_ptr, self.rt0.row_ptr)):
            raise AssertionError("swapped plan changed the CSR edge "
                                 "structure; the shared cycle function "
                                 "cannot run it")
        return tplan, rt

    # -- running ----------------------------------------------------------

    def run(self, scenario: str | Scenario, adaptive: bool = False,
            recorder=None) -> ControlledRun:
        """Train ``cfg.rounds`` under a scenario.

        ``adaptive=False`` — static schedule, static clock accounting
        (the fleet waits out the timeout on every degraded round).
        ``adaptive=True`` — adaptive clock (timeout paid once per
        demotion streak) AND the re-planning controller at segment
        boundaries. Both degrade identically (same effective masks
        absent swaps), so under nominal the two runs are bit-exact.

        ``recorder`` — an `obs.TraceRecorder`: per-silo simulated
        spans for every segment (observed delays), host spans around
        each cycle call, and controller instants (observe/replan/swap)
        at segment boundaries. Purely additive: the training path and
        the taus are untouched.
        """
        cfg = self.cfg
        dev = self.device
        sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
        # cfg.trace (RuntimeOptions) with no explicit recorder: record
        # this run and write the Perfetto trace on return
        auto_trace = recorder is None and cfg.trace is not None
        if auto_trace:
            recorder = TraceRecorder()
            recorder.meta.update(network=cfg.network, rounds=cfg.rounds,
                                 scenario=str(scenario), adaptive=adaptive)
        policy = DegradePolicy(timeout_ms=sc.timeout_ms,
                               max_stale=sc.max_stale, adaptive=adaptive)
        vec = self.vec0
        tplan, rt = self.tplan0, self.rt0
        session = FaultedSession(tplan, schedule=sc.schedule, policy=policy,
                                 record_obs=recorder is not None)
        assumed = tplan.d0.copy()

        state = self._init_state()
        re = cfg.replan_every
        num_segments = cfg.rounds // re
        losses: list[float] = []
        taus: list[np.ndarray] = []
        swaps: list[int] = []
        vectors: list[tuple[int, ...]] = [vec]
        demoted = 0
        sim_t = 0.0
        for s in range(num_segments):
            seg = session.advance(re)
            taus.append(seg.taus)
            demoted += int((seg.planned & ~seg.eff).sum())
            pks = seg.phases
            plan_t = [torch.as_tensor(x, device=dev) for x in
                      (rt.expand_pair_mask(seg.eff), rt.coeffs[pks],
                       rt.diag[pks])]
            batches = {k: v[s * re:(s + 1) * re]
                       for k, v in self._batches.items()}
            if recorder is not None:
                sim_t = recorder.add_faulted_spans(
                    self.tplan0.pair_i, self.tplan0.pair_j, seg,
                    t0_ms=sim_t)
                span = recorder.host_span(
                    "dispatch", segment=s, scenario=sc.schedule.name,
                    adaptive=adaptive)
            else:
                span = contextlib.nullcontext()
            with span:
                state, seg_losses = self._cycle_fn(state, batches, *plan_t)
                losses.extend(seg_losses.tolist())

            if adaptive and s + 1 < num_segments:
                est = seg.base.mean(axis=0)
                if math.isfinite(policy.timeout_ms):
                    est = np.where(seg.dead.any(axis=0),
                                   np.maximum(est, policy.timeout_ms), est)
                dev_rel = float(np.max(np.abs(est - assumed) / assumed))
                if recorder is not None:
                    recorder.instant("observe", t_ms=sim_t,
                                     round=session.round, deviation=dev_rel,
                                     threshold=cfg.replan_threshold)
                if dev_rel > cfg.replan_threshold:
                    if recorder is not None:
                        recorder.instant("replan", t_ms=sim_t,
                                         round=session.round,
                                         deviation=dev_rel)
                    comp_est = seg.comp_obs.mean(axis=0)
                    new_vec = self._replan_vector(
                        vec, est, comp_est, cfg.rounds - (s + 1) * re)
                    assumed = est
                    if new_vec != vec:
                        vec = new_vec
                        tplan, rt = self._runtime_for(vec)
                        session.swap_plan(tplan)
                        swaps.append(session.round)
                        vectors.append(vec)
                        if recorder is not None:
                            recorder.instant("swap", t_ms=sim_t,
                                             round=session.round,
                                             vector=list(vec))
        acc = self._acc_fn(self._get_w(state))
        if auto_trace:
            write_trace(cfg.trace, recorder)
        return ControlledRun(
            scenario=sc.schedule.name, adaptive=adaptive,
            losses=np.asarray(losses), cycle_times_ms=np.concatenate(taus),
            swap_rounds=tuple(swaps), vectors=tuple(vectors),
            demoted_rounds=demoted, final_acc=acc)
