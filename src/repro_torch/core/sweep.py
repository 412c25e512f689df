"""Sweep of the paper grid (counterpart of `repro.core.sweep`): evaluate
(topology x network x workload x t) grids on the vectorized timing
engine and emit the paper's Table 1 (total training time per cell) and
Table 3 (states / isolated-node statistics) as ONE command:

    python -m repro_torch.core.sweep                  # full paper grid
    python -m repro_torch.core.sweep --quick          # small subset
    python -m repro_torch.core.sweep --check          # batched == per-cell
    python -m repro_torch.core.sweep --networks gaia,geant --t 3,5 \
        --topologies ring,multigraph --json sweep.json

The tables' times are simulated seconds of the paper's network model
(Eq. 3/4/5); they are numbers of the model, not of any device. The grid
runs on the host (``--backend numpy``, the default) or on the card
(``--backend torch``), with the same bits; ``--check`` holds the device
grid against the host one. ``--tta`` trains on the card. ``--device``
names another device for both (``--device cpu``).

Every cell is a `timing.TimingPlan` (`core/timing.py`) — the same
object the simulator and the FL trainer consume — so the tables are
single-sourced with the training wall-clock axis. Both phases are
batched: CONSTRUCTION goes through `design.batched` (one
`DesignContext` per network sharing nominal delay matrices,
Christofides ring graphs, matching decompositions and activation
tables across cells; MATCHA plans are lazy, so the horizon is NOT
materialized here), and EVALUATION advances all multigraph recurrence
cells together in ONE `timing.TimingGrid` array program while sampled
cells materialize their full horizon through the shared factorized
sampler. MATCHA cells sample their FULL horizon (no tiled 512-round
period), so the sweep's totals equal the trainer's totals for the same
config by construction. The per-cell, shared-nothing path remains
available as the equivalence oracle (``batched=False`` /
``shared=False`` / ``python -m repro_torch.core.sweep --check``), and every
cell reports its ``construct_ms`` / ``eval_ms`` split (printed, and in
``--json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch.core import timing
from repro_torch.core.delay import WORKLOADS
from repro_torch.core.timing import CycleTimeReport
from repro_torch.design import batched as design_batched
from repro_torch.design.catalog import ring_topology
from repro_torch.networks.registry import get_network

PAPER_TOPOLOGIES = ("star", "matcha", "matcha_plus", "mst", "dmbst",
                    "ring", "multigraph")
PAPER_NETWORKS = ("gaia", "amazon", "geant", "exodus", "ebone")
PAPER_WORKLOADS = ("femnist", "sentiment140", "inaturalist")


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    topologies: tuple[str, ...] = PAPER_TOPOLOGIES
    networks: tuple[str, ...] = PAPER_NETWORKS
    workloads: tuple[str, ...] = PAPER_WORKLOADS
    t_values: tuple[int, ...] = (5,)
    num_rounds: int = 6400
    seed: int = 0
    scenario: str = "nominal"   # named FaultSchedule (faults)
    backend: str = "numpy"      # recurrence grid engine: "numpy" (host,
    #                             orbit short-circuit — right for few
    #                             long-horizon cells) or "torch" (device
    #                             grid, core/timing_torch.py); bit-exact
    #                             either way, asserted by --check


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One grid cell: the report plus its construction/evaluation split."""

    report: CycleTimeReport
    t: int | None           # multigraph t, None for baselines
    num_silos: int
    construct_ms: float     # plan construction (graph algorithms + arrays)
    eval_ms: float          # evaluation (horizon materialization + grid)
    # Time-to-accuracy columns (``--tta``, multigraph cells only): the
    # design trained end-to-end (design/evaluate.py), scored by
    # simulated seconds to its own final smoothed loss. None when the
    # sweep ran timing-only.
    tta_s: float | None = None
    tta_final_acc: float | None = None
    tta_target_loss: float | None = None
    # Faulted columns (``--scenario``, non-nominal only): the same cell
    # re-timed under a named FaultSchedule (faults).
    scenario: str | None = None
    scenario_total_s: float | None = None
    scenario_mean_ms: float | None = None

    def row(self) -> dict:
        d = self.report.row()
        d.update(t=self.t, num_silos=self.num_silos,
                 construct_ms=round(self.construct_ms, 3),
                 eval_ms=round(self.eval_ms, 3))
        if self.tta_s is not None:
            d.update(tta_s=self.tta_s, tta_final_acc=self.tta_final_acc,
                     tta_target_loss=self.tta_target_loss)
        if self.scenario is not None:
            d.update(scenario=self.scenario,
                     scenario_total_s=self.scenario_total_s,
                     scenario_mean_ms=self.scenario_mean_ms)
        return d


def build_sweep_plans(cfg: SweepConfig, shared: bool = True
                      ) -> tuple[list[timing.TimingPlan], list[dict]]:
    """Construct one TimingPlan per grid cell (no evaluation).

    ``shared=True`` (default) builds through one
    `design.batched.DesignContext` per network — nominal delay
    matrices, ring graphs, matching decompositions and activation
    tables are computed once and shared by every cell that provably
    needs identical bits, and sampled (MATCHA) plans stay LAZY so no
    horizon is materialized during construction. ``shared=False`` is
    the legacy per-cell path (each cell rebuilds everything, sampled
    horizons materialized eagerly) — the construction oracle for
    `--check` and the tests.

    Returns the plans plus per-cell metadata ``{t, num_silos,
    build_ms}`` in the same order.
    """
    ctor = design_batched.SweepConstructor() if shared else None
    plans: list[timing.TimingPlan] = []
    meta: list[dict] = []
    for net_name in cfg.networks:
        net = get_network(net_name)
        for wl_name in cfg.workloads:
            wl = WORKLOADS[wl_name]
            overlay = None
            if not shared and ("ring" in cfg.topologies
                               or "multigraph" in cfg.topologies):
                # Christofides overlay shared by ring + every
                # multigraph t (the one dedup the legacy path had).
                overlay = ring_topology(net, wl).graph
            for topo in cfg.topologies:
                ts: tuple[int | None, ...] = (
                    cfg.t_values if topo == "multigraph" else (None,))
                for t in ts:
                    t0 = time.perf_counter()
                    if shared:
                        plan = ctor.make_plan(
                            topo, net, wl, t=(t if t is not None else 5),
                            seed=cfg.seed, sample_rounds=cfg.num_rounds)
                    else:
                        plan = timing.make_timing_plan(
                            topo, net, wl, t=(t if t is not None else 5),
                            seed=cfg.seed, sample_rounds=cfg.num_rounds,
                            overlay=(overlay
                                     if topo in ("ring", "multigraph")
                                     else None))
                        if plan.kind == "cyclic":
                            plan.period()   # legacy: materialize eagerly
                    plans.append(plan)
                    meta.append(dict(
                        t=t, num_silos=net.num_silos,
                        build_ms=(time.perf_counter() - t0) * 1e3))
    return plans, meta


def run_sweep(cfg: SweepConfig, batched: bool = True,
              shared: bool = True, *, device=None) -> list[SweepCell]:
    """Evaluate the whole grid; one TimingPlan per cell.

    ``batched=True`` (default) evaluates every recurrence cell in one
    `TimingGrid` array program; ``batched=False`` steps each cell's own
    per-cell path — the equivalence oracle the batched mode is tested
    against (bit-for-bit, `--check`).
    ``shared`` selects the construction path (see `build_sweep_plans`).
    ``device`` is where the ``"torch"`` grid runs (the card unless told
    otherwise); the host engine ignores it.
    """
    plans, meta = build_sweep_plans(cfg, shared=shared)
    eval_ms = [0.0] * len(plans)
    # Materialize the lazy sampled horizons per cell (timed per cell —
    # this is the sampled cells' evaluation work).
    for c, plan in enumerate(plans):
        if plan.kind == "cyclic":
            t0 = time.perf_counter()
            plan.period()
            eval_ms[c] += (time.perf_counter() - t0) * 1e3
    if batched:
        grid = timing.build_timing_grid(plans)
        t0 = time.perf_counter()
        reports = grid.reports(cfg.num_rounds, backend=cfg.backend,
                               device=device)
        grid_ms = (time.perf_counter() - t0) * 1e3
        # The recurrence cells advance as ONE array program; their
        # shared wall-clock is attributed equally across them.
        rec = [c for c, p in enumerate(plans) if p.kind == "recurrence"]
        for c in rec:
            eval_ms[c] += grid_ms / len(rec)
    else:
        reports = []
        for c, plan in enumerate(plans):
            t0 = time.perf_counter()
            reports.append(plan.report(cfg.num_rounds))
            eval_ms[c] += (time.perf_counter() - t0) * 1e3
    return [SweepCell(report=rep, t=m["t"], num_silos=m["num_silos"],
                      construct_ms=m["build_ms"], eval_ms=e)
            for rep, m, e in zip(reports, meta, eval_ms)]


def attach_tta(cells: list[SweepCell], rounds: int = 40,
               seed: int = 0, device=None) -> list[SweepCell]:
    """Fill the TTA columns of every multigraph cell by training it.

    Each cell's Algorithm-1 design at its own ``t`` runs through the
    `design/evaluate.py` evaluator (flat whole-cycle runtime); the
    target is the run's final smoothed loss, so ``tta_s`` is the
    simulated wall clock the design needs to converge — the axis the
    paper actually optimizes, reported next to the cycle-time tables it
    is usually read off from. Baseline cells pass through unchanged.
    Training runs on ``device`` (the card unless told otherwise).
    """
    from repro_torch.design import evaluate

    out = []
    for c in cells:
        if not c.report.topology.startswith("multigraph"):
            out.append(c)
            continue
        r = evaluate.evaluate_design(
            c.report.network, c.report.workload, t=(c.t or 5),
            rounds=rounds, seed=seed, device=device)
        out.append(dataclasses.replace(
            c, tta_s=r.tta_s, tta_final_acc=r.final_acc,
            tta_target_loss=r.target_loss))
    return out


def scenario_cycle_times(plan: timing.TimingPlan, scenario,
                         num_rounds: int) -> np.ndarray:
    """Per-round cycle times of one cell under a fault scenario.

    Recurrence cells (multigraph) run the full faulted Eq. 4 engine
    (`faults.FaultedSession`, static clock accounting — the sweep
    times SCHEDULES, the adaptive controller lives in
    the reference's `design/controller.py`). Cyclic/sampled cells have no per-pair
    recurrence to degrade, so they get the coarse documented model:
    the nominal series scaled by the round's worst silo link/compute
    multiplier (crashes are not modeled for them). Under the nominal
    scenario both paths are bit-exact with ``plan.cycle_times`` —
    asserted by ``--check``.
    """
    from repro_torch.faults import DegradePolicy, FaultedSession

    if plan.kind == "recurrence":
        policy = DegradePolicy(timeout_ms=scenario.timeout_ms,
                               max_stale=scenario.max_stale, adaptive=False)
        return FaultedSession(plan, schedule=scenario.schedule,
                              policy=policy).advance(num_rounds).taus
    times = plan.cycle_times(num_rounds)
    arr = scenario.schedule.arrays(np.arange(num_rounds), plan.num_nodes)
    scale = np.maximum(arr.link_scale.max(axis=1),
                       arr.comp_scale.max(axis=1))
    return times * scale


def attach_scenario(cells: list[SweepCell], cfg: SweepConfig
                    ) -> list[SweepCell]:
    """Fill the scenario columns of every cell by re-timing it under
    ``cfg.scenario`` (plans are rebuilt through the shared constructor;
    construction is cheap next to evaluation)."""
    from repro_torch.faults import get_scenario

    sc = get_scenario(cfg.scenario)
    plans, _ = build_sweep_plans(cfg, shared=True)
    assert len(plans) == len(cells)
    out = []
    for c, plan in zip(cells, plans):
        taus = scenario_cycle_times(plan, sc, cfg.num_rounds)
        out.append(dataclasses.replace(
            c, scenario=cfg.scenario,
            scenario_total_s=float(taus.sum()) / 1e3,
            scenario_mean_ms=float(taus.mean())))
    return out


# ---------------------------------------------------------------------------
# table formatting
# ---------------------------------------------------------------------------


def _cell_key(c: SweepCell) -> tuple[str, str]:
    return (c.report.workload, c.report.network)


def format_table1(cells: list[SweepCell]) -> str:
    """Paper Table 1: total training time (seconds) per topology x
    network, one block per workload; multigraph rows are per-t."""
    lines = ["== Table 1: total training time (seconds, "
             f"{cells[0].report.num_rounds if cells else 0} rounds) =="]
    workloads = sorted({c.report.workload for c in cells})
    networks = list(dict.fromkeys(c.report.network for c in cells))
    rows = list(dict.fromkeys(
        (c.report.topology, c.t) for c in cells))
    for wl in workloads:
        lines.append(f"-- {wl} --")
        lines.append("topology".ljust(18) + "".join(
            n.rjust(12) for n in networks))
        for topo, t in rows:
            vals = []
            for n in networks:
                match = [c for c in cells
                         if _cell_key(c) == (wl, n)
                         and (c.report.topology, c.t) == (topo, t)]
                vals.append(f"{match[0].report.total_time_s:.1f}"
                            if match else "-")
            lines.append(topo.ljust(18) + "".join(v.rjust(12) for v in vals))
    return "\n".join(lines)


def format_table3(cells: list[SweepCell]) -> str:
    """Paper Table 3: multigraph isolated-node statistics per network
    (+ cycle time vs RING when a ring cell is in the sweep)."""
    lines = ["== Table 3: multigraph states / isolated nodes =="]
    header = ("network".ljust(9) + "workload".ljust(14) + "t".rjust(3)
              + "silos".rjust(7) + "states".rjust(8) + "iso_states".rjust(12)
              + "iso_rounds".rjust(12) + "cycle_ms".rjust(10)
              + "ring_ms".rjust(10))
    lines.append(header)
    for c in cells:
        if not c.report.topology.startswith("multigraph"):
            continue
        ring = [r for r in cells
                if _cell_key(r) == _cell_key(c) and r.report.topology == "ring"]
        ring_ms = f"{ring[0].report.mean_cycle_ms:.1f}" if ring else "-"
        r = c.report
        lines.append(
            c.report.network.ljust(9) + r.workload.ljust(14)
            + str(c.t).rjust(3) + str(c.num_silos).rjust(7)
            + str(r.num_states).rjust(8)
            + f"{r.states_with_isolated}/{r.num_states}".rjust(12)
            + f"{r.rounds_with_isolated}/{r.num_rounds}".rjust(12)
            + f"{r.mean_cycle_ms:.1f}".rjust(10) + ring_ms.rjust(10))
    return "\n".join(lines)


def format_tta(cells: list[SweepCell]) -> str:
    """TTA columns (``--tta``): multigraph cells on the wall-clock
    time-to-accuracy axis next to their mean cycle time."""
    lines = ["== TTA: multigraph time-to-accuracy (trained) =="]
    header = ("network".ljust(9) + "workload".ljust(14) + "t".rjust(3)
              + "cycle_ms".rjust(10) + "tta_s".rjust(9)
              + "final_acc".rjust(11) + "target_loss".rjust(13))
    lines.append(header)
    for c in cells:
        if c.tta_s is None:
            continue
        r = c.report
        lines.append(
            r.network.ljust(9) + r.workload.ljust(14)
            + str(c.t).rjust(3) + f"{r.mean_cycle_ms:.1f}".rjust(10)
            + f"{c.tta_s:.2f}".rjust(9)
            + f"{c.tta_final_acc:.3f}".rjust(11)
            + f"{c.tta_target_loss:.4f}".rjust(13))
    return "\n".join(lines)


def format_scenario(cells: list[SweepCell]) -> str:
    """Faulted columns (``--scenario``): total/mean under the fault
    schedule next to the nominal numbers."""
    lines = [f"== scenario '{cells[0].scenario}': faulted timing =="]
    header = ("topology".ljust(18) + "network".ljust(9) + "workload".ljust(14)
              + "nominal_s".rjust(11) + "faulted_s".rjust(11)
              + "slowdown".rjust(10))
    lines.append(header)
    for c in cells:
        r = c.report
        slow = (c.scenario_total_s / r.total_time_s
                if r.total_time_s else float("nan"))
        lines.append(
            r.topology.ljust(18) + r.network.ljust(9) + r.workload.ljust(14)
            + f"{r.total_time_s:.1f}".rjust(11)
            + f"{c.scenario_total_s:.1f}".rjust(11)
            + f"{slow:.2f}x".rjust(10))
    return "\n".join(lines)


def consistency_check(cfg: SweepConfig, *, device=None) -> None:
    """Assert the batched paths == the per-cell oracles, bit-for-bit,
    full `CycleTimeReport` equality (mean/total/state statistics):

    * shared construction (`design.batched`, incl. the factorized
      MATCHA sampler) == legacy per-cell construction;
    * batched `TimingGrid` evaluation — with AND without per-cell
      retirement — == per-cell evaluation;
    * the DEVICE grid engine (``backend="torch"``, `core/timing_torch.py`,
      on ``device``: the card unless told otherwise) == the host grid ==
      per-cell;
    * MATCHA trainer total == report total past the old 512-round
      tiled period;
    * the nominal fault scenario is the identity: every cell's
      `scenario_cycle_times(..., nominal, R)` series equals
      ``plan.cycle_times(R)`` bit-for-bit (the `--scenario` flag's
      default cannot perturb today's output).

    The printed line names the legs that ran. Raises on any mismatch."""
    plans, _ = build_sweep_plans(cfg, shared=True)
    legacy, _ = build_sweep_plans(cfg, shared=False)
    grid = timing.build_timing_grid(plans)
    batched = grid.reports(cfg.num_rounds)
    no_retire = grid.reports(cfg.num_rounds, retire=False)
    on_device = grid.reports(cfg.num_rounds, backend="torch", device=device)
    oracle = [p.report(cfg.num_rounds) for p in legacy]
    for b, nr, dv, o in zip(batched, no_retire, on_device, oracle):
        if b != o:
            raise AssertionError(
                f"shared/batched != per-cell on {o.topology}/{o.network}/"
                f"{o.workload}: {b} vs {o}")
        if nr != o:
            raise AssertionError(
                f"non-retiring grid != per-cell on {o.topology}/"
                f"{o.network}/{o.workload}: {nr} vs {o}")
        if dv != o:
            raise AssertionError(
                f"torch grid != per-cell on {o.topology}/"
                f"{o.network}/{o.workload}: {dv} vs {o}")
    legs = ["shared construction", "batched grid", "retirement on+off",
            "torch==numpy==per-cell reports"]
    if any(t.startswith("matcha") for t in cfg.topologies):
        from repro_torch.core.simulator import simulate
        from repro_torch.fl import dpasgd

        net = get_network(cfg.networks[0])
        wl = WORKLOADS[cfg.workloads[0]]
        # > the old 512-round period, scaled up with --rounds
        rounds = max(520, cfg.num_rounds)
        _, tplan = dpasgd.make_round_schedule("matcha", net, wl,
                                              rounds=rounds, seed=cfg.seed)
        trainer_total = float(tplan.cycle_times(rounds).sum()) / 1e3
        report_total = simulate("matcha", net, wl, num_rounds=rounds,
                                seed=cfg.seed).total_time_s
        if trainer_total != report_total:
            raise AssertionError(
                f"matcha trainer total {trainer_total!r} != report total "
                f"{report_total!r} at rounds={rounds}")
        legs.append(f"matcha trainer==report@{rounds}r")
    from repro_torch.faults import get_scenario
    nominal = get_scenario("nominal")
    for p in plans:
        faulted = scenario_cycle_times(p, nominal, cfg.num_rounds)
        if not np.array_equal(faulted, p.cycle_times(cfg.num_rounds)):
            raise AssertionError(
                f"nominal scenario is not the identity on {p.topology}/"
                f"{p.network}/{p.workload}")
    legs.append("nominal fault scenario identity")
    print(f"consistency_check OK: {len(batched)} cells bit-exact; legs: "
          f"{', '.join(legs)}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Batch cycle-time sweep: paper Tables 1 and 3 in one "
                    "command (batched TimingGrid over the vectorized "
                    "Eq. 3/4/5 engine).")
    ap.add_argument("--topologies", default=",".join(PAPER_TOPOLOGIES))
    ap.add_argument("--networks", default=",".join(PAPER_NETWORKS))
    ap.add_argument("--workloads", default=",".join(PAPER_WORKLOADS))
    ap.add_argument("--t", default="5",
                    help="comma-separated multigraph t values")
    ap.add_argument("--rounds", type=int, default=6400)
    ap.add_argument("--backend", choices=("numpy", "torch"),
                    default="numpy",
                    help="recurrence grid engine for the batched "
                         "evaluation; outputs are bit-identical "
                         "(asserted by --check)")
    ap.add_argument("--device", default=None,
                    help="torch device of the device grid (--check, "
                         "--backend torch) and of --tta's training; the "
                         "card unless given")
    ap.add_argument("--quick", action="store_true",
                    help="small subset (gaia+geant, femnist)")
    ap.add_argument("--check", action="store_true",
                    help="consistency mode: assert shared construction "
                         "and batched evaluation == the per-cell oracles "
                         "bit-for-bit and MATCHA trainer==report, then "
                         "exit")
    ap.add_argument("--json", default="",
                    help="also dump all cells as JSON to this path")
    ap.add_argument("--tta", action="store_true",
                    help="also TRAIN every multigraph cell (on the card) "
                         "and report its time-to-accuracy columns (tta_s, "
                         "final_acc; design/evaluate.py) — much slower "
                         "than the timing-only sweep")
    ap.add_argument("--tta-rounds", type=int, default=40,
                    help="communication rounds per --tta training run")
    ap.add_argument("--scenario", default="nominal",
                    help="named fault scenario (faults.SCENARIOS) to "
                         "re-time every cell under; 'nominal' (default) "
                         "changes nothing — asserted in --check")
    args = ap.parse_args(argv)

    cfg = SweepConfig(
        topologies=tuple(s for s in args.topologies.split(",") if s),
        networks=tuple(s for s in args.networks.split(",") if s),
        workloads=tuple(s for s in args.workloads.split(",") if s),
        t_values=tuple(int(s) for s in args.t.split(",") if s),
        num_rounds=args.rounds, scenario=args.scenario,
        backend=args.backend)
    if args.quick:
        cfg = dataclasses.replace(
            cfg, networks=("gaia", "geant"), workloads=("femnist",))

    if args.check:
        consistency_check(cfg, device=args.device)
        return

    t0 = time.perf_counter()
    cells = run_sweep(cfg, device=args.device)
    if args.tta:
        cells = attach_tta(cells, rounds=args.tta_rounds, seed=cfg.seed,
                           device=args.device)
    if cfg.scenario != "nominal":
        cells = attach_scenario(cells, cfg)
    wall = time.perf_counter() - t0
    print(format_table1(cells))
    print()
    print(format_table3(cells))
    if args.tta:
        print()
        print(format_tta(cells))
    if cfg.scenario != "nominal":
        print()
        print(format_scenario(cells))
    build = sum(c.construct_ms for c in cells) / 1e3
    ev = sum(c.eval_ms for c in cells) / 1e3
    print(f"\n{len(cells)} cells in {wall:.2f}s "
          f"(plan construction {build:.2f}s, evaluation {ev:.2f}s)")
    print("(the tables' times are simulated, of the paper's network model; "
          "the seconds above are the host's)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump([c.row() for c in cells], f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
