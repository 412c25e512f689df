"""Cycle-time simulator (counterpart of `repro.core.simulator`).

The average cycle time of a topology design over ``num_rounds``
communication rounds, as the paper's timing simulator (after Marfoq et
al.) gives it:

* static topologies: every round costs the same Eq. 5 max-delay;
* MATCHA: per-round sampled matchings, every round sampled;
* the multigraph: Algorithm 1 + Algorithm 2 + the Eq. 4 recurrence, with
  the isolated-node statistics of the paper's Table 3.

Each `simulate_*` is a thin wrapper over a `timing.TimingPlan`, the
object the FL trainer's wall-clock axis comes from. Its times are
simulated milliseconds of the paper's network model, not of any device.
"""

from __future__ import annotations

from repro_torch.core import timing
from repro_torch.core.delay import Workload
from repro_torch.core.graph import SimpleGraph
from repro_torch.core.timing import CycleTimeReport
from repro_torch.design.catalog import TopologyDesign
from repro_torch.networks.zoo import NetworkSpec

__all__ = ["DEFAULT_ROUNDS", "CycleTimeReport", "simulate",
           "simulate_multigraph", "simulate_ring", "simulate_sampled",
           "simulate_star", "simulate_static"]

DEFAULT_ROUNDS = 6400  # the paper trains 6,400 communication rounds


def simulate_static(name: str, net: NetworkSpec, wl: Workload,
                    design: TopologyDesign,
                    num_rounds: int = DEFAULT_ROUNDS) -> CycleTimeReport:
    plan = timing.static_timing_plan(name, net, wl, design.round_graph(0))
    return plan.report(num_rounds)


def simulate_star(net: NetworkSpec, wl: Workload,
                  num_rounds: int = DEFAULT_ROUNDS) -> CycleTimeReport:
    """STAR (client-server FedAvg): sequential gather and broadcast
    through the best hub (`timing.star_timing_plan`)."""
    return timing.star_timing_plan(net, wl).report(num_rounds)


def simulate_ring(net: NetworkSpec, wl: Workload,
                  num_rounds: int = DEFAULT_ROUNDS) -> CycleTimeReport:
    """RING with max-plus throughput (`timing.ring_timing_plan`)."""
    return timing.ring_timing_plan(net, wl).report(num_rounds)


def simulate_sampled(name: str, net: NetworkSpec, wl: Workload,
                     design: TopologyDesign,
                     num_rounds: int = DEFAULT_ROUNDS,
                     sample_rounds: int | None = None) -> CycleTimeReport:
    """Per-round random topologies (MATCHA), by default every round
    sampled, so the report total is the trainer's wall-clock total."""
    s = sample_rounds if sample_rounds is not None else num_rounds
    plan = timing.sampled_timing_plan(name, net, wl, design,
                                      sample_rounds=s)
    return plan.report(num_rounds)


def simulate_multigraph(net: NetworkSpec, wl: Workload,
                        t: int = 5,
                        num_rounds: int = DEFAULT_ROUNDS,
                        overlay: SimpleGraph | None = None,
                        cap_states: int | None = timing.CAP_STATES
                        ) -> CycleTimeReport:
    """Overlay -> Algorithm 1 -> Algorithm 2 -> Eq. 4/5."""
    plan = timing.multigraph_timing_plan(net, wl, t=t, overlay=overlay,
                                         cap_states=cap_states)
    return plan.report(num_rounds)


def simulate(topology: str, net: NetworkSpec, wl: Workload,
             num_rounds: int = DEFAULT_ROUNDS, **kw) -> CycleTimeReport:
    """Any Table-1 topology, through `timing.make_timing_plan`."""
    if topology.startswith("matcha"):
        kw.setdefault("sample_rounds", num_rounds)
    return timing.make_timing_plan(topology, net, wl, **kw).report(num_rounds)
