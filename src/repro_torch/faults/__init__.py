"""Deterministic fault injection and graceful degradation (counterpart of
`repro.faults`, DESIGN.md §14).

This package turns the nominal Eq. 3/4/5 timing model into a
fault-injected one without touching its control flow:

* `schedule.FaultSchedule` — seeded, counter-based per-round fault
  arrays (link drift, diurnal capacity, flash stragglers, transient
  link loss, silo churn). Any subset of rounds reproduces bit-for-bit
  in any order (the MatchaTopology splitmix64 idiom).
* `engine.FaultedSession` — the Eq. 4 recurrence consuming OBSERVED
  instead of nominal delays, with per-pair timeout demotion and
  bounded-staleness reactivation (the Eq. 4 weak->strong branch).
  Under the nominal schedule it reproduces `TimingPlan.cycle_times`
  bit-for-bit.
* `degrade.DegradePolicy` / `degrade.removed_network` — the
  degradation knobs and the seeded silo-removal helper.
"""

from repro_torch.faults.degrade import (DegradePolicy, crashed_pair_mask,
                                        pair_rounds_to_directed,
                                        removed_network)
from repro_torch.faults.engine import FaultedSegment, FaultedSession
from repro_torch.faults.schedule import (FaultArrays, FaultEvent,
                                         FaultSchedule, NOMINAL, SCENARIOS,
                                         Scenario, get_scenario,
                                         scenario_overrides)

__all__ = [
    "DegradePolicy", "FaultArrays", "FaultEvent", "FaultSchedule",
    "FaultedSegment", "FaultedSession", "NOMINAL", "SCENARIOS", "Scenario",
    "crashed_pair_mask", "get_scenario", "pair_rounds_to_directed",
    "removed_network", "scenario_overrides",
]
