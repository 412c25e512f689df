"""The port's scalar delay oracles (`repro_torch.core.delay`:
`static_cycle_time_ms`, `MultigraphDelayTracker`, `FaultedDelayTracker`)
against `repro.core.delay` on gaia and geant. Numpy and Python floats on
both sides: every comparison is exact.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import faults as rfaults  # noqa: E402
from repro.core import delay as rdelay, timing as rtiming  # noqa: E402
from repro.design.catalog import build_topology as rbuild  # noqa: E402
from repro.networks.registry import get_network as rget  # noqa: E402

from repro_torch import faults as pfaults  # noqa: E402
from repro_torch.core import delay as pdelay, timing as ptiming  # noqa: E402
from repro_torch.design.catalog import build_topology as pbuild  # noqa: E402
from repro_torch.networks.registry import get_network as pget  # noqa: E402

NETS = ("gaia", "geant")
TOPOLOGIES = ("star", "mst", "dmbst", "ring", "matcha", "matcha_plus")


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("topology", TOPOLOGIES + ("multigraph",))
def test_static_cycle_time_equal(net, topology):
    for wl in sorted(rdelay.WORKLOADS):
        if topology == "multigraph":
            pg = ptiming.multigraph_timing_plan(
                pget(net), pdelay.WORKLOADS[wl]).overlay
            rg = rtiming.multigraph_timing_plan(
                rget(net), rdelay.WORKLOADS[wl]).overlay
        else:
            pg = pbuild(topology, pget(net), pdelay.WORKLOADS[wl]).round_graph(0)
            rg = rbuild(topology, rget(net), rdelay.WORKLOADS[wl]).round_graph(0)
        assert pg.pairs == rg.pairs
        got = pdelay.static_cycle_time_ms(pget(net), pdelay.WORKLOADS[wl], pg)
        want = rdelay.static_cycle_time_ms(rget(net), rdelay.WORKLOADS[wl],
                                           rg)
        assert got == want, (topology, wl)


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("t", [1, 3, 5])
def test_multigraph_tracker_equal(net, t):
    """Both trackers over the parsed states for 3 cycles and more: equal
    taus and per-pair delays, and equal to the port's vectorised
    recurrence."""
    for wl in sorted(rdelay.WORKLOADS):
        pplan = ptiming.multigraph_timing_plan(pget(net), pdelay.WORKLOADS[wl],
                                               t=t)
        rplan = rtiming.multigraph_timing_plan(rget(net), rdelay.WORKLOADS[wl],
                                               t=t)
        rounds = max(3 * len(pplan.states) + 7, 60)
        ptr = pdelay.MultigraphDelayTracker(pget(net), pdelay.WORKLOADS[wl],
                                            pplan.overlay)
        rtr = rdelay.MultigraphDelayTracker(rget(net), rdelay.WORKLOADS[wl],
                                            rplan.overlay)
        got = [ptr.round_cycle_time(pplan.states[k % len(pplan.states)])
               for k in range(rounds)]
        want = [rtr.round_cycle_time(rplan.states[k % len(rplan.states)])
                for k in range(rounds)]
        assert got == want, wl
        assert ptr.d_cur == rtr.d_cur and ptr.d_prev == rtr.d_prev
        np.testing.assert_array_equal(np.asarray(got),
                                      pplan.cycle_times(rounds))


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("name", sorted(rfaults.SCENARIOS))
def test_faulted_tracker_equal(net, adaptive, name):
    """Both scalar trackers fed each scenario's observations and the
    plan's strong pairs: equal taus and effective pairs every round, and
    equal to the port's `FaultedSession`."""
    wl = "femnist"
    plan = ptiming.multigraph_timing_plan(pget(net), pdelay.WORKLOADS[wl])
    sc = pfaults.get_scenario(name)
    pol = pfaults.DegradePolicy(timeout_ms=sc.timeout_ms,
                                max_stale=sc.max_stale, adaptive=adaptive)
    r = 80
    seg = pfaults.FaultedSession(plan, schedule=sc.schedule,
                                 policy=pol).advance(r)
    arr = sc.schedule.arrays(np.arange(r), plan.overlay.num_nodes)
    kw = dict(timeout_ms=sc.timeout_ms, max_stale=sc.max_stale,
              adaptive=adaptive)
    ptr = pdelay.FaultedDelayTracker(pget(net), pdelay.WORKLOADS[wl],
                                     plan.overlay, **kw)
    rtr = rdelay.FaultedDelayTracker(rget(net), rdelay.WORKLOADS[wl],
                                     plan.overlay, **kw)
    pairs = plan.overlay.pairs
    for k in range(r):
        obs = ({pairs[e] for e in np.nonzero(seg.planned[k])[0]},
               arr.link_scale[k], arr.comp_scale[k],
               set(np.nonzero(arr.crashed[k])[0].tolist()),
               set(np.nonzero(arr.flapped[k])[0].tolist()))
        got, want = ptr.round_cycle_time(*obs), rtr.round_cycle_time(*obs)
        assert got == want, (name, k)
        assert got[0] == seg.taus[k], (name, k)
        assert got[1] == {pairs[e] for e in np.nonzero(seg.eff[k])[0]}
