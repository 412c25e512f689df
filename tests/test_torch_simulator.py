"""The port's cycle-time simulator (`repro_torch.core.simulator`) against
`repro.core.simulator`: every entry point on the same inputs, reports
equal field for field, and the paper's Table 3 statistics (states,
states and rounds with isolated nodes) of the multigraph on all five
networks and three workloads at the paper's 6,400 rounds. The times are
simulated milliseconds of the paper's network model on both sides.
"""

import dataclasses

import pytest

pytest.importorskip("jax")

from repro.core import simulator as rsim  # noqa: E402
from repro.core.delay import WORKLOADS as RWORKLOADS  # noqa: E402
from repro.design import catalog as rcatalog  # noqa: E402
from repro.networks.registry import get_network as rget  # noqa: E402

from repro_torch.core import simulator as psim  # noqa: E402
from repro_torch.core.delay import WORKLOADS as PWORKLOADS  # noqa: E402
from repro_torch.core.graph import make_graph  # noqa: E402
from repro_torch.design import catalog as pcatalog  # noqa: E402
from repro_torch.networks.registry import get_network as pget  # noqa: E402

NETWORKS = ("gaia", "amazon", "geant", "exodus", "ebone")
WORKLOADS = ("femnist", "sentiment140", "inaturalist")
TOPOLOGIES = ("star", "matcha", "matcha_plus", "mst", "dmbst", "ring",
              "multigraph")


def _eq(p, r):
    assert dataclasses.asdict(p) == dataclasses.asdict(r)


@pytest.mark.parametrize("net", NETWORKS)
def test_table3_multigraph_equal(net):
    """`simulate_multigraph` at t = 5 (and t = 3 on gaia's workloads):
    the isolated-node statistics and the cycle times of Table 3."""
    for wl in WORKLOADS:
        for t in ((3, 5) if net == "gaia" else (5,)):
            got = psim.simulate_multigraph(pget(net), PWORKLOADS[wl], t=t)
            want = rsim.simulate_multigraph(rget(net), RWORKLOADS[wl], t=t)
            _eq(got, want)
            assert got.num_rounds == psim.DEFAULT_ROUNDS == 6400
            assert got.states_with_isolated <= got.num_states


@pytest.mark.parametrize("net", ["gaia", "geant"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_simulate_equal(net, topology):
    for wl in ("femnist", "inaturalist"):
        got = psim.simulate(topology, pget(net), PWORKLOADS[wl],
                            num_rounds=1000, seed=1)
        want = rsim.simulate(topology, rget(net), RWORKLOADS[wl],
                             num_rounds=1000, seed=1)
        _eq(got, want)


def test_entry_points_equal():
    """`simulate_static`, `simulate_star`, `simulate_ring`,
    `simulate_sampled` (whole horizon and a 256-round period) and
    `simulate_multigraph` over an explicit overlay and an uncapped
    schedule."""
    p, r = pget("amazon"), rget("amazon")
    pw, rw = PWORKLOADS["sentiment140"], RWORKLOADS["sentiment140"]
    _eq(psim.simulate_static("mst", p, pw, pcatalog.mst_topology(p, pw), 900),
        rsim.simulate_static("mst", r, rw, rcatalog.mst_topology(r, rw), 900))
    _eq(psim.simulate_star(p, pw, 900), rsim.simulate_star(r, rw, 900))
    _eq(psim.simulate_ring(p, pw, 900), rsim.simulate_ring(r, rw, 900))
    for sample in (None, 256):
        _eq(psim.simulate_sampled(
            "matcha", p, pw, pcatalog.matcha_topology(p, pw, seed=2), 900,
            sample_rounds=sample),
            rsim.simulate_sampled(
                "matcha", r, rw, rcatalog.matcha_topology(r, rw, seed=2),
                900, sample_rounds=sample))
    overlay = make_graph(22, [(i, (i + 1) % 22) for i in range(22)]
                         + [(0, 11), (5, 17)])
    for cap in (None, 12):
        _eq(psim.simulate_multigraph(p, pw, t=4, num_rounds=900,
                                     overlay=overlay, cap_states=cap),
            rsim.simulate_multigraph(r, rw, t=4, num_rounds=900,
                                     overlay=overlay, cap_states=cap))
