"""The port's planning layer against the reference, on identical inputs.

Networks, the Christofides overlay, Algorithm 1, the RoundPlan, the
TimingPlan and the synthetic data are numpy on both sides, so every
comparison here is exact (`np.array_equal` or `==`), no tolerance.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
nx = pytest.importorskip("networkx")

from repro.core import timing as rtiming  # noqa: E402
from repro.core.delay import WORKLOADS as RWORKLOADS  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.design import catalog as rcatalog  # noqa: E402
from repro.fl import dpasgd as rdpasgd  # noqa: E402
from repro.networks.registry import get_network as rget  # noqa: E402

from repro_torch.core import timing as ptiming  # noqa: E402
from repro_torch.core.delay import WORKLOADS as PWORKLOADS  # noqa: E402
from repro_torch.core.multigraph import build_multigraph  # noqa: E402
from repro_torch.data import synthetic as psyn  # noqa: E402
from repro_torch.design import catalog as pcatalog  # noqa: E402
from repro_torch.fl import dpasgd as pdpasgd  # noqa: E402
from repro_torch.networks.registry import get_network as pget  # noqa: E402

WORKLOAD_NAMES = ("femnist", "sentiment140", "inaturalist")


@pytest.mark.parametrize("name", ["gaia", "amazon", "geant", "exodus",
                                  "ebone"])
def test_networks_equal(name):
    p, r = pget(name), rget(name)
    assert p.name == r.name and p.num_silos == r.num_silos
    np.testing.assert_array_equal(p.latency_ms, r.latency_ms)
    np.testing.assert_array_equal(p.upload_gbps(), r.upload_gbps())
    np.testing.assert_array_equal(p.download_gbps(), r.download_gbps())
    np.testing.assert_array_equal(p.compute_scale(), r.compute_scale())


@pytest.mark.parametrize("wl", WORKLOAD_NAMES)
def test_pair_delays_equal(wl):
    from repro.core import delay as rdelay
    from repro_torch.core import delay as pdelay
    p, r = pget("amazon"), rget("amazon")
    deg = np.arange(p.num_silos) % 4
    for i, j in [(0, 1), (3, 17), (21, 5), (8, 9)]:
        assert pdelay.pair_delay_ms(p, PWORKLOADS[wl], i, j, deg) == \
            rdelay.pair_delay_ms(r, RWORKLOADS[wl], i, j, deg)
    np.testing.assert_array_equal(
        ptiming.directed_delay_matrix(p, PWORKLOADS[wl], deg, deg[::-1]),
        rtiming.directed_delay_matrix(r, RWORKLOADS[wl], deg, deg[::-1]))


@pytest.mark.parametrize("net", ["gaia", "amazon", "geant", "exodus",
                                 "ebone"])
@pytest.mark.parametrize("wl", WORKLOAD_NAMES)
def test_ring_overlay_equal(net, wl):
    p = pcatalog.ring_topology(pget(net), PWORKLOADS[wl]).graph
    r = rcatalog.ring_topology(rget(net), RWORKLOADS[wl]).graph
    assert p.pairs == r.pairs
    np.testing.assert_array_equal(
        pcatalog.nominal_delay_matrix(pget(net), PWORKLOADS[wl]),
        rcatalog.nominal_delay_matrix(rget(net), RWORKLOADS[wl]))


@pytest.mark.parametrize("seed", range(6))
def test_christofides_tour_equals_networkx(seed):
    """The whole tour (order included) on random metric instances."""
    rng = np.random.default_rng(seed)
    for n in (4, 7, 12, 17):
        pts = rng.random((n, 2))
        d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
        assert pcatalog.christofides_cycle(d) == rcatalog.christofides_cycle(d)


@pytest.mark.parametrize("wl", WORKLOAD_NAMES)
def test_multigraph_equal(wl):
    net_p, net_r = pget("gaia"), rget("gaia")
    overlay = pcatalog.ring_topology(net_p, PWORKLOADS[wl]).graph
    mg = build_multigraph(net_p, PWORKLOADS[wl], overlay)
    from repro.core.multigraph import build_multigraph as rbuild
    rover = rcatalog.ring_topology(net_r, RWORKLOADS[wl]).graph
    assert mg.multiplicity == rbuild(net_r, RWORKLOADS[wl], rover).multiplicity


@pytest.mark.parametrize("net", ["gaia", "amazon", "geant", "exodus",
                                 "ebone"])
def test_round_plan_and_timing_plan_equal(net):
    p_plan, p_tp = pdpasgd.make_round_schedule("multigraph", pget(net),
                                               PWORKLOADS["femnist"])
    r_plan, r_tp = rdpasgd.make_round_schedule("multigraph", rget(net),
                                               RWORKLOADS["femnist"])
    for f in ("src", "dst", "strong", "coeffs", "diag", "aggregate"):
        a, b = getattr(p_plan, f), getattr(r_plan, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("d0", "pair_comp", "strong", "trans", "lone_comp", "iso_count"):
        np.testing.assert_array_equal(getattr(p_tp, f), getattr(r_tp, f))
    # scalar path (E <= SMALL_E) on gaia and amazon, the array path on
    # the others; several cycles and a ragged horizon
    for rounds in (1, 15, 97, 6400):
        np.testing.assert_array_equal(p_tp.cycle_times(rounds),
                                      r_tp.cycle_times(rounds))
        assert p_tp.report(rounds).row() == r_tp.report(rounds).row()


def test_array_recurrence_equals_reference():
    """The array path (`_recurrence_taus`, E > SMALL_E) on the gaia
    arrays tiled up past SMALL_E pairs."""
    _, tp = pdpasgd.make_round_schedule("multigraph", pget("gaia"),
                                        PWORKLOADS["femnist"])
    reps = ptiming.SMALL_E // len(tp.d0) + 1
    d0 = np.tile(tp.d0, reps) * np.repeat(1.0 + np.arange(reps) / 7, len(tp.d0))
    strong = np.tile(tp.strong, (1, reps))
    trans = np.tile(tp.trans, (1, reps))
    pc = np.tile(tp.pair_comp, reps)
    for rounds in (15, 200):
        got = ptiming._recurrence_taus(
            d0, tp.lone_comp, rounds,
            *ptiming._recurrence_scratch(strong, trans, pc))
        want = rtiming._recurrence_taus(
            d0, tp.lone_comp, rounds,
            *rtiming._recurrence_scratch(strong, trans, pc))
        np.testing.assert_array_equal(got, want)


def test_states_equal():
    _, p_tp = pdpasgd.make_round_schedule("multigraph", pget("gaia"),
                                          PWORKLOADS["femnist"])
    _, r_tp = rdpasgd.make_round_schedule("multigraph", rget("gaia"),
                                          RWORKLOADS["femnist"])
    assert [s.edge_type for s in p_tp.states] == \
        [s.edge_type for s in r_tp.states]


def test_federated_dataset_and_batch_stream_equal():
    p = psyn.make_federated_dataset("femnist", 11, samples_per_silo=24,
                                    seed=3)
    r = rsyn.make_federated_dataset("femnist", 11, samples_per_silo=24,
                                    seed=3)
    for a, b in zip(p.silo_x + p.silo_y + [p.test_x, p.test_y],
                    r.silo_x + r.silo_y + [r.test_x, r.test_y]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rp, rr = np.random.default_rng(4), np.random.default_rng(4)
    for k in range(40):
        bp = p.sample_batch(k % 11, 8, rp)
        br = r.sample_batch(k % 11, 8, rr)
        np.testing.assert_array_equal(bp["x"], br["x"])
        np.testing.assert_array_equal(bp["y"], br["y"])

