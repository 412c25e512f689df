"""The port's Table-1 planning layer against the reference, on identical
inputs: every topology's graph, MATCHA's matchings and activation draws,
the Christofides overlays of the five networks, the blossom matching,
every timing plan, every RoundPlan and silo removal.

All of it is numpy on both sides (the reference calls networkx where the
port follows its order), so every comparison is exact: `==` or
`np.array_equal`, no tolerance. The blossom matching is also held
against networkx itself on random graphs, some with integer weights so
that ties occur.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
nx = pytest.importorskip("networkx")

from repro.core import delay as rdelay, timing as rtiming  # noqa: E402
from repro.core.delay import WORKLOADS as RWORKLOADS  # noqa: E402
from repro.design import catalog as rcatalog  # noqa: E402
from repro.faults.degrade import removed_network as rremoved  # noqa: E402
from repro.fl import dpasgd as rdpasgd  # noqa: E402
from repro.networks.registry import get_network as rget  # noqa: E402

from repro_torch.core import delay as pdelay, timing as ptiming  # noqa: E402
from repro_torch.core.delay import WORKLOADS as PWORKLOADS  # noqa: E402
from repro_torch.core.multigraph import build_multigraph  # noqa: E402
from repro_torch.design import blossom, catalog as pcatalog  # noqa: E402
from repro_torch.faults import removed_network as premoved  # noqa: E402
from repro_torch.fl import dpasgd as pdpasgd  # noqa: E402
from repro_torch.networks.registry import get_network as pget  # noqa: E402

NETWORKS = ("gaia", "amazon", "geant", "exodus", "ebone")
WORKLOADS = ("femnist", "sentiment140", "inaturalist")
STATIC = ("star", "mst", "dmbst", "ring")
TOPOLOGIES = STATIC + ("matcha", "matcha_plus", "multigraph")
PLAN_FIELDS = ("src", "dst", "strong", "coeffs", "diag", "aggregate")


def _g(graph):
    """A graph of either package as plain values."""
    return graph.num_nodes, graph.pairs


def _arrays_equal(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _reports_equal(p, r, rounds):
    np.testing.assert_array_equal(p.cycle_times(rounds), r.cycle_times(rounds))
    assert p.report(rounds).row() == r.report(rounds).row()
    assert (p.kind, p.topology, p.network, p.workload, p.num_states) == \
        (r.kind, r.topology, r.network, r.workload, r.num_states)


@pytest.mark.parametrize("net", NETWORKS)
def test_graphs_equal(net):
    p, r = pget(net), rget(net)
    assert _g(pcatalog.connectivity_graph(p)) == \
        _g(rcatalog.connectivity_graph(r))
    assert _g(pcatalog.physical_graph(p)) == _g(rcatalog.physical_graph(r))
    for wl in WORKLOADS:
        pw, rw = PWORKLOADS[wl], RWORKLOADS[wl]
        for name in STATIC:
            pg = pcatalog.build_topology(name, p, pw).round_graph(5)
            rg = rcatalog.build_topology(name, r, rw).round_graph(5)
            assert _g(pg) == _g(rg), (name, wl)
        ring = pcatalog.ring_topology(p, pw).graph
        assert ptiming.ring_tour(ring) == rtiming.ring_tour(
            rcatalog.ring_topology(r, rw).graph)


@pytest.mark.parametrize("net", ["geant", "exodus", "ebone"])
@pytest.mark.parametrize("wl", WORKLOADS)
def test_christofides_large_networks(net, wl):
    """geant's, exodus's and ebone's spanning trees have 18-58 odd-degree
    nodes: the tour rests on the blossom matching."""
    d = pcatalog.nominal_delay_matrix(pget(net), PWORKLOADS[wl])
    assert pcatalog.christofides_cycle(d) == rcatalog.christofides_cycle(d)


@pytest.mark.parametrize("seed", range(4))
def test_christofides_random_large(seed):
    rng = np.random.default_rng(100 + seed)
    for n in (30, 61, 90):
        pts = rng.random((n, 2))
        d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
        if seed % 2:      # a coarse grid: many equal weights
            d = np.round(d * 8) / 8
        assert pcatalog.christofides_cycle(d) == rcatalog.christofides_cycle(d)


def _nx_and_adj(n, weights, p_edge, rng):
    """A random graph built the same way as a networkx graph and as the
    port's dict of dicts."""
    g = nx.Graph()
    g.add_nodes_from(range(n))
    adj = {v: {} for v in range(n)}
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < p_edge:
                w = weights(rng)
                g.add_edge(i, j, weight=w)
                adj[i][j] = adj[j][i] = w
    return g, adj


WEIGHTS = {
    "float": lambda rng: float(rng.random()),
    "int_ties": lambda rng: int(rng.integers(1, 5)),
    "int_wide": lambda rng: int(rng.integers(-20, 100)),
}


@pytest.mark.parametrize("kind", sorted(WEIGHTS))
@pytest.mark.parametrize("maxcard", [False, True])
def test_blossom_matches_networkx(kind, maxcard):
    rng = np.random.default_rng(len(kind) * 7 + maxcard)
    for trial in range(40):
        n = int(rng.integers(2, 26))
        g, adj = _nx_and_adj(n, WEIGHTS[kind], float(rng.uniform(0.1, 1.0)),
                             rng)
        want = nx.max_weight_matching(g, maxcardinality=maxcard)
        got = blossom.max_weight_matching(adj, maxcardinality=maxcard)
        assert set(got) == want, (trial, n)


@pytest.mark.parametrize("kind", sorted(WEIGHTS))
def test_min_weight_matching_matches_networkx(kind):
    rng = np.random.default_rng(len(kind))
    for trial in range(30):
        n = 2 * int(rng.integers(1, 16))
        g, adj = _nx_and_adj(n, WEIGHTS[kind], 1.0, rng)    # complete
        want = nx.min_weight_matching(g)
        got = blossom.min_weight_matching(adj)
        assert set(got) == want, (trial, n)
        assert len(got) == n // 2


def test_blossom_empty_and_edgeless():
    assert blossom.max_weight_matching({}) == []
    assert blossom.min_weight_matching({0: {}, 1: {}}) == []


@pytest.mark.parametrize("net", NETWORKS)
def test_matcha_equal(net):
    p, r = pget(net), rget(net)
    for name in ("matcha", "matcha_plus"):
        pd = pcatalog.build_topology(name, p, PWORKLOADS["femnist"], seed=7)
        rd = rcatalog.build_topology(name, r, RWORKLOADS["femnist"], seed=7)
        assert pd.matchings == rd.matchings
        assert (pd.name, pd.num_nodes, pd.budget, pd.seed) == \
            (rd.name, rd.num_nodes, rd.budget, rd.seed)
        np.testing.assert_array_equal(pd.activation_matrix(300),
                                      rd.activation_matrix(300))
        rows = np.asarray([5, 0, 299, 1 << 40])
        np.testing.assert_array_equal(pd.activation_rows(rows),
                                      rd.activation_rows(rows))
        for k in (0, 3, 77):
            assert _g(pd.round_graph(k)) == _g(rd.round_graph(k))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**40 + 3])
def test_counter_uniform_bit_equal(seed):
    rows = np.arange(0, 6400, 7)
    got = pcatalog._counter_uniform(seed, rows, 13)
    want = rcatalog._counter_uniform(seed, rows, 13)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert ptiming.SPLITMIX64_CONSTANTS == rtiming.SPLITMIX64_CONSTANTS


@pytest.mark.parametrize("n", [2, 3, 6, 11, 22, 40, 79, 87])
def test_round_robin_matchings(n):
    assert pcatalog._round_robin_matchings(n) == \
        rcatalog._round_robin_matchings(n)


@pytest.mark.parametrize("net", NETWORKS)
def test_timing_plans_equal(net):
    p, r = pget(net), rget(net)
    for wl in WORKLOADS:
        pw, rw = PWORKLOADS[wl], RWORKLOADS[wl]
        for name in ("mst", "dmbst"):
            pg = pcatalog.build_topology(name, p, pw).graph
            _reports_equal(ptiming.static_timing_plan(name, p, pw, pg),
                           rtiming.static_timing_plan(name, r, rw, pg), 512)
            assert ptiming.static_cycle_time(p, pw, pg) == \
                rtiming.static_cycle_time(r, rw, pg)
        _reports_equal(ptiming.star_timing_plan(p, pw),
                       rtiming.star_timing_plan(r, rw), 512)
        _reports_equal(ptiming.ring_timing_plan(p, pw),
                       rtiming.ring_timing_plan(r, rw), 512)
        for name in ("matcha", "matcha_plus"):
            pd = pcatalog.build_topology(name, p, pw)
            rd = rcatalog.build_topology(name, r, rw)
            _reports_equal(
                ptiming.sampled_timing_plan(name, p, pw, pd, 512),
                rtiming.sampled_timing_plan(name, r, rw, rd, 512), 512)
            # a period shorter than the horizon is tiled, equal-weighted
            _reports_equal(
                ptiming.sampled_timing_plan(name, p, pw, pd, 100),
                rtiming.sampled_timing_plan(name, r, rw, rd, 100), 512)
        _reports_equal(ptiming.multigraph_timing_plan(p, pw),
                       rtiming.multigraph_timing_plan(r, rw), 512)


def test_sampled_times_equal_per_graph_oracle():
    p = pget("geant")
    d = pcatalog.matcha_plus_topology(p, PWORKLOADS["femnist"], seed=2)
    times = ptiming.sampled_cycle_times(d, p, PWORKLOADS["femnist"], 40)
    graphs = [d.round_graph(k) for k in range(40)]
    oracle = np.array([ptiming.static_cycle_time(p, PWORKLOADS["femnist"], g)
                       for g in graphs])
    np.testing.assert_array_equal(times, oracle)


@pytest.mark.parametrize("net", NETWORKS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_round_schedule_equal(net, topology):
    kw = dict(rounds=37, seed=4)
    p_plan, p_tp = pdpasgd.make_round_schedule(topology, pget(net),
                                               PWORKLOADS["femnist"], **kw)
    r_plan, r_tp = rdpasgd.make_round_schedule(topology, rget(net),
                                               RWORKLOADS["femnist"], **kw)
    _arrays_equal(p_plan, r_plan, PLAN_FIELDS)
    _reports_equal(p_tp, r_tp, 37)
    if topology == "multigraph":
        _arrays_equal(p_tp, r_tp, ("d0", "pair_comp", "strong", "trans",
                                   "lone_comp", "iso_count"))
    want_rows = 37 if topology.startswith("matcha") else (
        1 if topology in STATIC else p_tp.num_states)
    assert p_plan.num_rounds_cycle == want_rows


@pytest.mark.parametrize("net", ["gaia", "geant"])
def test_multiplicity_vector(net):
    """Algorithm 1's own vector reproduces the default schedule bit for
    bit; another vector matches the reference's searched schedule."""
    p, r = pget(net), rget(net)
    wl_p, wl_r = PWORKLOADS["femnist"], RWORKLOADS["femnist"]
    overlay = pcatalog.ring_topology(p, wl_p).graph
    mg = build_multigraph(p, wl_p, overlay)
    alg1 = tuple(mg.multiplicity[q] for q in overlay.pairs)
    d_plan, d_tp = pdpasgd.make_round_schedule("multigraph", p, wl_p)
    v_plan, v_tp = pdpasgd.make_round_schedule("multigraph", p, wl_p,
                                               multiplicity=alg1)
    _arrays_equal(v_plan, d_plan, PLAN_FIELDS)
    np.testing.assert_array_equal(v_tp.cycle_times(300),
                                  d_tp.cycle_times(300))
    other = tuple(1 + (i % 4) for i in range(len(overlay.pairs)))
    for mult in (alg1, other):
        pp, ptp = pdpasgd.make_round_schedule("multigraph", p, wl_p,
                                              multiplicity=mult)
        rp, rtp = rdpasgd.make_round_schedule("multigraph", r, wl_r,
                                              multiplicity=mult)
        _arrays_equal(pp, rp, PLAN_FIELDS)
        _reports_equal(ptp, rtp, 300)
    with pytest.raises(ValueError):
        pdpasgd.make_round_schedule("ring", p, wl_p, multiplicity=alg1)
    with pytest.raises(ValueError):
        pdpasgd.make_round_schedule("multigraph", p, wl_p,
                                    multiplicity=alg1[:-1])


@pytest.mark.parametrize("strategy", ["random", "inefficient"])
@pytest.mark.parametrize("net", ["gaia", "amazon", "geant"])
def test_removed_network_equal(strategy, net):
    for k, seed in ((2, 0), (3, 5)):
        pn, pk = premoved(pget(net), PWORKLOADS["femnist"], k=k,
                          strategy=strategy, seed=seed)
        rn, rk = rremoved(rget(net), RWORKLOADS["femnist"], k=k,
                          strategy=strategy, seed=seed)
        np.testing.assert_array_equal(pk, rk)
        assert pn.name == rn.name and pn.num_silos == rn.num_silos
        np.testing.assert_array_equal(pn.latency_ms, rn.latency_ms)
        np.testing.assert_array_equal(pn.compute_scale(), rn.compute_scale())


def test_graph_pair_delays_and_subset():
    p, r = pget("amazon"), rget("amazon")
    g = pcatalog.mst_topology(p, PWORKLOADS["femnist"]).graph
    assert pdelay.graph_pair_delays(p, PWORKLOADS["femnist"], g) == \
        rdelay.graph_pair_delays(r, RWORKLOADS["femnist"], g)
    assert set(pcatalog.TOPOLOGIES) == set(rcatalog.TOPOLOGIES)
    sub = p.subset([3, 1, 7], name="x")
    np.testing.assert_array_equal(
        sub.latency_ms, r.subset([3, 1, 7], name="x").latency_ms)
    with pytest.raises(KeyError):
        pcatalog.build_topology("nope", p, PWORKLOADS["femnist"])
