"""The port's batched timing grid (`core.timing.TimingGrid`,
`build_timing_grid`, `_grid_recurrence_taus`, `_snapshot_hashes`),
`make_timing_plan` and the design families (`design.catalog.get_family`)
against the reference, on identical inputs. All numpy on both sides, so
every comparison is exact: reports field for field, arrays with
`np.array_equal`.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import timing as rtiming  # noqa: E402
from repro.core.delay import WORKLOADS as RWORKLOADS  # noqa: E402
from repro.design import batched as rbatched  # noqa: E402
from repro.design import catalog as rcatalog  # noqa: E402
from repro.networks.registry import get_network as rget  # noqa: E402

from repro_torch.core import timing as ptiming  # noqa: E402
from repro_torch.core.delay import WORKLOADS as PWORKLOADS  # noqa: E402
from repro_torch.core.graph import make_graph  # noqa: E402
from repro_torch.design import batched as pbatched  # noqa: E402
from repro_torch.design import catalog as pcatalog  # noqa: E402
from repro_torch.networks.registry import get_network as pget  # noqa: E402

TOPOLOGIES = ("star", "matcha", "matcha_plus", "mst", "dmbst", "ring",
              "multigraph")
WORKLOADS = ("femnist", "sentiment140", "inaturalist")
ROUNDS = 512
REC_FIELDS = ("pair_i", "pair_j", "d0", "pair_comp", "strong", "trans",
              "lone_comp", "iso_count", "comp")


def _plans(make_plan, get_network, workloads, net, **kw):
    return [make_plan(topo, get_network(net), workloads[wl], t=t, **kw)
            for wl in WORKLOADS for topo in TOPOLOGIES
            for t in ((3, 5) if topo == "multigraph" else (5,))]


def _same_plan(p, r, rounds=ROUNDS):
    assert (p.kind, p.topology, p.network, p.workload, p.num_states,
            p.num_nodes) == (r.kind, r.topology, r.network, r.workload,
                             r.num_states, r.num_nodes)
    if p.kind == "recurrence":
        for f in REC_FIELDS:
            x, y = getattr(p, f), getattr(r, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert p.overlay.pairs == r.overlay.pairs
    else:
        np.testing.assert_array_equal(p.period(), r.period())
    np.testing.assert_array_equal(p.cycle_times(rounds),
                                  r.cycle_times(rounds))


@pytest.mark.parametrize("retire", [True, False])
@pytest.mark.parametrize("net", ["gaia", "geant"])
def test_grid_reports_equal_per_cell_and_reference(net, retire):
    """Every topology (the multigraph at t = 3 and 5) x workload on one
    network, stacked in one grid: each row equals its cell's own
    `cycle_times`, each report the cell's `report` and the reference
    grid's report."""
    pplans = _plans(ptiming.make_timing_plan, pget, PWORKLOADS, net)
    rplans = _plans(rtiming.make_timing_plan, rget, RWORKLOADS, net)
    pgrid = ptiming.build_timing_grid(pplans)
    rgrid = rtiming.build_timing_grid(rplans)
    assert pgrid.rec_rows == rgrid.rec_rows and len(pgrid.rec_rows) == 6
    for f in ("d0", "pair_comp", "strong", "trans", "lone_comp",
              "num_states"):
        np.testing.assert_array_equal(getattr(pgrid, f), getattr(rgrid, f),
                                      err_msg=f)
    mat = pgrid.cycle_time_matrix(ROUNDS, retire=retire)
    np.testing.assert_array_equal(
        mat, rgrid.cycle_time_matrix(ROUNDS, retire=retire))
    preps = pgrid.reports(ROUNDS, retire=retire)
    rreps = rgrid.reports(ROUNDS, retire=retire)
    for c, (plan, prep, rrep) in enumerate(zip(pplans, preps, rreps)):
        np.testing.assert_array_equal(mat[c], plan.cycle_times(ROUNDS))
        assert prep == plan.report(ROUNDS)
        assert dataclasses.asdict(prep) == dataclasses.asdict(rrep)


def test_grid_backend_numpy_only():
    plans = [ptiming.make_timing_plan("multigraph", pget("gaia"),
                                      PWORKLOADS["femnist"]),
             ptiming.make_timing_plan("star", pget("gaia"),
                                      PWORKLOADS["femnist"])]
    for grid in (ptiming.build_timing_grid(plans),
                 ptiming.build_timing_grid(plans[1:])):
        for call in (grid.reports, grid.cycle_time_matrix):
            with pytest.raises(ValueError, match="backend"):
                call(64, backend="jax")
    assert ptiming.build_timing_grid(plans[1:]).rec_rows == ()


@pytest.mark.parametrize("seed", range(6))
def test_grid_recurrence_and_hashes_random_cells(seed):
    """Ragged random cells (small and large pair counts, odd state
    counts): `_grid_recurrence_taus` and `_snapshot_hashes` equal the
    reference's, retirement on and off, and each row the cell's own."""
    rng = np.random.default_rng(seed)
    net = pget("geant")
    plans = []
    for _ in range(int(rng.integers(2, 5))):
        n = net.num_silos
        ring = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]
        extra = [(i, j) for i in range(n) for j in range(i + 2, n)
                 if rng.random() < 0.05]
        overlay = make_graph(n, ring + extra)
        plans.append(ptiming.multigraph_timing_plan(
            net, PWORKLOADS["femnist"], t=int(rng.integers(2, 7)),
            overlay=overlay))
    grid = ptiming.build_timing_grid(plans)
    args = (grid.d0, grid.pair_comp, grid.strong, grid.trans,
            grid.lone_comp, grid.num_states)
    rounds = int(rng.integers(50, 400))
    for retire in (True, False):
        got = ptiming._grid_recurrence_taus(*args, rounds, retire=retire)
        np.testing.assert_array_equal(
            got, rtiming._grid_recurrence_taus(*args, rounds,
                                               retire=retire))
        for c, plan in enumerate(plans):
            np.testing.assert_array_equal(got[c], plan.cycle_times(rounds))
    c, e = grid.d0.shape
    d = rng.uniform(1, 500, size=(2, c, e))
    tau = rng.uniform(1, 500, size=c)
    phase = rng.integers(0, 60, size=c)
    w = rng.integers(0, 2**63, e, np.uint64) * np.uint64(2) + np.uint64(1)
    np.testing.assert_array_equal(
        ptiming._snapshot_hashes(d[0], d[1], tau, phase, w),
        rtiming._snapshot_hashes(d[0], d[1], tau, phase, w))


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_make_timing_plan_equal(topology):
    """`make_timing_plan` per topology on gaia and geant, with and
    without a shared `DesignContext`, equal to the reference's."""
    for net in ("gaia", "geant"):
        p, r = pget(net), rget(net)
        for wl in ("femnist", "inaturalist"):
            pw, rw = PWORKLOADS[wl], RWORKLOADS[wl]
            want = rtiming.make_timing_plan(topology, r, rw, t=4, seed=2,
                                            sample_rounds=300)
            for ctx in (None, pbatched.DesignContext(p)):
                got = ptiming.make_timing_plan(topology, p, pw, t=4, seed=2,
                                               sample_rounds=300, ctx=ctx)
                _same_plan(got, want, 300)
            rctx = rbatched.DesignContext(r)
            _same_plan(ptiming.make_timing_plan(
                topology, p, pw, t=4, seed=2, sample_rounds=300,
                ctx=pbatched.DesignContext(p)),
                rtiming.make_timing_plan(topology, r, rw, t=4, seed=2,
                                         sample_rounds=300, ctx=rctx), 300)
    if topology in ("ring", "multigraph"):
        p, r = pget("gaia"), rget("gaia")
        overlay = make_graph(11, [(i, (i + 1) % 11) for i in range(11)])
        _same_plan(
            ptiming.make_timing_plan(topology, p, PWORKLOADS["femnist"],
                                     overlay=overlay),
            rtiming.make_timing_plan(topology, r, RWORKLOADS["femnist"],
                                     overlay=overlay))


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_get_family_equal(topology):
    """`get_family` gives the reference's family (same knobs), whose
    `build` gives the same design and `timing_plan` the same plan."""
    kw = dict(t=3, cap_states=30, seed=4, sample_rounds=256)
    pf = pcatalog.get_family(topology, **kw)
    rf = rcatalog.get_family(topology, **kw)
    rknobs = dataclasses.asdict(rf)
    rknobs.pop("budget", None)        # a module constant in the port
    rknobs.pop("delta", None)
    assert type(pf).__name__ == type(rf).__name__
    assert dataclasses.asdict(pf) == rknobs
    assert pcatalog.get_family(topology) == \
        pcatalog.DESIGN_FAMILIES[topology]
    p, r = pget("geant"), rget("geant")
    pw, rw = PWORKLOADS["sentiment140"], RWORKLOADS["sentiment140"]
    for pctx, rctx in ((None, None), (pbatched.DesignContext(p),
                                      rbatched.DesignContext(r))):
        pd, rd = pf.build(p, pw, pctx), rf.build(r, rw, rctx)
        if topology == "multigraph":
            assert pd.multiplicity == rd.multiplicity
        elif topology.startswith("matcha"):
            assert (pd.matchings, pd.budget, pd.seed) == \
                (rd.matchings, rd.budget, rd.seed)
        else:
            assert pd.round_graph(0).pairs == rd.round_graph(0).pairs
        _same_plan(pf.timing_plan(p, pw, ctx=pctx),
                   rf.timing_plan(r, rw, ctx=rctx), 256)
    with pytest.raises(KeyError, match="unknown topology"):
        pcatalog.get_family("torus")
