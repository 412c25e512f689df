"""The port's batched construction (`repro_torch.design.batched`)
against `repro.design.batched`: the batched graph algorithms (the
reference calls networkx, the port follows its order), the factorized
MATCHA sampler, the per-network `DesignContext`, the sweep's
`SweepConstructor`, candidate stacking and the `CandidateScorer` (its
torch backend on the CPU and its numpy backend, against the
reference's numpy backend). Every comparison is exact.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
nx = pytest.importorskip("networkx")

from repro.core import timing as rtiming  # noqa: E402
from repro.core.delay import WORKLOADS as RWORKLOADS  # noqa: E402
from repro.design import batched as rbatched  # noqa: E402
from repro.design import catalog as rcatalog  # noqa: E402
from repro.networks import zoo as rzoo  # noqa: E402
from repro.networks.registry import get_network as rget  # noqa: E402

from repro_torch.core import timing as ptiming  # noqa: E402
from repro_torch.core.delay import WORKLOADS as PWORKLOADS  # noqa: E402
from repro_torch.core.multigraph import build_multigraph  # noqa: E402
from repro_torch.design import batched as pbatched  # noqa: E402
from repro_torch.design import catalog as pcatalog  # noqa: E402
from repro_torch.networks import zoo as pzoo  # noqa: E402
from repro_torch.networks.registry import get_network as pget  # noqa: E402

TOPOLOGIES = ("star", "matcha", "matcha_plus", "mst", "dmbst", "ring",
              "multigraph")


def _tiny_nets(n, hetero=True):
    """The same small random network in both packages."""
    rng = np.random.default_rng(n)
    lat = rng.uniform(1.0, 5.0, (n, n))
    lat = np.maximum(lat, lat.T)
    np.fill_diagonal(lat, 0.0)
    out = []
    for zoo in (pzoo, rzoo):
        silos = tuple(
            zoo.Silo(name=f"s{i}", lat=float(i), lon=0.0,
                     upload_gbps=10.0 * (1.0 + 0.1 * i if hetero else 1.0),
                     download_gbps=10.0 * (1.0 + 0.07 * i if hetero
                                           else 1.0),
                     compute_scale=1.0 + (0.05 * i if hetero else 0.0))
            for i in range(n))
        out.append(zoo.NetworkSpec(name=f"tiny{n}", silos=silos,
                                   latency_ms=lat.copy()))
    return out


def _weights(rng, n, kind):
    """Symmetric weights with a zero diagonal: points in the plane, or
    small integers, where ties are frequent."""
    if kind == "int":
        d = rng.integers(1, 4, (n, n)).astype(np.float64)
        d = np.minimum(d, d.T)
    else:
        pts = rng.uniform(0.0, 100.0, (n, 2))
        d = np.hypot(pts[:, 0][:, None] - pts[:, 0][None, :],
                     pts[:, 1][:, None] - pts[:, 1][None, :])
    np.fill_diagonal(d, 0.0)
    return d


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("seed", range(4))
def test_min_weight_matchings_and_tours_equal(seed, kind):
    """`min_weight_matchings` equals the reference's (networkx's
    `min_weight_matching`) as a set per node set, on subsets of even and
    odd size, with ties; `christofides_tours` equals the reference's;
    duplicates are solved once and agree."""
    rng = np.random.default_rng(100 * seed + (kind == "int"))
    mats, nodesets = [], []
    for _ in range(4):
        n = int(rng.integers(4, 13))
        mats.append(_weights(rng, n, kind))
        k = int(rng.integers(2, n + 1))
        nodesets.append(sorted(int(v) for v in
                               rng.choice(n, size=k, replace=False)))
    mats.append(mats[0].copy())
    nodesets.append(list(nodesets[0]))
    got = pbatched.min_weight_matchings(mats, nodesets)
    assert got == rbatched.min_weight_matchings(mats, nodesets)
    assert got[-1] == got[0]
    assert pbatched.min_weight_matchings(mats[:2]) == \
        rbatched.min_weight_matchings(mats[:2])
    tours = pbatched.christofides_tours(mats)
    assert tours == rbatched.christofides_tours(mats)
    assert tours == [pcatalog.christofides_cycle(d) for d in mats]


@pytest.mark.parametrize("n", [4, 5, 6, 7])
def test_factorized_sampler_equal_tiny(n):
    """Complete bases of even and odd size: the factorized path, against
    the reference's and the port's general `sampled_cycle_times`."""
    pnet, rnet = _tiny_nets(n)
    pw, rw = PWORKLOADS["femnist"], RWORKLOADS["femnist"]
    pd = pcatalog.matcha_topology(pnet, pw, seed=3)
    rd = rcatalog.matcha_topology(rnet, rw, seed=3)
    assert pbatched._detect_factorization(pd.matchings, n) is not None
    got = pbatched.batched_sampled_cycle_times(pd, pnet, pw, 300)
    np.testing.assert_array_equal(
        got, rbatched.batched_sampled_cycle_times(rd, rnet, rw, 300))
    np.testing.assert_array_equal(
        got, ptiming.sampled_cycle_times(pd, pnet, pw, 300))


@pytest.mark.parametrize("net,topology", [("gaia", "matcha"),
                                          ("amazon", "matcha"),
                                          ("geant", "matcha_plus")])
def test_factorized_sampler_equal_paper(net, topology):
    p, r = pget(net), rget(net)
    pw, rw = PWORKLOADS["inaturalist"], RWORKLOADS["inaturalist"]
    pd = pcatalog.build_topology(topology, p, pw, seed=1)
    rd = rcatalog.build_topology(topology, r, rw, seed=1)
    act = rd.activation_matrix(400)
    np.testing.assert_array_equal(
        pbatched.batched_sampled_cycle_times(pd, p, pw, 400),
        rbatched.batched_sampled_cycle_times(rd, r, rw, 400, act=act))
    np.testing.assert_array_equal(
        pbatched.batched_sampled_cycle_times(pd, p, pw, 400, act=act),
        ptiming.sampled_cycle_times(pd, p, pw, 400))


@pytest.mark.parametrize("net", ["gaia", "geant"])
def test_design_context_equal(net):
    """The context's shared artifacts equal the reference context's and
    a fresh construction; MATCHA and MATCHA+ share one horizon on the
    cloud networks."""
    p, r = pget(net), rget(net)
    pc, rc = pbatched.DesignContext(p), rbatched.DesignContext(r)
    for wl in ("femnist", "inaturalist"):
        pw, rw = PWORKLOADS[wl], RWORKLOADS[wl]
        np.testing.assert_array_equal(pc.nominal(pw), rc.nominal(rw))
        assert pc.ring_graph(pw).pairs == rc.ring_graph(rw).pairs
        assert pc.ring_graph(pw).pairs == \
            pcatalog.ring_topology(p, pw).graph.pairs
    # MATCHA+'s base: the connectivity graph of a cloud network, else
    # the physical underlay the reference's context builds
    want = rcatalog.connectivity_graph(r) if net == "gaia" else rc.physical()
    assert pcatalog.matcha_plus_base(p).pairs == want.pairs
    assert pc.matcha_matchings() == rc.matcha_matchings()
    assert pc.matcha_plus_matchings() == rc.matcha_plus_matchings()
    pw = PWORKLOADS["femnist"]
    for fam in ("matcha", "matcha_plus"):
        pcatalog.get_family(fam, sample_rounds=100).timing_plan(
            p, pw, ctx=pc).cycle_times(100)
    assert len(pc._sampled) == (1 if net == "gaia" else 2)


def test_sweep_constructor_plans_equal():
    """`SweepConstructor.make_plan` over every topology x network x
    workload of a reduced grid equals the reference's and the per-cell
    `make_timing_plan`, report for report."""
    pctor, rctor = pbatched.SweepConstructor(), rbatched.SweepConstructor()
    for net in ("gaia", "amazon", "geant"):
        for wl in ("femnist", "sentiment140"):
            for topo in TOPOLOGIES:
                for t in ((3, 5) if topo == "multigraph" else (5,)):
                    kw = dict(t=t, seed=2, sample_rounds=600)
                    got = pctor.make_plan(topo, pget(net), PWORKLOADS[wl],
                                          **kw)
                    want = rctor.make_plan(topo, rget(net), RWORKLOADS[wl],
                                           **kw)
                    one = ptiming.make_timing_plan(topo, pget(net),
                                                   PWORKLOADS[wl], **kw)
                    np.testing.assert_array_equal(got.cycle_times(600),
                                                  want.cycle_times(600))
                    assert got.report(600).row() == want.report(600).row()
                    assert got.report(600) == one.report(600)
    assert pctor.context(pget("gaia")) is pctor.context(pget("gaia"))


def _candidates(overlay, rng, count):
    base = [(1,) * len(overlay.pairs), (5,) * len(overlay.pairs)]
    return base + [tuple(int(m) for m in rng.integers(1, 7, len(
        overlay.pairs))) for _ in range(count)]


@pytest.mark.parametrize("net", ["gaia", "geant"])
def test_stack_and_score_equal(net):
    """`stack_multiplicity_candidates` and `CandidateScorer.score` (with
    and without observed-delay overrides, capped and uncapped) equal the
    reference's numpy backend bit for bit, and each score the mean of
    the candidate's own plan's cycle times."""
    p, r = pget(net), rget(net)
    pw, rw = PWORKLOADS["femnist"], RWORKLOADS["femnist"]
    overlay = pcatalog.ring_topology(p, pw).graph
    rng = np.random.default_rng(5)
    cands = _candidates(overlay, rng, 10)
    comp = pw.compute_ms(p).astype(np.float64)
    for cap in (ptiming.CAP_STATES, 20, None):
        got = pbatched.stack_multiplicity_candidates(overlay, comp, cands,
                                                     cap_states=cap)
        want = rbatched.stack_multiplicity_candidates(overlay, comp, cands,
                                                      cap_states=cap)
        for f in ("capped", "num_states", "strong", "trans", "lone_comp"):
            x, y = getattr(got, f), getattr(want, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    d0 = rng.uniform(5.0, 90.0, len(overlay.pairs))
    co = comp * rng.uniform(1.0, 2.0, p.num_silos)
    for kw in (dict(), dict(d0_override=d0, comp_override=co),
               dict(cap_states=12)):
        want = rbatched.CandidateScorer(r, rw, overlay, rounds=700,
                                        backend="numpy", **kw).score(cands)
        for backend in ("torch", "numpy"):
            got = pbatched.CandidateScorer(p, pw, overlay, rounds=700,
                                           backend=backend, device="cpu",
                                           **kw).score(cands)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    got = pbatched.CandidateScorer(p, pw, overlay, rounds=700,
                                   device="cpu").score(cands)
    for vec, score in zip(cands[:4], got):
        plan = ptiming.multiplicity_vector_plan(p, pw, overlay, vec,
                                                name="search")
        assert score == float(plan.cycle_times(700).mean())
    assert pbatched.CandidateScorer(
        p, pw, overlay, rounds=10, device="cpu").score([]).shape == (0,)


def test_scorer_refusals():
    p, pw = pget("gaia"), PWORKLOADS["femnist"]
    overlay = pcatalog.ring_topology(p, pw).graph
    with pytest.raises(ValueError, match="backend"):
        pbatched.CandidateScorer(p, pw, overlay, rounds=10, backend="jax")
    with pytest.raises(ValueError, match="d0_override shape"):
        pbatched.CandidateScorer(p, pw, overlay, rounds=10,
                                 d0_override=np.ones(3))
    with pytest.raises(ValueError, match=">= 1"):
        pbatched.stack_multiplicity_candidates(
            overlay, pw.compute_ms(p), [(0,) * len(overlay.pairs)])
    mg = build_multigraph(p, pw, overlay, t=5)
    vec = tuple(mg.multiplicity[q] for q in overlay.pairs)
    assert pbatched.CandidateScorer(p, pw, overlay, rounds=300,
                                    device="cpu").score(
        [vec])[0] == ptiming.multigraph_timing_plan(
            p, pw, t=5).report(300).mean_cycle_ms
    assert rtiming.CAP_STATES == ptiming.CAP_STATES
