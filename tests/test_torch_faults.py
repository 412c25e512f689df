"""The port's fault layer (`repro_torch.faults`) against `repro.faults`:
every scenario's per-round arrays in any round order, `FaultedSession`
segments (static and adaptive, chunked and whole, with a plan swap),
the nominal identity, `scenario_overrides` and the degradation helpers.
Numpy on both sides: every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import faults as rfaults  # noqa: E402
from repro.core import timing as rtiming  # noqa: E402
from repro.core.delay import WORKLOADS as RWORKLOADS  # noqa: E402
from repro.fl import dpasgd as rdpasgd, runtime as rruntime  # noqa: E402
from repro.networks.registry import get_network as rget  # noqa: E402

from repro_torch import faults as pfaults  # noqa: E402
from repro_torch.core import timing as ptiming  # noqa: E402
from repro_torch.core.delay import WORKLOADS as PWORKLOADS  # noqa: E402
from repro_torch.design.catalog import ring_topology  # noqa: E402
from repro_torch.fl import dpasgd as pdpasgd, runtime as pruntime  # noqa: E402
from repro_torch.networks.registry import get_network as pget  # noqa: E402

SCENARIOS = sorted(rfaults.SCENARIOS)
SEG_FIELDS = ("taus", "planned", "eff", "dead", "base", "crashed",
              "comp_obs", "paid_timeout", "phases", "obs")


def _plans(net, t=5):
    return (ptiming.multigraph_timing_plan(pget(net), PWORKLOADS["femnist"],
                                           t=t),
            rtiming.multigraph_timing_plan(rget(net), RWORKLOADS["femnist"],
                                           t=t))


def _same_segment(p, r):
    assert p.start == r.start
    for f in SEG_FIELDS:
        x, y = getattr(p, f), getattr(r, f)
        if y is None:
            assert x is None, f
            continue
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_registry_equal():
    assert sorted(pfaults.SCENARIOS) == SCENARIOS
    for name in SCENARIOS:
        assert dataclasses.asdict(pfaults.get_scenario(name)) == \
            dataclasses.asdict(rfaults.get_scenario(name))
    assert pfaults.NOMINAL.is_nominal and pfaults.NOMINAL.name == "nominal"
    assert dataclasses.asdict(pfaults.DegradePolicy()) == \
        dataclasses.asdict(rfaults.DegradePolicy())
    assert sorted(pfaults.__all__) == sorted(rfaults.__all__)
    with pytest.raises(ValueError, match="unknown scenario"):
        pfaults.get_scenario("no-such-scenario")


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_arrays_equal_any_order(name):
    """Each scenario's arrays equal the reference's for the same rounds,
    in order, shuffled and as a subset, for 11 and 40 silos."""
    psched = pfaults.get_scenario(name).schedule
    rsched = rfaults.get_scenario(name).schedule
    rng = np.random.default_rng(3)
    for n in (11, 40):
        for rounds in (np.arange(96), rng.permutation(96),
                       np.arange(17, 60), rng.integers(0, 10_000, 50)):
            got, want = psched.arrays(rounds, n), rsched.arrays(rounds, n)
            for f in ("link_scale", "comp_scale", "crashed", "flapped"):
                x, y = getattr(got, f), getattr(want, f)
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
        full = psched.arrays(np.arange(96), n)
        perm = rng.permutation(96)
        shuf = psched.arrays(perm, n)
        np.testing.assert_array_equal(full.comp_scale[perm], shuf.comp_scale)
        np.testing.assert_array_equal(full.crashed[perm], shuf.crashed)


def test_custom_events_equal():
    """Every event kind with its knobs off their defaults, two seeds."""
    kw = dict(silos=(1, 4, 30), start=3, stop=70)
    events = [dict(kind="link_drift", peak_scale=3.0, ramp_rounds=5),
              dict(kind="diurnal", amplitude=0.5, period=12),
              dict(kind="flash", rate=0.4, duration=3, spike_scale=9.0),
              dict(kind="churn", rate=0.3, duration=4),
              dict(kind="crash"), dict(kind="link_loss", rate=0.2)]
    for seed in (0, 7):
        p = pfaults.FaultSchedule("x", tuple(
            pfaults.FaultEvent(**kw, **e) for e in events), seed=seed)
        r = rfaults.FaultSchedule("x", tuple(
            rfaults.FaultEvent(**kw, **e) for e in events), seed=seed)
        got, want = p.arrays(np.arange(80), 12), r.arrays(np.arange(80), 12)
        for f in ("link_scale", "comp_scale", "crashed", "flapped"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    bad = pfaults.FaultSchedule("x", (pfaults.FaultEvent(kind="meteor"),))
    with pytest.raises(ValueError, match="unknown fault kind"):
        bad.arrays(np.arange(4), 3)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("name", SCENARIOS)
def test_session_segments_equal(name, adaptive):
    """`FaultedSession` with `record_obs=True` on the gaia and geant
    multigraphs, whole and in chunks, equal to the reference's segment
    for segment; a chunked run equals the whole one."""
    psc, rsc = pfaults.get_scenario(name), rfaults.get_scenario(name)
    for net in ("gaia", "geant"):
        pplan, rplan = _plans(net)
        pol = dict(timeout_ms=psc.timeout_ms, max_stale=psc.max_stale,
                   adaptive=adaptive)
        ps = pfaults.FaultedSession(pplan, psc.schedule,
                                    pfaults.DegradePolicy(**pol),
                                    record_obs=True)
        rs = rfaults.FaultedSession(rplan, rsc.schedule,
                                    rfaults.DegradePolicy(**pol),
                                    record_obs=True)
        whole = ps.advance(90)
        _same_segment(whole, rs.advance(90))
        ps = pfaults.FaultedSession(pplan, psc.schedule,
                                    pfaults.DegradePolicy(**pol))
        rs = rfaults.FaultedSession(rplan, rsc.schedule,
                                    rfaults.DegradePolicy(**pol))
        taus = []
        for k in (7, 40, 43):
            seg = ps.advance(k)
            _same_segment(seg, rs.advance(k))
            taus.append(seg.taus)
        np.testing.assert_array_equal(np.concatenate(taus), whole.taus)
        assert ps.round == rs.round == 90


def test_swap_plan_equal():
    """A live swap to another multiplicity vector mid-run carries the
    delay state across, as the reference's does; a plan over other
    pairs, or a cyclic plan, is refused."""
    pnet, rnet = pget("gaia"), rget("gaia")
    pw, rw = PWORKLOADS["femnist"], RWORKLOADS["femnist"]
    pplan, rplan = _plans("gaia")
    overlay = ring_topology(pnet, pw).graph
    vec = (1, 2, 1, 3, 1, 2, 2, 1, 3, 1, 2)
    pswap = ptiming.multiplicity_vector_plan(pnet, pw, overlay, vec,
                                             name="search")
    rswap = rtiming.multiplicity_vector_plan(rnet, rw, rplan.overlay, vec,
                                             name="search")
    sc = "churn"
    ps = pfaults.FaultedSession(pplan, pfaults.get_scenario(sc).schedule)
    rs = rfaults.FaultedSession(rplan, rfaults.get_scenario(sc).schedule)
    _same_segment(ps.advance(13), rs.advance(13))
    ps.swap_plan(pswap)
    rs.swap_plan(rswap)
    _same_segment(ps.advance(29), rs.advance(29))
    other = ptiming.multigraph_timing_plan(pget("amazon"), pw)
    with pytest.raises(ValueError, match="overlay pair set"):
        ps.swap_plan(other)
    with pytest.raises(ValueError, match="recurrence"):
        pfaults.FaultedSession(ptiming.star_timing_plan(pnet, pw))
    with pytest.raises(ValueError, match="recurrence"):
        ps.swap_plan(ptiming.star_timing_plan(pnet, pw))


@pytest.mark.parametrize("net", ["gaia", "amazon", "geant"])
def test_nominal_identity(net):
    """Under the nominal schedule the session's taus are the plan's
    `cycle_times` bit for bit, whole and chunked."""
    pplan, _ = _plans(net)
    want = pplan.cycle_times(150)
    np.testing.assert_array_equal(
        pfaults.FaultedSession(pplan).advance(150).taus, want)
    sess = pfaults.FaultedSession(pplan)
    np.testing.assert_array_equal(
        np.concatenate([sess.advance(k).taus for k in (1, 64, 85)]), want)
    arr = pfaults.NOMINAL.arrays(np.arange(20), 5)
    assert (arr.link_scale == 1.0).all() and (arr.comp_scale == 1.0).all()
    assert not arr.crashed.any() and not arr.flapped.any()


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_overrides_equal(name):
    for net in ("gaia", "geant"):
        p, r = pget(net), rget(net)
        pw, rw = PWORKLOADS["femnist"], RWORKLOADS["femnist"]
        got = pfaults.scenario_overrides(pfaults.get_scenario(name), p, pw,
                                         ring_topology(p, pw).graph, 120)
        want = rfaults.scenario_overrides(
            rfaults.get_scenario(name), r, rw,
            _plans(net)[1].overlay, 120)
        if name == "nominal":
            assert got == want == (None, None)
            continue
        for x, y in zip(got, want):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_degrade_helpers_equal():
    rng = np.random.default_rng(2)
    pplan, rplan = _plans("gaia")
    down = rng.random((9, 11)) < 0.2
    np.testing.assert_array_equal(
        pfaults.crashed_pair_mask(pplan.pair_i, pplan.pair_j, down),
        rfaults.crashed_pair_mask(rplan.pair_i, rplan.pair_j, down))
    np.testing.assert_array_equal(
        pfaults.crashed_pair_mask(pplan.pair_i, pplan.pair_j, down[0]),
        rfaults.crashed_pair_mask(rplan.pair_i, rplan.pair_j, down[0]))
    pp, _ = pdpasgd.make_round_schedule("multigraph", pget("gaia"),
                                        PWORKLOADS["femnist"])
    rp, _ = rdpasgd.make_round_schedule("multigraph", rget("gaia"),
                                        RWORKLOADS["femnist"])
    porder, _ = pruntime.gossip_ops.csr_sort(pp.dst, 11)
    rorder = rruntime.make_flat_runtime(
        rp, {"w": np.zeros(3, np.float32)}, 11).order
    np.testing.assert_array_equal(porder, rorder)
    mask = rng.random((9, len(pplan.pair_i))) < 0.5
    np.testing.assert_array_equal(
        pfaults.pair_rounds_to_directed(porder, mask),
        rfaults.pair_rounds_to_directed(rorder, mask))
