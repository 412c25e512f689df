"""The port's fault controller (`repro_torch.design.controller`) against
`repro.design.controller` on the CPU.

Both packages build the tiny harness (24 rounds, re-planning every 12,
16 samples a silo, batch 4, lr 0.001) from the reference's initial row
and run it under nominal and churn, static and adaptive. What the
controller decides is numpy on simulated time, so swap rounds, vectors,
cycle times, demotions and `vec0` are equal exactly; the losses, which
train in fp32 on each side, within rtol 1e-5, and the accuracy within
one of the 512 test samples.

The harness runs at seed 3, the seed of the frontier parity tests
(`test_torch_tta.py`). At seeds 0 and 1 the tiny harness meets a
max-pool near-tie in round 0 (seed 0: silo 9's second pool, window
values 0.3480159 and 0.3480166 in float64, which the port's fp32
convolution orders the other way; ROADMAP queue 3 records the same
window). The port's silo gradient is then 5.5e-3 off float64 where the
reference's is 5e-7 off, and the churn scenario's isolated silos carry
that to 2.8e-4 relative (seed 0) and 1.1e-4 (seed 1) in the mean loss:
rounding, not the controller. The decisions are equal at every seed.

In the port: nominal static and adaptive are bit-equal with no swap,
churn's adaptive run beats the static one on time to a shared target,
every run of the harness goes through the one cycle function it built,
and the nominal static run is `run_fl` of the same configuration bit for
bit. A traced churn run records the reference's simulated spans and
controller instants.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from _torch_fl_parity import reference_init, start_port_from  # noqa: E402
from repro.design import controller as rcontroller  # noqa: E402
from repro.obs import TraceRecorder as RRecorder  # noqa: E402

from repro_torch.design import controller as pcontroller  # noqa: E402
from repro_torch.design.evaluate import smoothed_losses  # noqa: E402
from repro_torch.fl import FLConfig, run_fl  # noqa: E402
from repro_torch.fl import runtime as pruntime  # noqa: E402
from repro_torch.obs import (TraceRecorder, to_trace_json,  # noqa: E402
                             validate_trace)

KW = dict(rounds=24, replan_every=12, samples_per_silo=16, batch_size=4,
          lr=0.001, seed=3)
RUNS = [("nominal", False), ("nominal", True), ("churn", False),
        ("churn", True)]
EXACT = ("scenario", "adaptive", "swap_rounds", "vectors", "demoted_rounds")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Port and reference runs of RUNS (the adaptive churn run traced on
    both sides; the port's adaptive nominal run writes its trace file
    through ``ControllerConfig(trace=)``), the port's harness and its
    `make_cycle_fn` builds."""
    built = []
    make = pruntime.make_cycle_fn

    def counting(*a, **k):
        built.append(1)
        return make(*a, **k)

    init = reference_init("femnist_cnn", 11, seed=KW["seed"])
    with pytest.MonkeyPatch.context() as mp:
        start_port_from(mp, "femnist_cnn", init)
        mp.setattr(pruntime, "make_cycle_fn", counting)
        ph = pcontroller.ControllerHarness(pcontroller.ControllerConfig(**KW),
                                           device="cpu")
        rec = TraceRecorder()
        path = tmp_path_factory.mktemp("trace") / "nominal.json"
        got = {}
        for s, a in RUNS:
            ph.cfg = dataclasses.replace(
                ph.cfg, options=None,
                trace=str(path) if (s, a) == RUNS[1] else None)
            got[s, a] = ph.run(s, adaptive=a,
                               recorder=rec if (s, a) == RUNS[3] else None)
        builds = len(built)
        # the nominal static run again, for `run_fl`: same initial row
        one = run_fl(FLConfig(dataset="femnist", network="gaia",
                              topology="multigraph", rounds=KW["rounds"],
                              eval_every=KW["rounds"], lr=KW["lr"],
                              batch_size=KW["batch_size"],
                              samples_per_silo=KW["samples_per_silo"],
                              seed=KW["seed"]), device="cpu")
    rh = rcontroller.ControllerHarness(rcontroller.ControllerConfig(**KW))
    rrec = RRecorder()
    want = {(s, a): rh.run(s, adaptive=a,
                           recorder=rrec if (s, a) == RUNS[3] else None)
            for s, a in RUNS}
    return dict(got=got, want=want, ph=ph, rh=rh, built=builds,
                rec=rec, rrec=rrec, run_fl=one, trace_file=path)


@pytest.mark.parametrize("key", RUNS, ids=[f"{s}-{a}" for s, a in RUNS])
def test_run_matches_reference(runs, key):
    got, want = runs["got"][key], runs["want"][key]
    for f in EXACT:
        assert getattr(got, f) == getattr(want, f), f
    assert got.cycle_times_ms.dtype == want.cycle_times_ms.dtype
    np.testing.assert_array_equal(got.cycle_times_ms, want.cycle_times_ms)
    assert got.total_time_s == want.total_time_s
    assert got.losses.shape == (KW["rounds"],)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert abs(got.final_acc - want.final_acc) <= 1 / 512 + 1e-12


def test_harness_matches_reference(runs):
    ph, rh = runs["ph"], runs["rh"]
    assert ph.vec0 == rh.vec0
    assert ph.density_floor == rh.density_floor
    np.testing.assert_array_equal(ph.tplan0.cycle_times(200),
                                  rh.tplan0.cycle_times(200))
    for f in ("order", "row_ptr", "src_sorted", "strong", "coeffs", "diag"):
        np.testing.assert_array_equal(getattr(ph.rt0, f),
                                      getattr(rh.rt0, f), err_msg=f)
    for k in ("x", "y"):
        np.testing.assert_array_equal(ph._batches[k].numpy(),
                                      np.asarray(rh._batches[k]))
    assert dataclasses.asdict(pcontroller.ControllerConfig()) == \
        dataclasses.asdict(rcontroller.ControllerConfig())


def test_port_invariants(runs):
    """Nominal static == adaptive bit for bit with no swap; churn's
    adaptive run swaps and wins on time to the worse of the two smoothed
    minima; one cycle function for the whole matrix."""
    got, ph = runs["got"], runs["ph"]
    st, ad = got["nominal", False], got["nominal", True]
    np.testing.assert_array_equal(st.losses, ad.losses)
    np.testing.assert_array_equal(st.cycle_times_ms, ad.cycle_times_ms)
    assert st.final_acc == ad.final_acc
    assert ad.swap_rounds == () and ad.vectors == (ph.vec0,)
    np.testing.assert_array_equal(st.cycle_times_ms,
                                  ph.tplan0.cycle_times(KW["rounds"]))
    st, ad = got["churn", False], got["churn", True]
    assert ad.swap_rounds and len(ad.vectors) == len(ad.swap_rounds) + 1
    target = float(max(smoothed_losses(st.losses).min(),
                       smoothed_losses(ad.losses).min()) * (1 + 1e-9))
    assert ad.tta_s(target) < st.tta_s(target)
    assert ad.total_time_s < st.total_time_s
    assert runs["built"] == 1


def test_nominal_static_is_run_fl(runs):
    """The nominal static run trains exactly as `run_fl` of the same
    configuration: losses, accuracy and the simulated clock."""
    st, one = runs["got"]["nominal", False], runs["run_fl"]
    assert st.losses.tolist() == list(one.round_losses)
    assert st.final_acc == one.final_acc()
    assert st.cycle_times_ms.tolist() == list(one.cycle_times_ms)


def test_traced_run_matches_reference(runs):
    """The traced churn run: per-silo simulated spans and controller
    instants equal to the reference recorder's, one host span a
    segment, and a trace that validates."""
    rec, rrec = runs["rec"], runs["rrec"]
    run = runs["got"]["churn", True]
    assert rec.sim_events == rrec.sim_events
    assert rec.ctrl_events == rrec.ctrl_events
    assert [e["name"] for e in rec.ctrl_events].count("observe") == 1
    assert tuple(e["round"] for e in rec.ctrl_events
                 if e["name"] == "swap") == run.swap_rounds
    t = 0.0
    for k in range(KW["rounds"]):
        t += float(run.cycle_times_ms[k])
        assert rec.round_end_ms(k) == t
    assert [e["name"] for e in rec.host_events] == ["dispatch"] * 2
    assert validate_trace(to_trace_json(rec)) == []


def test_cfg_trace_writes_a_valid_file(runs):
    """``ControllerConfig(trace=)`` with no recorder writes the run's
    trace through `obs.write_trace`: one observe instant, no swap."""
    import json

    obj = json.loads(runs["trace_file"].read_text())
    assert validate_trace(obj) == []
    names = [e.get("name") for e in obj["traceEvents"]]
    assert names.count("observe") == 1 and "swap" not in names
    assert names.count("dispatch") == 2


def test_expand_pair_mask_and_alg1_match_reference(runs):
    ph, rh = runs["ph"], runs["rh"]
    rng = np.random.default_rng(4)
    for rows in (1, 7, 12):
        mask = rng.random((rows, len(ph.overlay.pairs))) < 0.5
        np.testing.assert_array_equal(ph.rt0.expand_pair_mask(mask),
                                      rh.rt0.expand_pair_mask(mask))
    for est in (rng.uniform(5, 90, 11), np.array([3.0, 3.0, 30.0]),
                np.array([0.0, 4.0]), np.array([-1.0, 2.0]),
                np.array([1.0, 1.49, 1.5, 2.5, 100.0])):
        for t_max in (1, 5, 8):
            assert pcontroller._alg1_vector(est, t_max) == \
                rcontroller._alg1_vector(est, t_max)


def test_refusals():
    with pytest.raises(ValueError, match="metrics"):
        pcontroller.ControllerConfig(metrics=object())
    with pytest.raises(ValueError, match="must divide"):
        pcontroller.ControllerConfig(rounds=24, replan_every=10)
    # mesh= builds (tests/test_torch_fl_mesh.py runs it); an unknown
    # gossip backend of the mesh runtime is refused as in the reference
    with pytest.raises(ValueError, match="backend"):
        pcontroller.ControllerHarness(pcontroller.ControllerConfig(
            mesh="auto", gossip="bogus"), device="cpu")
