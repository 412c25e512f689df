"""The port's observability layer against the reference's: the Eq. 4
delay replay (`TimingPlan.delay_history`), the trace recorder and its
export, the in-cycle metrics, and `run_fl`'s metrics and trace hooks.

The planning and trace layers are numpy on both sides, so those
comparisons are exact. The metrics' count columns (`stale_frac`,
`buf_age`, `gossip_bytes`) are fp32 arithmetic on the plan's masks and
match exactly too. The norm and per-silo loss columns come from fp32
sums over 11 x 1,280,478 values that torch and XLA:CPU reduce in
different orders, on weights that already differ by a few ulps (see
`test_torch_slice.py`), so they are held within NORM_RTOL.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from _torch_fl_parity import (assert_same_run, reference_init,  # noqa: E402
                              start_port_from)
from repro import obs as robs  # noqa: E402
from repro.core.delay import FEMNIST as RFEMNIST  # noqa: E402
from repro.data.synthetic import make_federated_dataset  # noqa: E402
from repro.faults import FaultedSession, get_scenario  # noqa: E402
from repro.fl import FLConfig as RConfig, run_fl as rrun_fl  # noqa: E402
from repro.fl import dpasgd as rdpasgd, flat as rflat  # noqa: E402
from repro.fl import runtime as rruntime  # noqa: E402
from repro.models.small import FEMNIST_CNN as RCNN  # noqa: E402
from repro.networks.registry import get_network as rget  # noqa: E402
from repro.optim import flat_sgd as rflat_sgd  # noqa: E402

from repro_torch import obs as pobs  # noqa: E402
from repro_torch.core.delay import FEMNIST as PFEMNIST  # noqa: E402
from repro_torch.fl import FLConfig as PConfig, run_fl as prun_fl  # noqa: E402
from repro_torch.fl import dpasgd as pdpasgd, flat as pflat  # noqa: E402
from repro_torch.fl import runtime as pruntime  # noqa: E402
from repro_torch.models import small as psmall  # noqa: E402
from repro_torch.networks.registry import get_network as pget  # noqa: E402
from repro_torch.optim import flat_sgd as pflat_sgd  # noqa: E402

TOPOLOGIES = ("star", "mst", "dmbst", "ring", "matcha", "matcha_plus",
              "multigraph")
COUNT_COLUMNS = ("stale_frac", "buf_age", "gossip_bytes")
#: Norm and silo-loss columns: about three times the largest relative
#: difference read (7.9e-6, one silo's loss after 8 rounds; the norms
#: under 7e-7).
NORM_RTOL = 2.5e-5
RUN = dict(rounds=8, eval_every=4, samples_per_silo=16, batch_size=4,
           lr=0.001)


def _plans(topology, net, rounds=40):
    """(port, reference) FEMNIST timing plans of one design."""
    _, rt = rdpasgd.make_round_schedule(topology, rget(net), RFEMNIST,
                                        rounds=rounds)
    _, pt = pdpasgd.make_round_schedule(topology, pget(net), PFEMNIST,
                                        rounds=rounds)
    return pt, rt


@pytest.mark.parametrize("net", ["gaia", "geant"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_delay_history_matches_reference(topology, net):
    pt, rt = _plans(topology, net)
    if rt.kind != "recurrence":
        for plan in (pt, rt):
            with pytest.raises(ValueError, match="recurrence"):
                plan.delay_history(4)
        return
    rounds = 37
    got, want = pt.delay_history(rounds), rt.delay_history(rounds)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], pt.cycle_times(rounds))


@pytest.mark.parametrize("topology", ["multigraph", "ring", "matcha"])
def test_sim_spans_match_reference(topology):
    """Recurrence (multigraph) and cyclic plans: the same events, and
    each round's end equal to the running sum of `cycle_times`."""
    pt, rt = _plans(topology, "gaia")
    rounds = 29
    prec, rrec = pobs.TraceRecorder(), robs.TraceRecorder()
    end = prec.add_sim_spans(pt, rounds, start_round=3, t0_ms=1.5)
    assert end == rrec.add_sim_spans(rt, rounds, start_round=3, t0_ms=1.5)
    assert prec.sim_events == rrec.sim_events
    t = 1.5
    for k, tau in enumerate(pt.cycle_times(rounds)):
        t += float(tau)
        assert prec.round_end_ms(3 + k) == t
    assert end == t


def _decorate(rec):
    """The same controller, serving and counter events on a recorder."""
    rec.meta.update(network="gaia", seed=3)
    rec.instant("swap", t_ms=1.0, round=2, vector=[1, 2])
    rec.request_span("req", t0_ms=2.0, dur_ms=3.5, region="eu", tokens=7)
    rec.request_span("req", t0_ms=1.0, dur_ms=1.0, region="us")
    starts = np.arange(6, dtype=np.float64) * 10.0
    rec.add_metrics(np.arange(12.0).reshape(6, 2), ("a", "b"), starts,
                    start_round=1)


def test_faulted_spans_and_trace_json_match_reference():
    """The port's recorder fed the reference's `FaultedSegment` (the
    port has no fault engine yet), then the whole trace object."""
    _, rt = _plans("multigraph", "gaia")
    sess = FaultedSession(rt, get_scenario("outage").schedule,
                          record_obs=True)
    seg = sess.advance(32)
    prec, rrec = pobs.TraceRecorder(), robs.TraceRecorder()
    end = prec.add_faulted_spans(rt.pair_i, rt.pair_j, seg)
    assert end == rrec.add_faulted_spans(rt.pair_i, rt.pair_j, seg)
    assert prec.sim_events == rrec.sim_events
    assert any(e["name"] == "down" for e in prec.sim_events)
    for rec in (prec, rrec):
        _decorate(rec)
    assert prec.counter_events == rrec.counter_events
    assert prec.events() == rrec.events()
    pobj = pobs.to_trace_json(prec, extra_meta={"run": 1})
    assert pobj == robs.to_trace_json(rrec, extra_meta={"run": 1})
    assert pobs.validate_trace(pobj) == []
    plain = FaultedSession(rt, get_scenario("drift").schedule).advance(4)
    with pytest.raises(ValueError, match="record_obs"):
        prec.add_faulted_spans(rt.pair_i, rt.pair_j, plain)


def test_validate_trace_catches_malformed():
    bad = {"traceEvents": [
        {"ph": "Z", "name": "x", "pid": 1},                      # phase
        {"ph": "X", "pid": 1, "ts": 0, "dur": 1},                # no name
        {"ph": "X", "name": "x", "pid": 1, "ts": -5, "dur": 1},  # neg ts
        {"ph": "X", "name": "x", "pid": 1, "ts": 0, "dur": -1},  # neg dur
        {"ph": "C", "name": "c", "pid": 1, "ts": 0,
         "args": {"v": "high"}},                                 # non-num
        {"ph": "i", "name": "i", "pid": 1, "ts": 1, "s": "q"},   # scope
        {"ph": "X", "name": "x", "pid": 1, "tid": 7, "ts": 9, "dur": 0},
        {"ph": "X", "name": "x", "pid": 1, "tid": 7, "ts": 3, "dur": 0},
    ]}
    errs = pobs.validate_trace(bad)
    assert len(errs) == 7  # one per defect, the non-monotone track too
    assert errs == robs.validate_trace(bad)
    for obj in ([], {"x": 1}, {"traceEvents": {}}):
        assert pobs.validate_trace(obj) == robs.validate_trace(obj) != []


def test_trace_files_cross_validate(tmp_path):
    """Each package's validator and run-record loader accept the other's
    files."""
    pt, rt = _plans("multigraph", "gaia")
    recs = {"port": pobs.TraceRecorder(), "ref": robs.TraceRecorder()}
    recs["port"].add_sim_spans(pt, 6)
    recs["ref"].add_sim_spans(rt, 6)
    for name, rec in recs.items():
        _decorate(rec)
        with rec.host_span("compile+dispatch", rounds=6):
            pass
    pobs.write_trace(tmp_path / "port.json", recs["port"])
    robs.write_trace(tmp_path / "ref.json", recs["ref"])
    for name in ("port", "ref"):
        obj = json.loads((tmp_path / f"{name}.json").read_text())
        assert pobs.validate_trace(obj) == robs.validate_trace(obj) == []
    pobs.write_run_record(tmp_path / "port.jsonl", recs["port"])
    robs.write_run_record(tmp_path / "ref.jsonl", recs["ref"])
    for load in (pobs.load_run_record, robs.load_run_record):
        a, b = load(tmp_path / "port.jsonl"), load(tmp_path / "ref.jsonl")
        assert a.sim_events == b.sim_events == recs["port"].sim_events
        assert a.counter_events == b.counter_events
        assert a.serve_events == b.serve_events
        assert a.meta == b.meta
        assert [e["name"] for e in a.host_events] == ["compile+dispatch"]
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "nope"}\n')
    with pytest.raises(ValueError, match="unknown kind"):
        pobs.load_run_record(bad)


@pytest.mark.parametrize("flags", [
    {}, dict(grad_norm=False), dict(silo_loss=False, traffic=False),
    dict(grad_norm=False, param_norm=False, update_norm=False,
         silo_loss=False, staleness=False)])
def test_metric_columns_match_reference(flags):
    got = pobs.metric_columns(pobs.MetricsSpec(**flags), 11)
    assert got == robs.metric_columns(robs.MetricsSpec(**flags), 11)
    assert pobs.MetricsSpec(**flags).columns(5) == \
        robs.MetricsSpec(**flags).columns(5)
    with pytest.raises(ValueError, match="nothing"):
        pobs.MetricsSpec(grad_norm=False, param_norm=False,
                         update_norm=False, silo_loss=False,
                         staleness=False, traffic=False)


def _mask_columns(strong, starts, e2, row_bytes):
    """The count columns from a run's (R, 2E) strong masks, the age
    restarting at each cycle call (rounds in ``starts``): as the port
    computes them (fp32 divisions) and as the reference does (XLA:CPU
    turns the division by the constant 2E into one fused multiply by its
    fp32 reciprocal, so `stale_frac` reads -2.98e-8 when every edge is
    strong)."""
    n = strong.sum(axis=1).astype(np.float32)
    age = np.zeros(strong.shape[1], np.float32)
    age_sum = []
    for k, s in enumerate(strong):
        if k in starts:
            age[:] = 0
        age = np.where(s, np.float32(0), age + np.float32(1))
        age_sum.append(age.sum())
    age_sum = np.asarray(age_sum, np.float32)
    recip = np.float64(np.float32(1 / e2))
    traffic = n * np.float32(row_bytes)
    port = dict(stale_frac=np.float32(1) - n / np.float32(e2),
                buf_age=age_sum / np.float32(e2), gossip_bytes=traffic)
    ref = dict(stale_frac=(1 - n * recip).astype(np.float32),
               buf_age=(age_sum * recip).astype(np.float32),
               gossip_bytes=traffic)
    return port, ref


def _assert_metrics_close(got, want, cols, counts):
    """Norm and silo-loss columns within NORM_RTOL of the reference's;
    each side's count columns exactly what its arithmetic gives on the
    plan's masks (``counts``, from `_mask_columns`)."""
    assert got.shape == want.shape and got.dtype == np.float32
    for j, c in enumerate(cols):
        if c in COUNT_COLUMNS:
            np.testing.assert_array_equal(got[:, j], counts[0][c], err_msg=c)
            np.testing.assert_array_equal(want[:, j], counts[1][c],
                                          err_msg=c)
        else:
            np.testing.assert_allclose(got[:, j], want[:, j], rtol=NORM_RTOL,
                                       err_msg=c)


def _femnist_batches(n, rounds):
    data = make_federated_dataset("femnist", n, samples_per_silo=16, seed=0)
    rng = np.random.default_rng(1)
    per = [[data.sample_batch(s, 4, rng) for s in range(n)]
           for _ in range(rounds)]
    return (np.stack([[np.stack([b["x"] for b in p])] for p in per]),
            np.stack([[np.stack([b["y"] for b in p])] for p in per]))


def _port_cycles(momentum, r, n=11):
    """One port cycle of r rounds with metrics off and on, from the
    reference's initial row."""
    params = psmall.params_from_reference(reference_init("femnist_cnn", n))
    pplan, _ = pdpasgd.make_round_schedule("multigraph", pget("gaia"),
                                           PFEMNIST)
    prt = pruntime.make_flat_runtime(pplan, params, n)
    popt = pflat_sgd(0.001, momentum=momentum)
    w0 = pflat.ravel(prt.spec, params)
    xs, ys = _femnist_batches(n, r)
    args = ({"x": torch.from_numpy(xs), "y": torch.from_numpy(ys).long()},
            torch.from_numpy(prt.strong[:r]),
            torch.from_numpy(prt.coeffs[:r]), torch.from_numpy(prt.diag[:r]))
    outs = {}
    for name, ms in (("off", None), ("on", pobs.MetricsSpec())):
        cycle = pruntime.make_cycle_fn(prt, loss_fn=psmall.FEMNIST_CNN.loss,
                                       opt=popt, metrics=ms)
        outs[name] = cycle(pruntime.init_flat_state(w0, popt, prt), *args)
        assert hasattr(cycle, "metric_columns") == (ms is not None)
    return prt, cycle, outs


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_cycle_metrics_are_inert(momentum):
    """The port's state after a cycle with metrics is bit-equal to its
    state without them."""
    _, _, outs = _port_cycles(momentum, 4)
    (off, loss_off), (on, loss_on, mets) = outs["off"], outs["on"]
    assert torch.equal(on.w, off.w)
    assert torch.equal(on.buffers, off.buffers)
    assert on.opt_state.keys() == off.opt_state.keys()
    assert on.opt_state["step"] == off.opt_state["step"] == 4
    if momentum:
        assert torch.equal(on.opt_state["mu"], off.opt_state["mu"])
    assert torch.equal(loss_on, loss_off)
    assert mets.shape == (4, 17) and bool(torch.isfinite(mets).all())


def test_cycle_metrics_match_reference():
    """One cycle of 6 rounds with metrics, from the reference's initial
    row and the same batches, against the reference's cycle."""
    n, r = 11, 6
    prt, cycle, outs = _port_cycles(0.0, r)
    _, loss_on, mets = outs["on"]
    init = reference_init("femnist_cnn", n)
    rplan, _ = rdpasgd.make_round_schedule("multigraph", rget("gaia"),
                                           RFEMNIST)
    rrt = rruntime.make_flat_runtime(rplan, init, n)
    ropt = rflat_sgd(0.001)
    rw = jnp.broadcast_to(rflat.ravel(rrt.spec, init)[None],
                          (n, rrt.spec.size)).copy()
    rstate = rruntime.FlatFLState(rw, ropt.init(rw),
                                  rw[jnp.asarray(rrt.src_sorted)])
    rcycle = rruntime.make_cycle_fn(rrt, loss_fn=RCNN.loss, opt=ropt,
                                    aggregator="reference",
                                    metrics=robs.MetricsSpec())
    xs, ys = _femnist_batches(n, r)
    _, rlosses, rmets = rcycle(
        rstate, {"x": jnp.asarray(xs), "y": jnp.asarray(ys)},
        jnp.asarray(rrt.strong[:r]), jnp.asarray(rrt.coeffs[:r]),
        jnp.asarray(rrt.diag[:r]))
    cols = pobs.MetricsSpec().columns(n)
    assert cycle.metric_columns == rcycle.metric_columns == cols
    np.testing.assert_allclose(loss_on.numpy(), np.asarray(rlosses),
                               rtol=1e-5)
    counts = _mask_columns(prt.strong[:r], {0}, len(prt.dst_sorted),
                           prt.spec.size * 4)
    _assert_metrics_close(mets.numpy(), np.asarray(rmets), cols, counts)


def test_run_fl_metrics_and_trace_match_reference(monkeypatch, tmp_path):
    start_port_from(monkeypatch, "femnist_cnn",
                    reference_init("femnist_cnn", 11))
    paths = {k: tmp_path / f"{k}.json" for k in ("port", "ref")}
    ref = rrun_fl(RConfig(**RUN, metrics=robs.MetricsSpec(),
                          trace=str(paths["ref"])))
    got = prun_fl(PConfig(**RUN, metrics=pobs.MetricsSpec(),
                          trace=str(paths["port"])), device="cpu")
    assert_same_run(got, ref, rtol=1e-5, acc_atol=1 / 512)
    assert got.metric_columns == ref.metric_columns
    plan, _ = pdpasgd.make_round_schedule("multigraph", pget("gaia"),
                                          PFEMNIST)
    strong = pruntime.make_flat_runtime(
        plan, psmall.SMALL_MODELS["femnist_cnn"].init(torch.Generator()), 11).strong
    counts = _mask_columns(strong[:8], {0, 4}, strong.shape[1],
                           1_280_478 * 4)  # chunks start at 0 and 4
    _assert_metrics_close(got.metrics, ref.metrics, got.metric_columns,
                          counts)
    objs = {k: json.loads(p.read_text()) for k, p in paths.items()}
    assert pobs.validate_trace(objs["port"]) == []
    assert objs["port"]["otherData"] == objs["ref"]["otherData"]

    def events(obj, keep):
        return [e for e in obj["traceEvents"] if keep(e)]

    def sim(e):
        return e.get("cat") == "sim" or (e["ph"] == "M" and e["pid"] == 1)

    assert events(objs["port"], sim) == events(objs["ref"], sim)
    pc, rc = (events(objs[k], lambda e: e["ph"] == "C") for k in objs)
    assert [(e["name"], e["ts"]) for e in pc] == \
        [(e["name"], e["ts"]) for e in rc]
    assert [e["name"] for e in events(objs["port"],
                                      lambda e: e.get("cat") == "host")] == \
        [e["name"] for e in events(objs["ref"],
                                   lambda e: e.get("cat") == "host")] == \
        ["compile+dispatch", "eval", "dispatch", "eval"]


def test_run_fl_hooks_are_inert(tmp_path):
    """metrics=, trace= and ckpt_dir= together leave losses and accuracies
    bit-equal to the run without them."""
    base = prun_fl(PConfig(**RUN, momentum=0.9), device="cpu")
    hooked = prun_fl(PConfig(**RUN, momentum=0.9,
                             metrics=pobs.MetricsSpec(),
                             trace=str(tmp_path / "t.json"),
                             ckpt_dir=str(tmp_path / "ck"), ckpt_every=3),
                     device="cpu")
    assert hooked.round_losses == base.round_losses
    assert hooked.eval_accs == base.eval_accs
    assert hooked.eval_rounds == base.eval_rounds == [4, 8]
    assert hooked.metrics.shape == (8, 17)
    assert np.isfinite(hooked.metrics).all()
    assert base.metrics is None and base.metric_columns == ()
