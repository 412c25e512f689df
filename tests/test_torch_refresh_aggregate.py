"""The fused refresh-and-aggregate (`ops.refresh_aggregate`, one launch of
`csrc/edge_aggregate.cu` for a list of segments) on the CPU, where it
runs its plain version, and the three runtimes that call it.

* Against the reference: for each segment, the reference's
  ``jnp.where(strong[:, None], w[src], buf)`` followed by its
  `segment_sum` oracle (`edge_aggregate_ref`) gives the port's output bit
  for bit (`np.array_equal`, NaN where NaN), and the refreshed rows are
  the port's buffers after the call; the same `where` followed by the
  reference's Pallas `edge_aggregate` in interpret mode, which XLA
  contracts into FMAs, is within 1e-6. The cases (`_refresh_cases.py`):
  an isolated destination, no edges, all strong, all weak, mixed, a NaN
  in a weak zero-coefficient buffer row, pad edges past the row pointer
  (neither read nor written), fresh rows apart from w (the mesh's
  shards), buffers kept in another row order (``edge_row``), and one call
  over segments of T = 1, 3, 4,099 and T % 4 = 0, 1, 2, 3.
* One call a round: the flat cycle, the mesh cycle on `StackedShards`
  at D = 1, 2, 4 (one segment a shard) and `fl_round_step` on the
  FEMNIST CNN's 6 leaves (one segment a leaf), counted through a wrapper.
* A cycle call leaves the state passed in as it was: it refreshes a
  clone of the buffers.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.gossip_combine import ops as rops  # noqa: E402
from repro.kernels.gossip_combine.ref import \
    edge_aggregate_ref as redge_ref  # noqa: E402

from _refresh_cases import CASES, multi_t_cases, segment_case  # noqa: E402
from repro_torch.core.delay import FEMNIST  # noqa: E402
from repro_torch.fl import dpasgd, flat as pflat  # noqa: E402
from repro_torch.fl import mesh as pmesh, runtime as pruntime  # noqa: E402
from repro_torch.kernels.gossip_combine import ops  # noqa: E402
from repro_torch.kernels.gossip_combine.ref import Segment  # noqa: E402
from repro_torch.models.small import SMALL_MODELS  # noqa: E402
from repro_torch.networks.registry import get_network  # noqa: E402
from repro_torch.optim import flat_sgd, sgd  # noqa: E402


def _segment(case):
    """The case's arrays as a port `Segment` (the buffers a copy, which
    the call refreshes in place)."""
    t = lambda a, dt=torch.float32: None if a is None else torch.tensor(
        a, dtype=dt)
    return Segment(t(case["w"]), t(case["buf"]), t(case["coeffs"]),
                   t(case["row_ptr"], torch.int32), t(case["diag"]),
                   fresh=t(case["fresh"]), src=t(case["src"], torch.int32),
                   strong=t(case["strong"], torch.bool),
                   edge_row=t(case["edge_row"], torch.int32))


def _reference(case):
    """The reference's where, then its oracle and its interpret-mode
    Pallas kernel, over the real edges in dst-sorted order; and the
    buffers after the refresh."""
    e2 = len(case["dst"])
    e = len(case["coeffs"])
    rows = np.arange(e) if case["edge_row"] is None else case["edge_row"]
    src = np.arange(e) if case["src"] is None else case["src"]
    fresh = case["w"] if case["fresh"] is None else case["fresh"]
    buf = jnp.asarray(case["buf"])[rows[:e2]]
    v = jnp.where(jnp.asarray(case["strong"][:e2])[:, None],
                  jnp.asarray(fresh)[src[:e2]], buf)
    w, c, d = (jnp.asarray(case[k]) for k in ("w", "coeffs", "diag"))
    oracle = redge_ref(w, v, c[:e2], jnp.asarray(case["dst"]), d)
    pallas = rops.edge_aggregate(w, v, c[:e2], jnp.asarray(case["row_ptr"]),
                                 d, interpret=True)
    after = case["buf"].copy()
    after[rows[:e2]] = np.asarray(v)
    return np.asarray(oracle), np.asarray(pallas), after


def _check(cases, segs, outs):
    for case, seg, out in zip(cases, segs, outs):
        oracle, pallas, after = _reference(case)
        got = out.numpy()
        assert np.array_equal(got, oracle, equal_nan=True)
        np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
        assert np.array_equal(seg.buf.numpy(), after, equal_nan=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_op_against_reference(name):
    case = segment_case(7, **CASES[name])
    seg = _segment(case)
    before = ops.edge_aggregate.launches
    outs = ops.refresh_aggregate([seg])
    assert ops.edge_aggregate.launches == before  # CPU: plain version
    _check([case], [seg], outs)
    if name == "nan_weak_zero_coeff":
        assert np.isnan(outs[0].numpy()).any()


def test_plain_op_over_segments_of_every_width():
    cases = multi_t_cases(3)
    segs = [_segment(c) for c in cases]
    outs = ops.refresh_aggregate(segs)
    assert [o.shape[1] for o in outs] == [c["w"].shape[1] for c in cases]
    _check(cases, segs, outs)


def test_plain_op_without_strong_mask_is_edge_aggregate():
    case = segment_case(5, **CASES["mixed"])
    seg = _segment(case)._replace(strong=None, src=None)
    out = torch.empty_like(seg.w)
    got, = ops.refresh_aggregate([seg._replace(out=out)])
    assert got is out
    assert torch.equal(out, ops.edge_aggregate(
        seg.w, seg.buf, seg.coeffs, seg.row_ptr, seg.diag))
    assert np.array_equal(seg.buf.numpy(), case["buf"])


# ---------------------------------------------------------------------------
# the runtimes: one call a round, the caller's state untouched
# ---------------------------------------------------------------------------

N = 11
ROUNDS = 3


class _Spy:
    """Wraps `refresh_aggregate`, recording each call's segment count."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, segments, **kw):
        segments = list(segments)
        self.calls.append(len(segments))
        return self.real(segments, **kw)


def _linear_runtime(t=37):
    """gaia's multigraph plan over one (t,) leaf, and a loss whose
    gradient is the batch's ``g``: local SGD stays cheap."""
    plan, _ = dpasgd.make_round_schedule("multigraph", get_network("gaia"),
                                         FEMNIST)
    rt = pruntime.make_flat_runtime(plan, {"w": torch.zeros(t)}, N)
    loss = lambda p, b: torch.sum(p["w"] * b["g"])
    rng = np.random.default_rng(0)
    batches = {"g": torch.as_tensor(
        rng.normal(size=(ROUNDS, 1, N, t)).astype(np.float32))}
    slices = [torch.as_tensor(getattr(rt, k)[:ROUNDS])
              for k in ("strong", "coeffs", "diag")]
    w0 = torch.as_tensor(rng.normal(size=t).astype(np.float32))
    return rt, loss, batches, slices, w0


@pytest.mark.parametrize("shards", [None, 1, 2, 4])
def test_cycle_calls_once_a_round_and_keeps_the_input_state(monkeypatch,
                                                            shards):
    """The flat cycle (``shards`` None) and the mesh cycle on D stacked
    shards: one `refresh_aggregate` call a round (D segments in the
    mesh's), the state passed in bit for bit as it was, and the mesh's
    result bit-equal to the flat one's."""
    rt, loss, batches, slices, w0 = _linear_runtime()
    opt = flat_sgd(0.05, momentum=0.9)
    if shards is None:
        target, state = rt, pruntime.init_flat_state(w0, opt, rt)
    else:
        target = pmesh.make_mesh_runtime(rt, shards, device="cpu")
        state = pmesh.init_mesh_state(w0, opt, target)
    # the runtimes' buffers all start as w0's rows: make them differ
    state.buffers.add_(torch.arange(state.buffers.shape[0],
                                    dtype=torch.float32)[:, None])
    kept = [x.clone() for x in (state.w, state.buffers)]
    flat_state = (state if shards is None
                  else pmesh.gather_flat_state(target, state))
    want, want_losses = pruntime.make_cycle_fn(rt, loss_fn=loss, opt=opt)(
        flat_state, batches, *slices)
    spy = _Spy(ops.refresh_aggregate)
    monkeypatch.setattr(ops, "refresh_aggregate", spy)
    cycle = pruntime.make_cycle_fn(target, loss_fn=loss, opt=opt)
    got, losses = cycle(state, batches, *slices)
    assert spy.calls == [shards or 1] * ROUNDS
    assert torch.equal(state.w, kept[0])
    assert torch.equal(state.buffers, kept[1])
    assert not torch.equal(got.buffers, kept[1])  # the clone was refreshed
    if shards is not None:
        got = pmesh.gather_flat_state(target, got)
    assert torch.equal(losses, want_losses)
    assert torch.equal(got.w, want.w)
    assert torch.equal(got.buffers, want.buffers)


def test_fl_round_step_calls_once_a_round_over_every_leaf(monkeypatch):
    """`fl_round_step` on the FEMNIST CNN: one call a round with one
    segment per leaf (6), bit-equal to the flat cycle on the same rows."""
    spec = SMALL_MODELS["femnist_cnn"]
    params = spec.init(torch.Generator().manual_seed(0))
    leaves = len(pflat.make_flat_spec(params).shapes)
    assert leaves == 6
    plan, _ = dpasgd.make_round_schedule("multigraph", get_network("gaia"),
                                         FEMNIST)
    rng = np.random.default_rng(2)
    xs = torch.as_tensor(rng.normal(size=(ROUNDS, 1, N, 2, 28, 28, 1))
                         .astype(np.float32))
    ys = torch.as_tensor(rng.integers(0, 62, size=(ROUNDS, 1, N, 2)))
    spy = _Spy(ops.refresh_aggregate)
    monkeypatch.setattr(dpasgd, "refresh_aggregate", spy)
    opt = sgd(0.05)
    state = dpasgd.init_fl_state(params, opt, N, plan.src)
    for k in range(ROUNDS):
        state, _ = dpasgd.fl_round_step(
            state, {"x": xs[k], "y": ys[k]}, plan.src, plan.dst,
            torch.as_tensor(plan.strong[k]), torch.as_tensor(plan.coeffs[k]),
            torch.as_tensor(plan.diag[k]), loss_fn=spec.loss, opt=opt,
            local_updates=1)
    assert spy.calls == [leaves] * ROUNDS
    rt = pruntime.make_flat_runtime(plan, params, N)
    fopt = flat_sgd(0.05)
    flat, _ = pruntime.make_cycle_fn(rt, loss_fn=spec.loss, opt=fopt)(
        pruntime.init_flat_state(pflat.ravel(rt.spec, params), fopt, rt),
        {"x": xs, "y": ys}, *(torch.as_tensor(getattr(rt, k)[:ROUNDS])
                              for k in ("strong", "coeffs", "diag")))
    for a, b in ((state.silo_params, pruntime.unpack_params(rt, flat)),
                 (state.buffers, pruntime.unpack_buffers(rt, flat))):
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_fl_round_step_consumes_its_state_and_takes_prebuilt_tables():
    """`fl_round_step` refreshes the buffers of the state handed in, in
    place, and returns them as its state's (the call consumes its
    state); tables built once by `csr_tables` give the same rounds, bit
    for bit, as tables built in each call."""
    spec = SMALL_MODELS["femnist_cnn"]
    params = spec.init(torch.Generator().manual_seed(0))
    plan, _ = dpasgd.make_round_schedule("multigraph", get_network("gaia"),
                                         FEMNIST)
    rng = np.random.default_rng(3)
    xs = torch.as_tensor(rng.normal(size=(2, 1, N, 2, 28, 28, 1))
                         .astype(np.float32))
    ys = torch.as_tensor(rng.integers(0, 62, size=(2, 1, N, 2)))
    tables = dpasgd.csr_tables(plan.src, plan.dst, N, "cpu")
    runs = []
    for csr in (None, tables):
        opt = sgd(0.05, momentum=0.9)
        state = dpasgd.init_fl_state(params, opt, N, plan.src)
        for k in range(2):
            given = list(state.buffers.values())
            state, _ = dpasgd.fl_round_step(
                state, {"x": xs[k], "y": ys[k]}, plan.src, plan.dst,
                torch.as_tensor(plan.strong[k]),
                torch.as_tensor(plan.coeffs[k]),
                torch.as_tensor(plan.diag[k]), loss_fn=spec.loss, opt=opt,
                local_updates=1, csr=csr)
            for a, b in zip(given, state.buffers.values()):
                assert a.data_ptr() == b.data_ptr()
                assert torch.equal(a, b)
        runs.append(state)
    for key in params:
        assert torch.equal(runs[0].silo_params[key], runs[1].silo_params[key])
        assert torch.equal(runs[0].buffers[key], runs[1].buffers[key])
