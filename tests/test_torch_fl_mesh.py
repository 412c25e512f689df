"""The port's mesh-sharded flat runtime (`repro_torch.fl.mesh`) on the CPU.

The reference's mesh cycle does not run in this container (its jax
rejects `shard_map(check_rep=)`), so the sharded cycle is held against
the port's own single-device flat runtime, the DESIGN.md §16 contract:
params, edge buffers and momentum bit-equal after a whole multigraph
cycle, at D = 1, 2, 4 and 8 stacked shards (`StackedShards`), with both
gossip backends and momentum 0 and 0.9, on a toy model; losses bit-equal
too (both take the mean of the same (u, N) tensor). The host-side
tables are pure numpy and are held against the reference's exactly:
`silo_assignment`, `block_layout`, `_build_halo` on the reference
tests' random CSR graphs and on the five paper networks at D = 2, 4, 8.
Then `run_fl(mesh=)` against `run_fl` on FEMNIST (bit-equal), the
metric columns with `fabric_bytes`, and the controller's decisions with
and without a mesh.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core.delay import FEMNIST as RFEMNIST  # noqa: E402
from repro.fl import dpasgd as rdpasgd  # noqa: E402
from repro.fl import gossip as rgossip  # noqa: E402
from repro.fl import mesh as rmesh  # noqa: E402
from repro.kernels.gossip_combine.ops import csr_sort as rcsr_sort  # noqa: E402
from repro.launch.mesh import silo_assignment as rassign  # noqa: E402
from repro.networks.zoo import get_network as rget  # noqa: E402
from repro.obs import metrics as rmetrics  # noqa: E402

from repro_torch.core.delay import FEMNIST  # noqa: E402
from repro_torch.design import controller as pcontroller  # noqa: E402
from repro_torch.fl import FLConfig, dpasgd, run_fl  # noqa: E402
from repro_torch.fl import flat as flatmod  # noqa: E402
from repro_torch.fl import gossip as pgossip  # noqa: E402
from repro_torch.fl import mesh as pmesh  # noqa: E402
from repro_torch.fl import runtime as prt  # noqa: E402
from repro_torch.kernels.gossip_combine.ops import csr_sort  # noqa: E402
from repro_torch.kernels.gossip_combine.ref import (  # noqa: E402
    edge_aggregate_ref)
from repro_torch.launch.mesh import (StackedShards, shard_axis,  # noqa: E402
                                     silo_assignment)
from repro_torch.networks.registry import get_network  # noqa: E402
from repro_torch.obs import MetricsSpec  # noqa: E402
from repro_torch.optim import flat_sgd  # noqa: E402
from _torch_fl_parity import one_thread  # noqa: E402,F401

D_MODEL = 8
NETWORKS = ["gaia", "amazon", "geant", "exodus", "ebone"]
RANDOM_CASES = [(10, 2, ()), (11, 4, (0, 7)), (16, 8, (3,)), (5, 8, ()),
                (12, 3, ()), (11, 4, (2, 9)), (9, 2, (0,))]


def _toy_loss(p, batch):
    return torch.sum((p["w"] - batch["t"]) ** 2) + torch.sum(p["b"] ** 2)


def _toy_params(seed=7):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=D_MODEL).astype(np.float32)),
            "b": torch.zeros(3)}


def _plan(net_name):
    plan, _ = dpasgd.make_round_schedule("multigraph", get_network(net_name),
                                         FEMNIST, t=5)
    return plan


def _cycle_inputs(plan, n, seed, u=2):
    r = plan.num_rounds_cycle
    rng = np.random.default_rng(seed)
    return {"t": torch.from_numpy(
        rng.normal(size=(r, u, n, 1, D_MODEL)).astype(np.float32))}


def _run(rt, batches, momentum, mesh=None, backend=None, metrics=None):
    """One whole cycle from the toy start: (runtime, state, losses[,
    metrics]) on the flat runtime, or on ``mesh`` shards."""
    opt = flat_sgd(0.05, momentum=momentum)
    w0 = flatmod.ravel(rt.spec, _toy_params())
    if mesh is None:
        run_rt, state = rt, prt.init_flat_state(w0, opt, rt)
    else:
        run_rt = pmesh.make_mesh_runtime(rt, mesh)
        state = pmesh.init_mesh_state(w0, opt, run_rt)
    cycle = prt.make_cycle_fn(run_rt, loss_fn=_toy_loss, opt=opt,
                              gossip=backend, metrics=metrics)
    plan_t = [torch.as_tensor(x) for x in (rt.strong, rt.coeffs, rt.diag)]
    return (run_rt, cycle) + tuple(cycle(state, batches, *plan_t))


def _random_plan_arrays(n, rng, isolated=()):
    """The reference test's random directed CSR edge structure."""
    nodes = [i for i in range(n) if i not in isolated]
    pairs = set()
    while len(pairs) < max(1, 2 * len(nodes)):
        i, j = rng.choice(nodes, 2, replace=False)
        pairs.add((min(i, j), max(i, j)))
    src = np.array([e for i, j in sorted(pairs) for e in (i, j)], np.int64)
    dst = np.array([e for i, j in sorted(pairs) for e in (j, i)], np.int64)
    order, row_ptr = csr_sort(dst, n)
    np.testing.assert_array_equal(order, rcsr_sort(dst, n)[0])
    return src[order].astype(np.int32), dst[order].astype(np.int32), row_ptr


def _assert_tables_equal(src, dst, d, per):
    got = pmesh.block_layout(dst, src, d, per)
    want = rmesh.block_layout(dst, src, d, per)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    counts, _, _, src_global = got
    hp = pmesh._build_halo(counts, src_global, d, per)
    hr = rmesh._build_halo(counts, src_global, d, per)
    assert hp.offsets == hr.offsets and hp.perms == hr.perms
    assert hp.halo_rows == hr.halo_rows
    for a, b in zip(hp.send_idx, hr.send_idx):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(hp.gather_idx, hr.gather_idx)
    return got, hp


# ---------------------------------------------------------------------------
# host-side tables, equal to the reference's
# ---------------------------------------------------------------------------


def test_silo_assignment_matches_reference():
    for n, d in [(11, 4), (8, 8), (3, 8), (87, 8), (40, 3), (1, 1)]:
        got, want = silo_assignment(n, d), rassign(n, d)
        assert (got.num_silos, got.num_shards, got.per_shard,
                got.rows_padded, got.axis) == (
            want.num_silos, want.num_shards, want.per_shard,
            want.rows_padded, want.axis)
        rows = np.arange(got.rows_padded)
        np.testing.assert_array_equal(got.shard_of(rows), want.shard_of(rows))
        np.testing.assert_array_equal(got.local_of(rows), want.local_of(rows))
    assert silo_assignment(11, StackedShards(4)).per_shard == 3


@pytest.mark.parametrize("n,d,isolated", RANDOM_CASES)
def test_block_layout_and_halo_match_reference(n, d, isolated):
    rng = np.random.default_rng(n * 100 + d)
    src, dst, _ = _random_plan_arrays(n, rng, isolated)
    _assert_tables_equal(src, dst, d, -(-n // d))


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("net_name", NETWORKS)
def test_paper_network_tables_match_reference(net_name, d):
    """The port's runtime tables on each paper network's multigraph equal
    the reference's `block_layout` / `_build_halo` on the reference's own
    plan, table for table."""
    rplan, _, _ = rdpasgd.multigraph_plan(rget(net_name), RFEMNIST, t=5)
    n = rplan.diag.shape[1]
    order, _ = rcsr_sort(rplan.dst, n)
    rt = prt.make_flat_runtime(_plan(net_name), _toy_params(), n)
    np.testing.assert_array_equal(rt.src_sorted, rplan.src[order])
    np.testing.assert_array_equal(rt.dst_sorted, rplan.dst[order])
    (counts, edge_perm, dst_local, src_global), halo = _assert_tables_equal(
        rplan.src[order].astype(np.int32), rplan.dst[order].astype(np.int32),
        d, -(-n // d))
    mrt = pmesh.make_mesh_runtime(rt, d)
    for got, want in ((mrt.edge_counts, counts), (mrt.edge_perm, edge_perm),
                      (mrt.dst_local, dst_local),
                      (mrt.src_global, src_global),
                      (mrt.halo.gather_idx, halo.gather_idx)):
        np.testing.assert_array_equal(got, want)
    # each shard's row pointer spans its real edges only
    for p in range(d):
        rp = mrt.shard_row_ptr(p)
        assert rp[-1] == counts[p] and (np.diff(rp) >= 0).all()


# ---------------------------------------------------------------------------
# the CSR gathers on StackedShards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,isolated", RANDOM_CASES[4:])
def test_csr_gathers_equal_flat_rows(n, d, isolated):
    """Both backends hand every shard exactly ``w[src]`` for its real
    edges, the byte counters count the rows that cross shards, and the
    shard-local aggregation over each shard's real-edge row pointer
    equals the flat aggregation bit for bit (pad edges never read)."""
    rng = np.random.default_rng(7 * n + d)
    src, dst, row_ptr = _random_plan_arrays(n, rng, isolated)
    per = -(-n // d)
    counts, edge_perm, dst_local, src_global = pmesh.block_layout(
        dst, src, d, per)
    halo = pmesh._build_halo(counts, src_global, d, per)
    t = 6
    w = torch.from_numpy(rng.normal(size=(d * per, t)).astype(np.float32))
    coeffs = torch.from_numpy(rng.uniform(0.1, 1.0, len(dst)).astype(
        np.float32))
    diag = torch.from_numpy(rng.uniform(0.1, 1.0, n).astype(np.float32))
    want = edge_aggregate_ref(w[:n], w[torch.as_tensor(src).long()], coeffs,
                              torch.as_tensor(row_ptr), diag)
    coeffs_p = torch.cat([coeffs, torch.zeros(1)])[
        torch.as_tensor(edge_perm)].reshape(d, -1)
    diag_p = torch.cat([diag, torch.ones(d * per - n)]).reshape(d, per)
    blocks = list(w.split(per))
    long = lambda a: torch.as_tensor(a, dtype=torch.long)
    row_bytes = t * 4
    for backend in ("all_gather", "halo"):
        axis = StackedShards(d)
        if backend == "halo":
            rows = pgossip.csr_gather_halo(
                axis, blocks, [long(x) for x in halo.send_idx], halo.perms,
                [long(g) for g in halo.gather_idx])
            assert axis.bytes_moved == d * halo.halo_rows * row_bytes
        else:
            rows = pgossip.csr_gather_all(axis, blocks,
                                          [long(s) for s in src_global])
            assert axis.bytes_moved == d * (d - 1) * per * row_bytes
        agg = []
        for p in range(d):
            c = int(counts[p])
            assert torch.equal(rows[p][:c], w[long(src_global[p, :c])])
            rp = np.zeros(per + 1, np.int32)
            rp[1:] = np.cumsum(np.bincount(dst_local[p, :c], minlength=per))
            agg.append(edge_aggregate_ref(blocks[p], rows[p], coeffs_p[p],
                                          torch.as_tensor(rp), diag_p[p]))
        assert torch.equal(torch.cat(agg)[:n], want)
    assert (pgossip.fabric_rows_per_round("halo", halo_rows=halo.halo_rows,
                                          num_shards=d, rows_padded=d * per)
            == rgossip.fabric_rows_per_round(
                "halo", halo_rows=halo.halo_rows, num_shards=d,
                rows_padded=d * per))


# ---------------------------------------------------------------------------
# whole-cycle bit-exactness: sharded == flat
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gaia_flat():
    """The flat runtime's gaia cycle at momentum 0 and 0.9."""
    plan = _plan("gaia")
    n = plan.diag.shape[1]
    rt = prt.make_flat_runtime(plan, _toy_params(), n)
    batches = _cycle_inputs(plan, n, seed=1)
    return rt, batches, {m: _run(rt, batches, m)[2:] for m in (0.0, 0.9)}


def _assert_state_equal(mrt, state, want_state, momentum):
    got = pmesh.gather_flat_state(mrt, state)
    assert torch.equal(got.w, want_state.w)
    assert torch.equal(got.buffers, want_state.buffers)
    assert got.opt_state["step"] == want_state.opt_state["step"]
    if momentum:
        assert torch.equal(got.opt_state["mu"], want_state.opt_state["mu"])


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("backend", ["halo", "all_gather"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_mesh_cycle_bitexact(gaia_flat, d, backend, momentum):
    """Params, edge buffers, momentum and losses bit-equal to the flat
    runtime over a full gaia multigraph cycle, two local updates a
    round."""
    rt, batches, flat = gaia_flat
    mrt, _, state, losses = _run(rt, batches, momentum, mesh=d,
                                 backend=backend)
    assert state.w.shape == (d * -(-11 // d), rt.spec.size)
    _assert_state_equal(mrt, state, flat[momentum][0], momentum)
    assert torch.equal(losses, flat[momentum][1])


@pytest.mark.parametrize("net_name", NETWORKS[1:])
def test_mesh_cycle_bitexact_paper_networks(net_name):
    plan = _plan(net_name)
    n = plan.diag.shape[1]
    rt = prt.make_flat_runtime(plan, _toy_params(), n)
    batches = _cycle_inputs(plan, n, seed=n, u=1)
    _, _, s1, l1 = _run(rt, batches, 0.9)
    mrt, _, sm, lm = _run(rt, batches, 0.9, mesh=4)
    _assert_state_equal(mrt, sm, s1, 0.9)
    assert torch.equal(lm, l1)


def test_gather_flat_state_layout(gaia_flat):
    """Pad rows dropped, block-padded buffers back in dst-sorted order,
    the step count kept; the local tensors are the padded blocks."""
    rt, batches, _ = gaia_flat
    mrt, _, state, _ = _run(rt, batches, 0.9, mesh=3)
    assert (mrt.per_rows, mrt.mspec.rows_padded) == (4, 12)
    assert state.buffers.shape[0] == mrt.mspec.edges_padded
    assert mrt.mspec.edges_padded == 3 * mrt.edges_per_shard
    flat = pmesh.gather_flat_state(mrt, state)
    assert flat.w.shape == (11, rt.spec.size)
    assert flat.buffers.shape == (len(rt.dst_sorted), rt.spec.size)
    real = torch.as_tensor(np.flatnonzero(mrt.edge_perm < len(rt.dst_sorted)))
    assert torch.equal(flat.buffers, state.buffers[real])
    assert torch.equal(flat.w, state.w[:11])
    assert flat.opt_state["step"] == rt.num_rounds_cycle * 2


@pytest.mark.parametrize("backend", ["halo", "all_gather"])
def test_metric_columns_with_fabric_bytes(gaia_flat, backend):
    """The reference's mesh columns (its flat columns + `fabric_bytes`);
    the count columns equal the flat runtime's exactly, the norms within
    rtol 1e-6 (summed shard by shard), silo losses bit-equal, and
    `fabric_bytes` is `fabric_rows_per_round` times the row size."""
    rt, batches, _ = gaia_flat
    ms = MetricsSpec()
    _, cycle_f, s1, l1, m1 = _run(rt, batches, 0.9, metrics=ms)
    mrt, cycle_m, sm, lm, mm = _run(rt, batches, 0.9, mesh=4,
                                    backend=backend, metrics=ms)
    cols = cycle_m.metric_columns
    assert cols == rmetrics.metric_columns(rmetrics.MetricsSpec(), 11,
                                           mesh=True)
    assert cols[:-1] == cycle_f.metric_columns and cols[-1] == "fabric_bytes"
    assert mm.shape == (rt.num_rounds_cycle, len(cols))
    _assert_state_equal(mrt, sm, s1, 0.9)
    assert torch.equal(lm, l1)
    exact = [i for i, c in enumerate(cols[:-1]) if "norm" not in c]
    assert torch.equal(mm[:, exact], m1[:, exact])
    norms = [i for i, c in enumerate(cols) if "norm" in c]
    np.testing.assert_allclose(mm[:, norms].numpy(), m1[:, norms].numpy(),
                               rtol=1e-6)
    rows = rgossip.fabric_rows_per_round(
        backend, halo_rows=mrt.halo.halo_rows, num_shards=4,
        rows_padded=mrt.mspec.rows_padded)
    assert (mm[:, -1] == np.float32(rows * rt.spec.size * 4)).all()
    if backend == "halo":
        assert rows <= rgossip.fabric_rows_per_round(
            "all_gather", halo_rows=0, num_shards=4,
            rows_padded=mrt.mspec.rows_padded)


def test_refusals_and_shard_axis(gaia_flat):
    rt = gaia_flat[0]
    opt = flat_sgd(0.05)
    with pytest.raises(ValueError, match="gossip"):
        prt.make_cycle_fn(rt, loss_fn=_toy_loss, opt=opt, gossip="halo")
    mrt = pmesh.make_mesh_runtime(rt, 1)
    with pytest.raises(ValueError, match="backend"):
        prt.make_cycle_fn(mrt, loss_fn=_toy_loss, opt=opt, gossip="bogus")
    with pytest.raises(ValueError, match="single-device"):
        prt.make_cycle_fn(mrt, loss_fn=_toy_loss, opt=opt,
                          aggregator="dense")
    assert isinstance(shard_axis("auto"), StackedShards)
    assert shard_axis("auto").size == 1 and shard_axis(None).size == 1
    axis = StackedShards(3, "cpu")
    assert shard_axis(axis) is axis and shard_axis(5).size == 5
    assert pmesh.make_mesh_runtime(rt, axis).axis is axis
    for bad in ("two", 2.0, True):
        with pytest.raises(ValueError, match="mesh"):
            shard_axis(bad)
    with pytest.raises(ValueError):
        StackedShards(0)
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the entry points: run_fl and the controller
# ---------------------------------------------------------------------------

FEMNIST_SMOKE = dict(dataset="femnist", network="gaia", rounds=2,
                     eval_every=2, samples_per_silo=16, batch_size=4,
                     momentum=0.9, seed=3)


@pytest.fixture(scope="module")
def femnist_flat():
    return run_fl(FLConfig(**FEMNIST_SMOKE), device="cpu")


@pytest.mark.parametrize("mesh,gossip", [("auto", "halo"),
                                         (4, "all_gather")])
def test_run_fl_mesh_matches_flat(femnist_flat, mesh, gossip):
    """The reference's `test_femnist_mesh_smoke` on the port: FEMNIST on
    gaia, momentum 0.9, the flat and the mesh run; losses and accuracies
    bit-equal, the simulated clock equal."""
    got = run_fl(FLConfig(**FEMNIST_SMOKE, mesh=mesh, gossip=gossip),
                 device="cpu")
    assert got.round_losses == femnist_flat.round_losses
    assert got.eval_accs == femnist_flat.eval_accs
    assert got.cycle_times_ms == femnist_flat.cycle_times_ms
    assert got.total_time_s == femnist_flat.total_time_s


def test_run_fl_mesh_refusals():
    with pytest.raises(ValueError, match="runtime='flat'"):
        run_fl(FLConfig(rounds=1, runtime="legacy", mesh=2), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        run_fl(FLConfig(rounds=1, mesh=2, gossip="bogus"), device="cpu")


def test_controller_mesh_decisions_equal():
    """`ControllerHarness(ControllerConfig(mesh=2))` under churn makes the
    decisions of the harness without a mesh (swap rounds and vectors),
    with bit-equal losses and the same final accuracy."""
    kw = dict(network="gaia", rounds=4, replan_every=2, samples_per_silo=4,
              batch_size=2, seed=3)
    runs = [pcontroller.ControllerHarness(
        pcontroller.ControllerConfig(**kw, mesh=mesh), device="cpu").run(
        "churn", adaptive=True) for mesh in (None, 2)]
    flat, mesh = runs
    assert flat.swap_rounds and mesh.swap_rounds == flat.swap_rounds
    assert mesh.vectors == flat.vectors
    np.testing.assert_array_equal(mesh.losses, flat.losses)
    np.testing.assert_array_equal(mesh.cycle_times_ms, flat.cycle_times_ms)
    assert mesh.final_acc == flat.final_acc
