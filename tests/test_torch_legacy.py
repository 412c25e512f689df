"""The rest of `run_fl` on one device: the legacy per-round runtime
(`fl/dpasgd.fl_round_step` with the per-leaf `optim.sgd`) held bit for
bit against the port's own flat runtime, and against the reference's
legacy `run_fl`; the "dense" aggregator; the `wan<K>` networks; the
reference's refusals of hooks on the legacy runtime.

Port against port is exact (`torch.equal`, `==`): both runtimes do the
same elementwise ops on the same values, and aggregate with the same
ordered sum. Port against reference uses the slice's limits
(`test_torch_slice.py`: losses rtol 1e-5, accuracies within one test
sample, rows 1e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from _torch_fl_parity import (assert_same_run, reference_init,  # noqa: E402
                              start_port_from)
from repro.fl import FLConfig as RConfig, run_fl as rrun_fl  # noqa: E402
from repro.fl import dpasgd as rdpasgd, runtime as rruntime  # noqa: E402
from repro.kernels.gossip_combine.ref import (  # noqa: E402
    dense_edge_aggregate as rdense)
from repro.networks import registry as rregistry  # noqa: E402
from repro.obs import MetricsSpec as RMetricsSpec  # noqa: E402

from repro_torch.core.delay import FEMNIST  # noqa: E402
from repro_torch.data.synthetic import make_federated_dataset  # noqa: E402
from repro_torch.fl import FLConfig as PConfig, run_fl as prun_fl  # noqa: E402
from repro_torch.fl import dpasgd, flat as pflat, runtime as pruntime  # noqa: E402
from repro_torch.fl import train as ptrain  # noqa: E402
from repro_torch.kernels.gossip_combine import ops  # noqa: E402
from repro_torch.kernels.gossip_combine.ref import (  # noqa: E402
    dense_edge_aggregate, edge_aggregate_ref)
from repro_torch.models import small as psmall  # noqa: E402
from repro_torch.networks import registry as pregistry  # noqa: E402
from repro_torch.obs import MetricsSpec  # noqa: E402
from repro_torch.optim import flat_sgd, sgd  # noqa: E402

N = 11
RUN = dict(samples_per_silo=16, batch_size=4, lr=0.001)


def _tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("local_updates", [1, 2])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_legacy_matches_flat_bitwise(momentum, local_updates):
    """Three rounds of `fl_round_step` against one three-round call of
    the flat cycle from the same row and batches: params, buffers (in the
    original edge order), momentum and losses bit-equal."""
    rounds = 3
    spec = psmall.SMALL_MODELS["femnist_cnn"]
    params = spec.init(torch.Generator().manual_seed(0))
    plan, _ = dpasgd.make_round_schedule("multigraph",
                                         pregistry.get_network("gaia"),
                                         FEMNIST)
    data = make_federated_dataset("femnist", N, samples_per_silo=16)
    rng = np.random.default_rng(1)
    per = [[[data.sample_batch(s, 4, rng) for s in range(N)]
            for _ in range(local_updates)] for _ in range(rounds)]
    xs = torch.as_tensor(np.asarray([[[b["x"] for b in u] for u in r]
                                     for r in per]))
    ys = torch.as_tensor(np.asarray([[[b["y"] for b in u] for u in r]
                                     for r in per])).long()

    rt = pruntime.make_flat_runtime(plan, params, N)
    fopt = flat_sgd(0.05, momentum=momentum)
    cycle = pruntime.make_cycle_fn(rt, loss_fn=spec.loss, opt=fopt)
    flat, flat_losses = cycle(
        pruntime.init_flat_state(pflat.ravel(rt.spec, params), fopt, rt),
        {"x": xs, "y": ys}, *(torch.as_tensor(getattr(rt, k)[:rounds])
                              for k in ("strong", "coeffs", "diag")))

    lopt = sgd(0.05, momentum=momentum)
    state = dpasgd.init_fl_state(params, lopt, N, plan.src)
    losses = []
    for k in range(rounds):
        state, loss = dpasgd.fl_round_step(
            state, {"x": xs[k], "y": ys[k]}, plan.src, plan.dst,
            torch.as_tensor(plan.strong[k]), torch.as_tensor(plan.coeffs[k]),
            torch.as_tensor(plan.diag[k]), loss_fn=spec.loss, opt=lopt,
            local_updates=local_updates)
        losses.append(loss)
    assert torch.equal(torch.stack(losses), flat_losses)
    _tree_equal(state.silo_params, pruntime.unpack_params(rt, flat))
    _tree_equal(state.buffers, pruntime.unpack_buffers(rt, flat))
    assert state.opt_state["step"] == flat.opt_state["step"] == \
        rounds * local_updates
    if momentum:
        _tree_equal(state.opt_state["mu"], pflat.unravel_stacked(
            rt.spec, flat.opt_state["mu"]))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_legacy_run_fl_matches_flat_run_fl(momentum):
    kw = dict(RUN, rounds=5, eval_every=2, momentum=momentum)
    flat = prun_fl(PConfig(**kw), device="cpu")
    legacy = prun_fl(PConfig(runtime="legacy", **kw), device="cpu")
    assert legacy.round_losses == flat.round_losses
    assert legacy.eval_accs == flat.eval_accs
    assert legacy.eval_rounds == flat.eval_rounds == [2, 4, 5]
    assert legacy.cycle_times_ms == flat.cycle_times_ms


def test_legacy_run_fl_matches_reference(monkeypatch):
    start_port_from(monkeypatch, "femnist_cnn",
                    reference_init("femnist_cnn", N))
    kw = dict(RUN, rounds=6, eval_every=4, momentum=0.9, runtime="legacy")
    ref = rrun_fl(RConfig(**kw))
    got = prun_fl(PConfig(**kw), device="cpu")
    assert got.eval_rounds == [4, 6]
    assert_same_run(got, ref, rtol=1e-5, acc_atol=1 / 512)


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_dense_edge_aggregate(degree):
    """Bit-equal to `edge_aggregate_ref` (and so to the CUDA kernel) on a
    uniform in-degree, negative zeros included; within 1e-6 of the
    reference's `dense_edge_aggregate`, which XLA:CPU may contract into
    FMAs."""
    rng = np.random.default_rng(degree)
    n, t = 7, 1031
    w = rng.standard_normal((n, t)).astype(np.float32)
    buf = rng.standard_normal((n * degree, t)).astype(np.float32)
    buf[:, :5] = -0.0
    w[:, :3] = -0.0
    coeffs = rng.random(n * degree).astype(np.float32)
    diag = rng.random(n).astype(np.float32)
    row_ptr = torch.arange(0, n * degree + 1, degree, dtype=torch.int32)
    args = [torch.from_numpy(a) for a in (w, buf, coeffs)]
    got = dense_edge_aggregate(args[0], args[1],
                               args[2].reshape(n, degree),
                               torch.from_numpy(diag))
    want = edge_aggregate_ref(*args, row_ptr, torch.from_numpy(diag))
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    ref = rdense(jnp.asarray(w), jnp.asarray(buf),
                 jnp.asarray(coeffs.reshape(n, degree)), jnp.asarray(diag))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_dense_aggregator_in_the_cycle():
    """`aggregator="dense"` trains the ring as "kernel" does, bit for
    bit, and refuses a ragged in-degree (the star) with the reference's
    message."""
    kw = dict(RUN, topology="ring", rounds=4, eval_every=4)
    dense = ptrain(PConfig(**kw), device="cpu", aggregator="dense")
    kernel = ptrain(PConfig(**kw), device="cpu", aggregator="kernel")
    assert dense.round_losses == kernel.round_losses
    assert dense.eval_accs == kernel.eval_accs
    spec = psmall.SMALL_MODELS["femnist_cnn"]
    params = spec.init(torch.Generator())
    net = pregistry.get_network("gaia")
    plan, _ = dpasgd.make_round_schedule("star", net, FEMNIST)
    rt = pruntime.make_flat_runtime(plan, params, N)
    with pytest.raises(ValueError, match="uniform in-degree") as got:
        pruntime.make_cycle_fn(rt, loss_fn=spec.loss, opt=sgd(0.1),
                               aggregator="dense")
    from repro.core.delay import FEMNIST as RFEMNIST
    rplan, _ = rdpasgd.make_round_schedule("star", rregistry.get_network(
        "gaia"), RFEMNIST)
    rrt = rruntime.make_flat_runtime(rplan, reference_init("femnist_cnn", N),
                                     N)
    with pytest.raises(ValueError) as want:
        rruntime.make_cycle_fn(rrt, loss_fn=None, opt=None,
                               aggregator="dense")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="legacy"):
        ptrain(PConfig(runtime="legacy", **kw), device="cpu",
               aggregator="dense")


def _silos(net):
    return [dataclasses.astuple(s) for s in net.silos]


@pytest.mark.parametrize("k", [16, 64, 100])
def test_wan_networks_match_reference(k):
    got, want = pregistry.get_network(f"wan{k}"), \
        rregistry.get_network(f"wan{k}")
    assert got.name == want.name == f"wan{k}" and got.num_silos == k
    assert _silos(got) == _silos(want)
    np.testing.assert_array_equal(got.latency_ms, want.latency_ms)
    assert _silos(pregistry.get_network(f"wan{k}", capacity_gbps=25.0)) == \
        _silos(rregistry.get_network(f"wan{k}", capacity_gbps=25.0))


def test_registry_matches_reference():
    for include in (False, True):
        assert pregistry.list_networks(include_patterns=include) == \
            rregistry.list_networks(include_patterns=include)
    assert pregistry.list_networks(include_patterns=True)[-1] == "wan<K>"
    for bad in ("wan", "wanX", "mars"):
        with pytest.raises(KeyError, match="wan<K>"):
            pregistry.get_network(bad)
        with pytest.raises(KeyError):
            rregistry.get_network(bad)


def test_run_fl_wan16_matches_reference(monkeypatch):
    """FEMNIST over the multigraph on a generated 16-silo WAN."""
    start_port_from(monkeypatch, "femnist_cnn",
                    reference_init("femnist_cnn", 16))
    kw = dict(RUN, network="wan16", rounds=6, eval_every=3)
    ref = rrun_fl(RConfig(**kw))
    got = prun_fl(PConfig(**kw), device="cpu")
    assert got.eval_rounds == [3, 6]
    assert_same_run(got, ref, rtol=1e-5, acc_atol=1 / 512)


@pytest.mark.parametrize("hook", ["metrics", "trace", "ckpt_dir", "mesh"])
def test_hooks_on_legacy_refused_as_in_reference(hook, tmp_path):
    """The reference's ValueErrors for metrics, trace, checkpoints and a
    mesh on the legacy runtime, raised before any work."""
    value = {"metrics": None, "trace": str(tmp_path / "t.json"),
             "ckpt_dir": str(tmp_path / "ck"), "mesh": 2}[hook]
    pkw = dict(runtime="legacy", rounds=2, **{hook: value})
    rkw = dict(pkw)
    if hook == "metrics":
        pkw["metrics"], rkw["metrics"] = MetricsSpec(), RMetricsSpec()
    with pytest.raises(ValueError) as got:
        prun_fl(PConfig(**pkw), device="cpu")
    with pytest.raises(ValueError) as want:
        rrun_fl(RConfig(**rkw))
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]
    assert not (tmp_path / "ck").exists()


def test_legacy_csr_order_equals_runtime_order():
    """`fl_round_step` sorts the edges as `make_flat_runtime` does."""
    plan, _ = dpasgd.make_round_schedule("multigraph",
                                         pregistry.get_network("geant"),
                                         FEMNIST)
    order, row_ptr = ops.csr_sort(plan.dst, 40)
    rt = pruntime.make_flat_runtime(plan, {"w": torch.zeros(3)}, 40)
    np.testing.assert_array_equal(order, rt.order)
    np.testing.assert_array_equal(row_ptr, rt.row_ptr)
