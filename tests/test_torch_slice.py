"""The port's main path against the reference's: one whole cycle of the
flat runtime, and `run_fl` end to end (FEMNIST over the multigraph, on
gaia and amazon, at momentum 0.9, with two local updates and at t = 3).
The other topologies and the ablations are in
`test_torch_slice_topologies.py`, the other models in
`test_torch_slice_models.py`.

Both sides start from the reference's initial row, carried across with
`params_from_reference`, and see the same numpy batches. Tolerances:
the per-silo fp32 gradients differ by a few ulps (im2col + matmul on
XLA:CPU against `F.conv2d`), and fifteen rounds of SGD and gossip carry
that forward, so after a cycle `w` and the buffers agree to 1e-4
absolute and the losses to 1e-5 relative. lr is 0.001 here because at
the default 0.05 the first rounds of this untrained CNN on batches of
four are chaotic: ulp-level differences grow to percent level within a
cycle in the reference itself as much as in the port. Accuracies are
counts over 512 test samples; they may differ by one sample.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from _torch_fl_parity import (assert_same_run, reference_init,  # noqa: E402
                              run_both, start_port_from)
from repro.core.delay import FEMNIST as RFEMNIST  # noqa: E402
from repro.data.synthetic import make_federated_dataset  # noqa: E402
from repro.fl import dpasgd as rdpasgd, flat as rflat  # noqa: E402
from repro.fl import runtime as rruntime  # noqa: E402
from repro.models.small import FEMNIST_CNN as RCNN  # noqa: E402
from repro.networks.registry import get_network as rget  # noqa: E402
from repro.optim import flat_sgd as rflat_sgd  # noqa: E402

from repro_torch.core.delay import FEMNIST as PFEMNIST  # noqa: E402
from repro_torch.fl import FLConfig as PConfig, run_fl as prun_fl  # noqa: E402
from repro_torch.fl import dpasgd as pdpasgd, flat as pflat  # noqa: E402
from repro_torch.fl import runtime as pruntime  # noqa: E402
from repro_torch.models import small as psmall  # noqa: E402
from repro_torch.networks.registry import get_network as pget  # noqa: E402
from repro_torch.optim import flat_sgd as pflat_sgd  # noqa: E402

N = 11
LR = 0.001


def _reference_init(seed=0):
    """The reference trainer's initial parameters (`init_flat_state`
    draws from the first of N split keys)."""
    key = jax.random.split(jax.random.PRNGKey(seed), N)[0]
    return {k: np.asarray(v)
            for k, v in jax.device_get(RCNN.init(key)).items()}


def _batches(rounds, b=4):
    data = make_federated_dataset("femnist", N, samples_per_silo=16, seed=0)
    rng = np.random.default_rng(1)
    xs, ys = [], []
    for _ in range(rounds):
        per = [data.sample_batch(s, b, rng) for s in range(N)]
        xs.append(np.stack([p["x"] for p in per])[None])
        ys.append(np.stack([p["y"] for p in per])[None])
    return np.stack(xs), np.stack(ys)


def test_one_cycle_matches_reference():
    init = _reference_init()
    rplan, _ = rdpasgd.make_round_schedule("multigraph", rget("gaia"),
                                           RFEMNIST)
    rrt = rruntime.make_flat_runtime(rplan, init, N)
    ropt = rflat_sgd(LR)
    w0 = rflat.ravel(rrt.spec, init)
    rw = jnp.broadcast_to(w0[None], (N, rrt.spec.size)).copy()
    rstate = rruntime.FlatFLState(rw, ropt.init(rw),
                                  rw[jnp.asarray(rrt.src_sorted)])
    xs, ys = _batches(rrt.num_rounds_cycle)
    rcycle = rruntime.make_cycle_fn(rrt, loss_fn=RCNN.loss, opt=ropt,
                                    aggregator="reference")
    rstate, rlosses = rcycle(rstate, {"x": jnp.asarray(xs),
                                      "y": jnp.asarray(ys)},
                             jnp.asarray(rrt.strong), jnp.asarray(rrt.coeffs),
                             jnp.asarray(rrt.diag))

    pplan, _ = pdpasgd.make_round_schedule("multigraph", pget("gaia"),
                                           PFEMNIST)
    params = psmall.params_from_reference(init)
    prt = pruntime.make_flat_runtime(pplan, params, N)
    np.testing.assert_array_equal(prt.row_ptr, rrt.row_ptr)
    np.testing.assert_array_equal(prt.src_sorted, rrt.src_sorted)
    for f in ("strong", "coeffs", "diag"):
        np.testing.assert_array_equal(getattr(prt, f), getattr(rrt, f))
        assert getattr(prt, f).flags.c_contiguous, f  # rows feed the kernel
    popt = pflat_sgd(LR)
    pstate = pruntime.init_flat_state(pflat.ravel(prt.spec, params), popt,
                                      prt)
    np.testing.assert_array_equal(pstate.w.numpy(), np.asarray(rw))
    pcycle = pruntime.make_cycle_fn(prt, loss_fn=psmall.FEMNIST_CNN.loss,
                                    opt=popt, aggregator="reference")
    pstate, plosses = pcycle(
        pstate, {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys).long()},
        torch.from_numpy(prt.strong), torch.from_numpy(prt.coeffs),
        torch.from_numpy(prt.diag))

    assert plosses.shape == (15,)
    np.testing.assert_allclose(plosses.numpy(), np.asarray(rlosses),
                               rtol=1e-5)
    np.testing.assert_allclose(pstate.w.numpy(), np.asarray(rstate.w),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(pstate.buffers.numpy(),
                               np.asarray(rstate.buffers), rtol=0, atol=1e-4)
    assert pstate.opt_state["step"] == 15
    stacked = pruntime.unpack_params(prt, pstate)
    assert stacked["c2"].shape == (N, 5, 5, 32, 64)
    assert stacked["c2"]._base is pstate.w  # views of the (N, T) rows


@pytest.mark.parametrize("change", [
    dict(), dict(network="amazon"), dict(momentum=0.9),
    dict(local_updates=2), dict(t=3)],
    ids=["gaia", "amazon", "momentum", "local_updates", "t3"])
def test_run_fl_matches_reference(monkeypatch, change):
    """FEMNIST over the multigraph, as is and in the four set-ups of
    ROADMAP queue 3 (amazon, momentum 0.9, two local updates, t = 3)."""
    n = pget(change.get("network", "gaia")).num_silos
    start_port_from(monkeypatch, "femnist_cnn",
                    reference_init("femnist_cnn", n))
    ref, got = run_both(rounds=6, eval_every=4, samples_per_silo=16,
                        batch_size=4, lr=LR, **change)
    assert got.eval_rounds == [4, 6]
    assert_same_run(got, ref, rtol=1e-5, acc_atol=1 / 512)


@pytest.mark.parametrize("change,err", [
    (dict(runtime="legacy", mesh=2), ValueError),
    (dict(mesh=2), NotImplementedError),
    (dict(runtime="legacy", trace="t.json"), ValueError),
    (dict(runtime="legacy", ckpt_dir="ck"), ValueError),
    (dict(metrics=object()), TypeError)],
    ids=["legacy", "mesh", "trace", "ckpt_dir", "metrics"])
def test_run_fl_rejects_unported(change, err):
    """`mesh=` is the one option not ported; the legacy runtime refuses a
    mesh, a trace and checkpoints as the reference does, and metrics must
    be a `MetricsSpec`."""
    with pytest.raises(err):
        prun_fl(PConfig(rounds=1, **change), device="cpu")
