"""LoRA deltas in the port (`repro_torch.fl.lora`) on the CPU.

The delta's layout (`delta_template`, `lora_size`) equals the
reference's leaf for leaf, on the reference tests' trees and on reduced
mamba2 and yi-9b trees, and `apply_delta` on the reference's own delta
arrays equals `repro.fl.lora.apply_delta` (the dense and zero deltas bit
for bit; the low-rank products within 2 fp32 ulps of the output, since
XLA:CPU and torch order the rank-r dot product each their own way).
`init_delta` draws A from a `torch.Generator` (the reference's
`jax.random` stream is not reproducible in torch), so the start is held
to the reference's contract instead: B = 0 and apply(base, delta_0) ==
base bit for bit. Then the reference's LoRA mesh-cycle test on the port,
`run_reduced_fl(mesh=, lora_rank=)` at D = 1 against D = 2, and the
fleet serving the `lora_delta` checkpoint it writes, against a `full`
twin of its materialised variants, and refusing one without the port's
base draw.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as rconfigs  # noqa: E402
from repro.fl import lora as rlora  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402

from repro_torch.checkpoint import FLCheckpoint, load_fl_checkpoint  # noqa: E402
from repro_torch.configs import get_config, reduce  # noqa: E402
from repro_torch.core.delay import FEMNIST  # noqa: E402
from repro_torch.fl import dpasgd, lora  # noqa: E402
from repro_torch.fl import flat as flatmod  # noqa: E402
from repro_torch.fl import mesh as pmesh  # noqa: E402
from repro_torch.fl import runtime as prt  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.launch.mesh import tree_leaves  # noqa: E402
from repro_torch.networks.registry import get_network  # noqa: E402
from repro_torch.optim import flat_sgd  # noqa: E402
from repro_torch.serving import RegionalFleet  # noqa: E402
from repro_torch.serving.traffic import TrafficConfig, sweep_loads  # noqa: E402
from _torch_fl_parity import one_thread  # noqa: E402,F401

EPS = 2.0 ** -23


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


@functools.lru_cache(maxsize=None)
def _reduced(arch):
    cfg = rconfigs.reduce(rconfigs.get_config(arch))
    return jax.device_get(jax.jit(lambda k: rtf.init_params(cfg, k))(
        jax.random.PRNGKey(0)))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _named(tree):
    """{"/"-joined key path: leaf} of a jax tree, in its leaf order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): leaf for path, leaf in flat}


TREES = {
    "reference_size_test": ({"m": (64, 48), "b": (48,), "tiny": (2, 2)}, 4),
    "reference_identity_test": ({"m": (16, 12), "s": (3, 10, 8),
                                 "b": (12,)}, 2),
    "mamba2_reduced": ("mamba2-370m", 8),
    "yi9b_reduced": ("yi-9b", 4),
}


def _tree_case(name):
    spec, rank = TREES[name]
    ref = _reduced(spec) if isinstance(spec, str) else _random_tree(spec, 0)
    return ref, rank


@pytest.mark.parametrize("name", list(TREES))
def test_delta_template_and_size_match_reference(name):
    ref, rank = _tree_case(name)
    shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          ref)
    want = _named(rlora.delta_template(shapes, rank))
    spec = flatmod.make_flat_spec(lora.delta_template(_to_torch(ref), rank))
    assert spec.names == tuple(want)
    assert spec.shapes == tuple(tuple(x.shape) for x in want.values())
    assert set(spec.dtypes) == {torch.float32}
    assert spec.size == lora.lora_size(_to_torch(ref), rank) == \
        rlora.lora_size(shapes, rank)
    assert spec.size < sum(x.size for x in jax.tree.leaves(ref))


@pytest.mark.parametrize("name", list(TREES))
def test_apply_delta_matches_reference(name):
    """The reference's delta arrays fed to both packages: dense deltas
    bit-equal; base + A@B within 2 ulps of the output (the rank-r dot
    product is ordered differently)."""
    ref, rank = _tree_case(name)
    shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          ref)
    rng = np.random.default_rng(1)
    delta = jax.tree.map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        rlora.delta_template(shapes, rank))
    want = _named(jax.device_get(jax.jit(rlora.apply_delta)(ref, delta)))
    got = flatmod.make_flat_spec(_to_torch(ref))
    out = lora.apply_delta(_to_torch(ref), _to_torch(delta))
    for (name_, leaf), w in zip(zip(got.names, flatmod._ordered(got, out)),
                                want.values()):
        w = np.asarray(w)
        if leaf.dim() >= 2 and lora._is_lowrank(tuple(leaf.shape), rank):
            np.testing.assert_allclose(leaf.numpy(), w, rtol=0,
                                       atol=2 * EPS * np.abs(w).max())
        else:
            np.testing.assert_array_equal(leaf.numpy(), w, err_msg=name_)


def test_zero_delta_is_the_base():
    base = _to_torch(_random_tree({"m": (16, 12), "s": (3, 10, 8),
                                   "b": (12,)}, 0))
    ad = lora.make_lora_adapter(base, rank=2)
    d0 = ad.init(torch.Generator().manual_seed(1))
    assert set(d0["m"]) == {"A", "B"} and set(d0["s"]) == {"A", "B"}
    assert d0["m"]["A"].shape == (16, 2) and d0["s"]["B"].shape == (3, 2, 8)
    assert not d0["m"]["B"].any() and not d0["b"].any()
    assert d0["m"]["A"].abs().max() > 0
    again = ad.init(torch.Generator().manual_seed(1))
    assert torch.equal(again["s"]["A"], d0["s"]["A"])
    p0 = ad.apply(d0)
    for k in base:
        assert torch.equal(p0[k], base[k])
    batch = {"x": torch.ones(2, 12)}
    loss = lambda p, b: ((b["x"] @ p["m"].T) ** 2).mean()
    assert ad.wrap_loss(loss)(d0, batch) == loss(base, batch)


@pytest.mark.parametrize("d", [1, 4])
def test_lora_mesh_cycle_matches_single_device(d):
    """The reference's test on the port: LoRA deltas ride the mesh
    runtime unchanged (T is just smaller), bit-equal to the flat
    runtime, and training moves them."""
    plan, _ = dpasgd.make_round_schedule("multigraph", get_network("gaia"),
                                         FEMNIST, t=5)
    n = plan.diag.shape[1]
    rng = np.random.default_rng(0)
    base = {"w1": torch.from_numpy(rng.normal(size=(12, 8)).astype(
        np.float32)), "b": torch.zeros(8)}
    ad = lora.make_lora_adapter(base, rank=2)
    delta0 = ad.init(torch.Generator().manual_seed(0))

    def loss_fn(p, batch):
        return torch.mean((batch["x"] @ p["w1"] + p["b"]) ** 2)

    opt = flat_sgd(0.05, momentum=0.9)
    rt = prt.make_flat_runtime(plan, delta0, n)
    assert rt.spec.size == lora.lora_size(base, 2) == (12 + 8) * 2 + 8
    r = plan.num_rounds_cycle
    batches = {"x": torch.from_numpy(rng.normal(size=(r, 1, n, 2, 12)).astype(
        np.float32))}
    args = [torch.as_tensor(x) for x in (rt.strong, rt.coeffs, rt.diag)]
    w0 = flatmod.ravel(rt.spec, delta0)
    s0, l0 = prt.make_cycle_fn(rt, loss_fn=ad.wrap_loss(loss_fn), opt=opt)(
        prt.init_flat_state(w0, opt, rt), batches, *args)
    mrt = pmesh.make_mesh_runtime(rt, d)
    sm, lm = prt.make_cycle_fn(mrt, loss_fn=ad.wrap_loss(loss_fn), opt=opt)(
        pmesh.init_mesh_state(w0, opt, mrt), batches, *args)
    flat = pmesh.gather_flat_state(mrt, sm)
    assert torch.equal(s0.w, flat.w) and torch.equal(s0.buffers, flat.buffers)
    assert torch.equal(l0, lm)
    assert not torch.equal(s0.w, w0.expand_as(s0.w))



def _lora_loss_jax(p, batch):
    h = jnp.tanh((batch["x"] + p["b"]) @ p["m"].T)
    return jnp.mean(h ** 2) + 0.01 * jnp.mean(p["s"] ** 2)


def _lora_loss_torch(p, batch):
    h = torch.tanh((batch["x"] + p["b"]) @ p["m"].T)
    return torch.mean(h ** 2) + 0.01 * torch.mean(p["s"] ** 2)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_lora_cycle_matches_reference_flat_runtime(momentum):
    """One whole gaia cycle (15 rounds) of LoRA deltas on the port's flat
    runtime and on its D = 2 mesh runtime, against
    `repro.fl.runtime.make_cycle_fn` over `repro.fl.lora.make_lora_adapter`,
    both fed the same base, the reference's delta_0 and the same batches.
    The base has a matrix, a stacked (3, 10, 8) leaf and a vector, so the
    cycle trains low-rank, stacked low-rank and dense deltas. Losses
    within 1e-6 relative and rows within 4 fp32 ulps of the largest entry
    (largest readings 3.5e-7 and 1 ulp: the rank-r products are ordered
    each package's own way); the mesh rows bit-equal to the flat ones."""
    from repro.core.delay import FEMNIST as RFEMNIST
    from repro.fl import dpasgd as rdpasgd, flat as rflat
    from repro.fl import runtime as rruntime
    from repro.networks.registry import get_network as rget
    from repro.optim import flat_sgd as rflat_sgd

    base = _random_tree({"m": (16, 12), "s": (3, 10, 8), "b": (12,)}, 0)
    rad = rlora.make_lora_adapter(jax.tree.map(jnp.asarray, base), 2)
    rdelta0 = rad.init(jax.random.PRNGKey(0))
    rplan, _ = rdpasgd.make_round_schedule("multigraph", rget("gaia"),
                                           RFEMNIST, t=5)
    rrt = rruntime.make_flat_runtime(rplan, rdelta0, rplan.diag.shape[1])
    ropt = rflat_sgd(0.05, momentum=momentum)
    n, r = rrt.num_silos, rrt.num_rounds_cycle
    rw = jnp.broadcast_to(rflat.ravel(rrt.spec, rdelta0)[None],
                          (n, rrt.spec.size)).copy()
    xs = np.random.default_rng(1).normal(size=(r, 1, n, 2, 12)).astype(
        np.float32)
    rstate, rlosses = rruntime.make_cycle_fn(
        rrt, loss_fn=rad.wrap_loss(_lora_loss_jax), opt=ropt,
        aggregator="reference")(
        rruntime.FlatFLState(rw, ropt.init(rw),
                             rw[jnp.asarray(rrt.src_sorted)]),
        {"x": jnp.asarray(xs)}, jnp.asarray(rrt.strong),
        jnp.asarray(rrt.coeffs), jnp.asarray(rrt.diag))

    ad = lora.make_lora_adapter(_to_torch(base), 2)
    delta0 = _to_torch(jax.device_get(rdelta0))
    plan, _ = dpasgd.make_round_schedule("multigraph", get_network("gaia"),
                                         FEMNIST, t=5)
    rt = prt.make_flat_runtime(plan, delta0, n)
    np.testing.assert_array_equal(rt.strong, rrt.strong)
    w0 = flatmod.ravel(rt.spec, delta0)
    np.testing.assert_array_equal(w0.numpy(),
                                  np.asarray(rflat.ravel(rrt.spec, rdelta0)))
    opt = flat_sgd(0.05, momentum=momentum)
    args = [torch.as_tensor(x) for x in (rt.strong, rt.coeffs, rt.diag)]
    batches = {"x": torch.from_numpy(xs)}
    loss = ad.wrap_loss(_lora_loss_torch)
    state, losses = prt.make_cycle_fn(rt, loss_fn=loss, opt=opt)(
        prt.init_flat_state(w0, opt, rt), batches, *args)
    np.testing.assert_allclose(losses.numpy(), np.asarray(rlosses),
                               rtol=1e-6)
    for got, want in ((state.w, rstate.w), (state.buffers, rstate.buffers)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=4 * EPS * np.abs(want).max())
    moved = (state.w - w0).abs().max()
    assert moved > 1e4 * 4 * EPS * np.abs(np.asarray(rstate.w)).max()
    mrt = pmesh.make_mesh_runtime(rt, 2)
    mstate, mlosses = prt.make_cycle_fn(mrt, loss_fn=loss, opt=opt)(
        pmesh.init_mesh_state(w0, opt, mrt), batches, *args)
    flat = pmesh.gather_flat_state(mrt, mstate)
    assert torch.equal(flat.w, state.w) and torch.equal(mlosses, losses)
    assert torch.equal(flat.buffers, state.buffers)

TRAIN = dict(rounds=3, silos=3, seq_len=16, batch_size=2, lora_rank=4)


@pytest.fixture(scope="module")
def lora_runs(tmp_path_factory):
    """`run_reduced_fl(lora_rank=4)` at D = 1 and D = 2, checkpoints at
    rounds 2 and 3."""
    out = {}
    for d in (1, 2):
        ck = tmp_path_factory.mktemp(f"lora{d}")
        out[d] = (ptrain.run_reduced_fl(ptrain.TrainConfig(
            **TRAIN, mesh=d, ckpt_dir=str(ck), ckpt_every=2), device="cpu"),
            str(ck))
    return out


def test_run_reduced_fl_lora_mesh_d1_equals_d2(lora_runs):
    (r1, ck1), (r2, ck2) = lora_runs[1], lora_runs[2]
    assert r1["losses"] == r2["losses"] and len(r1["losses"]) == 3
    assert np.isfinite(r1["losses"]).all()
    assert r1["sim_mean_cycle_ms"] == r2["sim_mean_cycle_ms"]
    assert r1["ckpt_steps"] == r2["ckpt_steps"] == [2, 3]
    a, b = load_fl_checkpoint(ck1), load_fl_checkpoint(ck2)
    np.testing.assert_array_equal(a.w, b.w)
    mcfg = reduce(get_config("mamba2-370m"))
    base = lora.lora_base(mcfg, 0, "cpu")
    assert a.w.shape == (3, lora.lora_size(base, 4))
    assert (a.meta["params_kind"], a.meta["base_init"], a.meta["lora_rank"]) \
        == ("lora_delta", lora.BASE_INIT, 4)
    assert a.meta == b.meta
    # the base is the host draw of seed + 1, whatever the run's device
    again = lora.lora_base(mcfg, 0, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(base),
                                                 tree_leaves(again)))


def _served_tokens(fleet):
    sweep_loads(fleet, TrafficConfig(seed=0, duration_ms=200.0,
                                     step_ms=10.0), [60.0])
    return {r: [q.output for q in v.engine.completed]
            for r, v in fleet.regions.items()}


def test_fleet_serves_lora_delta_checkpoint(lora_runs):
    """Each region serves apply_delta(base, mean of its silos' delta
    rows), bit for bit, and the same tokens as a fleet over a `full`
    checkpoint of those materialised variants (float64 rows: the mean of
    a region's identical rows is exact)."""
    ckpt = load_fl_checkpoint(lora_runs[2][1])
    fleet = RegionalFleet.from_checkpoint(ckpt, max_slots=2, max_seq=48,
                                          device="cpu")
    mcfg = reduce(get_config("mamba2-370m"))
    base = lora.lora_base(mcfg, 0, "cpu")
    dspec = flatmod.make_flat_spec(lora.delta_template(base, 4))
    fspec = flatmod.make_flat_spec(base)
    twin_w = np.zeros((ckpt.num_silos, fspec.size))
    for rname, reg in fleet.regions.items():
        mean = torch.from_numpy(np.mean(ckpt.w[reg.silo_indices], axis=0))
        want = lora.apply_delta(base, flatmod.unravel(dspec, mean))
        for x, y in zip(tree_leaves(reg.engine.params), tree_leaves(want)):
            assert torch.equal(x, y)
        twin_w[reg.silo_indices] = flatmod.ravel(fspec, want).numpy()
    twin = RegionalFleet.from_checkpoint(
        FLCheckpoint(step=ckpt.step, w=twin_w, meta=dict(
            ckpt.meta, params_kind="full", lora_rank=0)),
        max_slots=2, max_seq=48, device="cpu")
    got = _served_tokens(fleet)
    assert got == _served_tokens(twin) and any(got.values())


def test_fleet_refuses_lora_without_the_port_base(lora_runs):
    ckpt = load_fl_checkpoint(lora_runs[1][1])
    meta = {k: v for k, v in ckpt.meta.items() if k != "base_init"}
    with pytest.raises(ValueError, match="jax.random"):
        RegionalFleet.from_checkpoint(
            FLCheckpoint(step=ckpt.step, w=ckpt.w, meta=meta), device="cpu")
