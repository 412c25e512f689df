"""The port's training pieces against the reference on reduced configs
(fp32), with the reference's weights carried across by
`params_from_reference`: `transformer.loss_fn` (plain and streamed
cross entropy, with a prefix and with the MoE aux loss) and its
gradients against `jax.grad`; `optim.adamw`, `cosine_schedule` and
`clip_by_global_norm`; `launch.steps.make_train_step` (one and three
steps, micro batches) and `make_fl_train_step` (2 and 4 silos, with and
without the consensus).

fp32 within 5e-4 (rtol and atol), as the reference's own tests.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as rconfigs  # noqa: E402
from repro import optim as roptim  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import frontends as rfe  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402

from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch import optim as poptim  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.launch.mesh import tree_leaves  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from _torch_fl_parity import one_thread  # noqa: E402,F401


def F32(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4, err_msg=msg)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _same_tree(got, want, msg=""):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), msg
        for k in got:
            _same_tree(got[k], want[k], f"{msg}/{k}")
    else:
        F32(_np(got), _np(want), msg)


def _setup(arch, seed=0):
    rcfg = rconfigs.reduce(rconfigs.get_config(arch))
    pcfg = pconfigs.reduce(pconfigs.get_config(arch))
    rparams = rtf.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, pcfg, rparams, ptf.params_from_reference(
        jax.device_get(rparams))


def _batch(cfg, b=2, s=32, seed=1, prefix=False):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if prefix:
        batch["prefix_embeds"] = np.asarray(
            rfe.synthetic_prefix(cfg, b, seed=seed))
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


LOSS_CASES = [("yi_9b", False), ("granite_moe_1b", False),
              ("paligemma_3b", True), ("mamba2_370m", False)]


@pytest.mark.parametrize("arch,prefix", LOSS_CASES,
                         ids=[a for a, _ in LOSS_CASES])
@pytest.mark.parametrize("ce_block", [None, 12])
def test_loss_fn_matches_reference(arch, prefix, ce_block):
    """The loss and its parts; a ce_block that does not divide S (32)
    leaves a short last block."""
    rcfg, pcfg, rparams, pparams = _setup(arch)
    rb, pb = _batch(pcfg, prefix=prefix)
    want, want_parts = jax.jit(lambda p, b: rtf.loss_fn(
        p, rcfg, b, ce_block=ce_block))(rparams, rb)
    got, parts = ptf.loss_fn(pparams, pcfg, pb, ce_block=ce_block)
    F32(float(got), float(want))
    F32(float(parts["ce"]), float(want_parts["ce"]))
    F32(float(parts["aux"]), float(want_parts["aux"]))
    assert (float(parts["aux"]) > 0) == (pcfg.family == "moe")


@pytest.mark.parametrize("arch,prefix", LOSS_CASES,
                         ids=[a for a, _ in LOSS_CASES])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_gradients_match_jax_grad(arch, prefix, remat):
    """Every leaf's gradient of `make_loss_fn` (chunked attention,
    streamed cross entropy of 16) against `jax.grad` of the reference's,
    with and without remat."""
    rcfg, pcfg, rparams, pparams = _setup(arch, seed=2)
    rb, pb = _batch(pcfg, seed=3, prefix=prefix)
    rloss_fn = rsteps.make_loss_fn(rcfg, remat=remat, ce_block=16)
    want_l, want_g = jax.jit(jax.value_and_grad(rloss_fn))(rparams, rb)
    loss_fn = psteps.make_loss_fn(pcfg, remat=remat, ce_block=16)
    got_l, got_g = psteps._value_and_grad(loss_fn, pparams, pb)
    F32(float(got_l), float(want_l))
    _same_tree(got_g, jax.device_get(want_g))
    # the caller's parameters stay leaves without gradients
    assert not any(p.requires_grad or p.grad is not None
                   for p in tree_leaves(pparams))


def test_make_loss_fn_kernel_raises():
    cfg = pconfigs.reduce(pconfigs.get_config("yi_9b"))
    with pytest.raises(ValueError, match="no backward"):
        psteps.make_loss_fn(cfg, impl="kernel")
    with pytest.raises(ValueError, match="unknown attention impl"):
        psteps.make_loss_fn(cfg, impl="pallas")
    assert psteps.TRAIN_IMPL == rsteps.DEFAULT_IMPL == "chunked"
    assert psteps.DEFAULT_IMPL == "kernel"


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 5)).astype(dtype),
            "b": {"c": rng.normal(size=(7,)).astype(dtype)}}


def _jt(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tt(tree):
    return {k: _tt(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference(weight_decay):
    """Five updates with new grads each, at lr_scale 1 and 0.5: params,
    m and v; the step counter shared."""
    ropt = roptim.adamw(3e-2, weight_decay=weight_decay)
    popt = poptim.adamw(3e-2, weight_decay=weight_decay)
    rp, pp = _jt(_tree(0)), _tt(_tree(0))
    rs, ps = ropt.init(rp), popt.init(pp)
    for k in range(5):
        g = _tree(10 + k)
        scale = 1.0 if k < 3 else 0.5
        rp, rs = ropt.update(rp, _jt(g), rs, scale)
        pp, ps = popt.update(pp, _tt(g), ps, scale)
    _same_tree(pp, jax.device_get(rp))
    _same_tree(ps["m"], jax.device_get(rs["m"]))
    _same_tree(ps["v"], jax.device_get(rs["v"]))
    assert ps["step"] == int(rs["step"]) == 5
    assert ps["m"]["a"].dtype == torch.float32


def test_adamw_keeps_bf16_params_with_fp32_state():
    opt = poptim.adamw(1e-2)
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    s = opt.init(p)
    p2, s2 = opt.update(p, {"w": torch.full((4,), 0.5,
                                             dtype=torch.bfloat16)}, s)
    assert p2["w"].dtype == torch.bfloat16
    assert s2["m"]["w"].dtype == s2["v"]["w"].dtype == torch.float32
    # one step moves each weight by lr * g / |g|, rounded to bf16
    assert torch.equal(p2["w"], torch.full((4,), 0.99).to(torch.bfloat16))


def test_cosine_schedule_matches_reference():
    for total, warmup in ((100, 0), (100, 10), (7, 3)):
        rlr = roptim.cosine_schedule(1e-3, total, warmup)
        plr = poptim.cosine_schedule(1e-3, total, warmup)
        for step in (0, 1, 2, 3, 5, 10, 50, 99, 100, 150):
            np.testing.assert_allclose(plr(step), float(rlr(step)),
                                       rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(4)
    rg, rn = roptim.clip_by_global_norm(_jt(g), max_norm)
    pg, pn = poptim.clip_by_global_norm(_tt(g), max_norm)
    F32(float(pn), float(rn))
    _same_tree(pg, jax.device_get(rg))
    bf = poptim.clip_by_global_norm(
        {"x": torch.ones(3, dtype=torch.bfloat16)}, 0.1)[0]["x"]
    assert bf.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi_9b", "granite_moe_1b"])
@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_reference(arch, steps):
    """`make_train_step` (AdamW 1e-4, chunked, remat) for 1 and 3 steps,
    a new batch each: losses and parameters."""
    rcfg, pcfg, rparams, pparams = _setup(arch, seed=5)
    rstep = jax.jit(rsteps.make_train_step(rcfg))
    pstep = psteps.make_train_step(pcfg)
    ropt = roptim.adamw(1e-4)
    rs, ps = ropt.init(rparams), poptim.adamw(1e-4).init(pparams)
    for k in range(steps):
        rb, pb = _batch(pcfg, seed=20 + k)
        rl, rparams, rs = rstep(rparams, rs, rb)
        pl, pparams, ps = pstep(pparams, ps, pb)
        F32(float(pl), float(rl), f"step {k}")
    _same_tree(pparams, jax.device_get(rparams))
    assert ps["step"] == steps


def test_microbatch_matches_one_batch():
    """`microbatch=2` against 1 on the same batch of 4: the loss and the
    updated parameters (and the reference's microbatch=2 step)."""
    rcfg, pcfg, rparams, pparams = _setup("yi_9b", seed=6)
    rb, pb = _batch(pcfg, b=4, seed=7)
    opt = poptim.adamw(1e-4)
    l1, p1, _ = psteps.make_train_step(pcfg, opt)(pparams, opt.init(pparams),
                                                  pb)
    l2, p2, _ = psteps.make_train_step(pcfg, opt, microbatch=2)(
        pparams, opt.init(pparams), pb)
    F32(float(l2), float(l1))
    _same_tree(p2, p1)
    ropt = roptim.adamw(1e-4)
    rl, rp, _ = jax.jit(rsteps.make_train_step(rcfg, ropt, microbatch=2))(
        rparams, ropt.init(rparams), rb)
    F32(float(l2), float(rl))
    _same_tree(p2, jax.device_get(rp))
    with pytest.raises(ValueError, match="multiple of microbatch"):
        psteps.make_train_step(pcfg, opt, microbatch=3)(
            pparams, opt.init(pparams), pb)


def _stack(tree, n):
    return {k: _stack(v, n) if isinstance(v, dict)
            else torch.stack([v] * n) for k, v in tree.items()}


@pytest.mark.parametrize("silos", [2, 4])
@pytest.mark.parametrize("gossip", [True, False])
def test_fl_train_step_matches_reference(silos, gossip):
    """`make_fl_train_step` on a stacked silo axis, each silo its own
    batch, two rounds: the mean loss, the parameters (the consensus
    average for 2 silos, the ring's Metropolis weights for 4) and AdamW's
    moments; without gossip each silo keeps its local update."""
    rcfg, pcfg, rparams, pparams = _setup("yi_9b", seed=8)
    rparams = jax.tree.map(lambda x: jnp.stack([x] * silos), rparams)
    pparams = _stack(pparams, silos)
    # the builders' default AdamW(1e-4): a near-zero gradient entry may
    # take either sign in the two packages, and Adam moves it by lr
    ropt, popt = roptim.adamw(1e-4), poptim.adamw(1e-4)
    rs, ps = jax.vmap(ropt.init)(rparams), popt.init(pparams)
    rstep = jax.jit(rsteps.make_fl_train_step(rcfg, silos, ropt,
                                              gossip=gossip))
    pstep = psteps.make_fl_train_step(pcfg, silos, popt, gossip=gossip)
    for k in range(2):
        toks = np.random.default_rng(30 + k).integers(
            0, pcfg.vocab_size, (silos, 2, 17))
        b = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
        rl, rparams, rs = rstep(rparams, rs, {x: jnp.asarray(v)
                                              for x, v in b.items()})
        pl, pparams, ps = pstep(pparams, ps, {x: torch.from_numpy(v)
                                              for x, v in b.items()})
        F32(float(pl), float(rl), f"round {k}")
    _same_tree(pparams, jax.device_get(rparams))
    _same_tree(ps["m"], jax.device_get(rs["m"]))
    spread = float((pparams["ln_f"]["scale"][0]
                    - pparams["ln_f"]["scale"][1]).abs().max())
    assert (spread == 0.0) == (gossip and silos == 2)


def test_ring_consensus_matches_reference():
    from repro.core.consensus import metropolis_weights
    from repro.core.graph import make_graph
    ring = make_graph(5, [(i, (i + 1) % 5) for i in range(5)])
    np.testing.assert_array_equal(psteps.ring_consensus(5),
                                  metropolis_weights(ring).astype(np.float32))
    np.testing.assert_array_equal(psteps.ring_consensus(2),
                                  np.full((2, 2), 0.5, np.float32))
