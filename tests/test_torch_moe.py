"""The port's MoE layer (`repro_torch.models.moe`) against
`repro.models.moe` on reduced granite-moe (4 experts, top-2) and
phi3.5-moe, with the reference's weights carried across by
`params_from_reference`.

fp32 within 5e-4 (rtol and atol), as the reference's own model tests.
Routing indices must be equal: the router's logits are random fp32, so
no two probabilities of a token tie and `torch.topk` and `lax.top_k`
pick the same experts in the same order.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as rconfigs  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402

from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models.transformer import params_from_reference  # noqa: E402
from _torch_fl_parity import one_thread  # noqa: E402,F401

ARCHS = ["granite_moe_1b", "phi3p5_moe"]


def F32(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4, err_msg=msg)


def _setup(arch, seed=0, **kw):
    r = dataclasses.replace(rconfigs.reduce(rconfigs.get_config(arch)), **kw)
    p = dataclasses.replace(pconfigs.reduce(pconfigs.get_config(arch)), **kw)
    rp = rmoe.moe_init(jax.random.PRNGKey(seed), r, jnp.float32)
    return r, p, rp, params_from_reference(jax.device_get(rp))


def _rmoe(rcfg, **kw):
    """The reference's `moe`, compiled once per config and options."""
    return jax.jit(lambda p, x: rmoe.moe(p, rcfg, x, **kw))


def _x(cfg, shape, seed=1):
    return np.random.default_rng(seed).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_and_types(arch):
    rcfg, pcfg, rp, _ = _setup(arch)
    got = pmoe.moe_init(torch.Generator().manual_seed(0), pcfg, torch.float32,
                        device="cpu")
    assert sorted(got) == sorted(rp)
    for k in got:
        assert tuple(got[k].shape) == rp[k].shape, k
        assert got[k].dtype == torch.float32
    # the reference's scales: router 0.02, experts 1/sqrt(E)
    assert abs(float(got["router"].std()) - 0.02) < 4e-3
    assert abs(float(got["w_up"].std()) - pcfg.num_experts ** -0.5) < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(37,), (3, 21), (5, 1)],
                         ids=["tokens", "rows", "decode"])
def test_route_matches_reference(arch, shape):
    """Indices equal; gates and aux within tolerance, per row where the
    input has rows (the gather path's routing; (B, 1) is a decode
    step)."""
    rcfg, pcfg, rp, pp = _setup(arch)
    x = _x(pcfg, shape)
    rows = x if x.ndim == 3 else x[None]
    got_g, got_i, got_a = pmoe._route(pp, pcfg, torch.from_numpy(x))
    got_g, got_i = got_g.reshape(rows.shape[:2] + (-1,)), got_i.reshape(
        rows.shape[:2] + (-1,))
    for b in range(rows.shape[0]):
        g, i, a = rmoe._route(rp, rcfg, jnp.asarray(rows[b]))
        np.testing.assert_array_equal(got_i[b].numpy(), np.asarray(i))
        F32(got_g[b].numpy(), np.asarray(g))
        F32(float(got_a.reshape(-1)[b]), float(a))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_moe_matches_reference(arch, impl):
    rcfg, pcfg, rp, pp = _setup(arch)
    x = _x(pcfg, (3, 24))
    want, want_aux = _rmoe(rcfg, impl=impl)(rp, jnp.asarray(x))
    got, got_aux = pmoe.moe(pp, pcfg, torch.from_numpy(x), impl=impl)
    assert tuple(got.shape) == x.shape and got_aux.dim() == 0
    F32(got.numpy(), np.asarray(want))
    F32(float(got_aux), float(want_aux))


@pytest.mark.parametrize("arch", ARCHS)
def test_gather_equals_dense_when_nothing_drops(arch):
    """With a capacity of every slot (cf = E / k) no token drops, and the
    grouped dispatch computes the dense oracle's function."""
    _, pcfg, _, pp = _setup(arch)
    x = torch.from_numpy(_x(pcfg, (2, 16)))
    cf = pcfg.num_experts / pcfg.experts_per_token
    got, _ = pmoe.moe(pp, pcfg, x, capacity_factor=cf)
    # dense routes over all rows at once: compare row by row
    for b in range(2):
        want, _ = pmoe.moe(pp, pcfg, x[b:b + 1], impl="dense")
        F32(got[b:b + 1].numpy(), want.numpy())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [0.3, 0.6])
def test_dropping_matches_reference(arch, cf):
    """A capacity small enough to drop: the same tokens drop (their
    dropped choices contribute zero), at cap = int(cf * T * k / E) + 1."""
    rcfg, pcfg, rp, pp = _setup(arch)
    x = _x(pcfg, (3, 32), seed=5)
    cap = int(cf * 32 * pcfg.experts_per_token / pcfg.num_experts) + 1
    _, idx, _ = pmoe._route(pp, pcfg, torch.from_numpy(x))
    counts = torch.stack([torch.bincount(r.reshape(-1),
                                         minlength=pcfg.num_experts)
                          for r in idx])
    assert int(counts.max()) > cap   # something drops
    want, _ = _rmoe(rcfg, capacity_factor=cf)(rp, jnp.asarray(x))
    got, _ = pmoe.moe(pp, pcfg, torch.from_numpy(x), capacity_factor=cf)
    F32(got.numpy(), np.asarray(want))
    full, _ = pmoe.moe(pp, pcfg, torch.from_numpy(x),
                       capacity_factor=pcfg.num_experts)
    assert not torch.allclose(got, full)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_shape(arch):
    """(B, 1, D), a decode step: capacity 1 a row, nothing drops, the
    reference's output."""
    rcfg, pcfg, rp, pp = _setup(arch)
    x = _x(pcfg, (6, 1))
    want, _ = _rmoe(rcfg)(rp, jnp.asarray(x))
    got, _ = pmoe.moe(pp, pcfg, torch.from_numpy(x))
    F32(got.numpy(), np.asarray(want))


def test_gradients_match_reference():
    """d(sum(out * probe) + aux)/d(params, x) against `jax.grad`."""
    rcfg, pcfg, rp, pp = _setup("granite_moe_1b")
    x = _x(pcfg, (2, 12))
    probe = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def rloss(p, xx):
        out, aux = rmoe.moe(p, rcfg, xx)
        return jnp.sum(out * probe) + aux

    rg_p, rg_x = jax.jit(jax.grad(rloss, argnums=(0, 1)))(rp, jnp.asarray(x))
    p = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = pmoe.moe(p, pcfg, xt)
    (torch.sum(out * torch.from_numpy(probe)) + aux).backward()
    for k in p:
        F32(p[k].grad.numpy(), np.asarray(rg_p[k]), k)
    F32(xt.grad.numpy(), np.asarray(rg_x))


def test_unknown_impl_raises():
    _, pcfg, _, pp = _setup("granite_moe_1b")
    with pytest.raises(ValueError, match="unknown moe impl"):
        pmoe.moe(pp, pcfg, torch.zeros(1, 2, pcfg.d_model), impl="pallas")
