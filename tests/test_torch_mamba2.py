"""The port's Mamba2 layer (`repro_torch.models.mamba2`) against
`repro.models.mamba2` on reduced mamba2-370m in f32, with the reference's
weights carried across by `params_from_reference` and inputs made with
numpy from a seed.

Tolerance 5e-4 (rtol and atol), as the reference's own kernel-path model
tests use: the chunked scan and the recurrence sum in other orders.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as rconfigs  # noqa: E402
from repro.models import mamba2 as rm2  # noqa: E402

from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import mamba2 as pm2  # noqa: E402
from repro_torch.models.transformer import params_from_reference  # noqa: E402


def F32(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4,
                               err_msg=msg)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.fixture(scope="module")
def layer():
    rcfg = rconfigs.reduce(rconfigs.get_config("mamba2_370m"))
    pcfg = pconfigs.reduce(pconfigs.get_config("mamba2_370m"))
    rp = rm2.mamba_init(jax.random.PRNGKey(0), rcfg, jnp.float32)
    return rcfg, pcfg, rp, params_from_reference(jax.device_get(rp))


def _x(cfg, b, s, seed=1):
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
    return (0.3 * x).astype(np.float32)


@pytest.mark.parametrize("impl,rimpl", [("kernel", "pallas"),
                                        ("reference", "reference"),
                                        ("chunked", "reference")])
def test_forward_matches_reference(layer, impl, rimpl):
    rcfg, pcfg, rp, pp = layer
    x = _x(pcfg, 2, 32)
    want = rm2.mamba_forward(rp, rcfg, jnp.asarray(x), impl=rimpl)
    before = ssd_ops.ssd_scan.launches
    got = pm2.mamba_forward(pp, pcfg, torch.from_numpy(x), impl=impl)
    assert ssd_ops.ssd_scan.launches == before  # CPU
    assert tuple(got.shape) == (2, 32, pcfg.d_model)
    F32(_np(got), _np(want))


def test_reference_path_keeps_the_chunk_limit_kernel_path_pads(layer):
    """s = 40 at chunk 16: the reference path raises, as the reference's
    does (its `s % chunk` assertion); the kernel path pads."""
    rcfg, pcfg, rp, pp = layer
    x = _x(pcfg, 1, 40, seed=2)
    with pytest.raises(AssertionError, match="not divisible"):
        rm2.mamba_forward(rp, rcfg, jnp.asarray(x), impl="reference")
    for impl in ("reference", "chunked"):
        with pytest.raises(ValueError, match="seq 40 not divisible by "
                                             "chunk 16"):
            pm2.mamba_forward(pp, pcfg, torch.from_numpy(x), impl=impl)
    want = rm2.mamba_forward(rp, rcfg, jnp.asarray(x), impl="pallas")
    got = pm2.mamba_forward(pp, pcfg, torch.from_numpy(x), impl="kernel")
    F32(_np(got), _np(want))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(layer, with_state):
    rcfg, pcfg, rp, pp = layer
    rng = np.random.default_rng(3)
    conv_dim = pcfg.ssm_inner + 2 * pcfg.ssm_state
    s = 1 if with_state else 9
    xbc = rng.standard_normal((2, s, conv_dim)).astype(np.float32)
    w = np.concatenate([np.asarray(rp["conv_x"]), np.asarray(rp["conv_bc"])],
                       axis=-1)
    state = (rng.standard_normal((2, pcfg.ssm_conv - 1, conv_dim))
             .astype(np.float32) if with_state else None)
    want, want_st = rm2._causal_conv(
        jnp.asarray(xbc), jnp.asarray(w),
        None if state is None else jnp.asarray(state))
    got, got_st = pm2._causal_conv(
        torch.from_numpy(xbc), torch.from_numpy(w),
        None if state is None else torch.from_numpy(state))
    F32(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got_st), _np(want_st))


def test_decode_matches_forward_and_reference_decode(layer):
    """Token by token: the port's decode against its own forward, and
    against the reference's decode, SSM and conv states included."""
    rcfg, pcfg, rp, pp = layer
    b, s = 2, 12
    x = _x(pcfg, b, s, seed=4)
    full = pm2.mamba_forward(pp, pcfg, torch.from_numpy(x), impl="kernel")
    cache = pm2.init_ssm_cache(pcfg, b, layers=1)
    rcache = rm2.init_ssm_cache(rcfg, b, layers=1)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (tuple(v.shape), torch.float32) for k, v in rcache.items()}
    ssm, conv = cache["ssm"][0], cache["conv"][0]
    rssm, rconv = rcache["ssm"][0], rcache["conv"][0]
    for t in range(s):
        y, ssm_out, conv_out = pm2.mamba_decode(
            pp, pcfg, torch.from_numpy(x[:, t:t + 1]), ssm, conv)
        assert ssm_out is ssm and conv_out is conv  # in place
        ry, rssm, rconv = rm2.mamba_decode(rp, rcfg, jnp.asarray(x[:, t:t + 1]),
                                           rssm, rconv)
        F32(_np(y), _np(ry), f"step {t}")
        F32(_np(y[:, 0]), _np(full[:, t]), f"step {t} vs forward")
        F32(_np(ssm), _np(rssm), f"ssm state, step {t}")
        F32(_np(conv), _np(rconv), f"conv state, step {t}")
    # the stacked cache holds the states written in place
    F32(_np(cache["ssm"][0]), _np(rssm))


def test_bf16_conv_state_is_stored_exactly():
    """In bf16 the reference's conv state comes back in bf16 after a step;
    the port's fp32 buffer holds bf16 values, exactly, and they agree with
    the reference's to the bf16 projections' rounding (2e-2, the
    reference kernel tests' bf16 tolerance)."""
    rcfg = dataclasses.replace(
        rconfigs.reduce(rconfigs.get_config("mamba2_370m")), dtype="bfloat16")
    pcfg = dataclasses.replace(
        pconfigs.reduce(pconfigs.get_config("mamba2_370m")), dtype="bfloat16")
    rp = rm2.mamba_init(jax.random.PRNGKey(1), rcfg, jnp.bfloat16)
    pp = params_from_reference(jax.device_get(rp))
    x = _x(pcfg, 2, 3, seed=5)
    cache = pm2.init_ssm_cache(pcfg, 2, layers=1)
    ssm, conv = cache["ssm"][0], cache["conv"][0]
    rssm = jnp.zeros(tuple(ssm.shape), jnp.float32)
    rconv = jnp.zeros(tuple(conv.shape), jnp.float32)
    for t in range(3):
        xt = x[:, t:t + 1]
        _, ssm, conv = pm2.mamba_decode(
            pp, pcfg, torch.from_numpy(xt).to(torch.bfloat16), ssm, conv)
        _, rssm, rconv = rm2.mamba_decode(
            rp, rcfg, jnp.asarray(xt, jnp.bfloat16), rssm, rconv)
    assert rconv.dtype == jnp.bfloat16 and conv.dtype == torch.float32
    torch.testing.assert_close(conv.to(torch.bfloat16).float(), conv,
                               rtol=0, atol=0)
    np.testing.assert_allclose(_np(conv), _np(rconv), rtol=2e-2, atol=2e-2)


def test_init_distribution_and_layout(layer):
    rcfg, pcfg, rp, _ = layer
    p = pm2.mamba_init(torch.Generator().manual_seed(0), pcfg,
                       torch.float32)
    assert sorted(p) == sorted(rp)
    for name in sorted(p):
        r = np.asarray(rp[name])
        assert tuple(p[name].shape) == r.shape, name
        assert p[name].dtype == torch.float32, name
        if name in ("dt_bias", "A_log", "D"):
            np.testing.assert_allclose(p[name].numpy(), r, rtol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(float(p[name].std()), float(r.std()),
                                       rtol=0.1, err_msg=name)
    pb = pm2.mamba_init(torch.Generator().manual_seed(0), pcfg,
                        torch.bfloat16)
    assert {k for k, v in pb.items() if v.dtype == torch.float32} == {
        "dt_bias", "A_log", "D"}
