"""The port's FEMNIST CNN against `repro.models.small.FEMNIST_CNN`, from
the reference's weights carried across with `params_from_reference`.

Tolerances: the reference convolves by im2col + matmul on XLA:CPU, the
port with `F.conv2d`; the two sum the same products in different orders,
so logits and losses agree to a few fp32 ulps (rtol 1e-5) and gradients
to atol 1e-5 relative to their largest entry.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.fl import flat as rflat  # noqa: E402
from repro.models.small import FEMNIST_CNN as RCNN  # noqa: E402

from repro_torch.fl import flat as pflat  # noqa: E402
from repro_torch.models.small import FEMNIST_CNN as PCNN  # noqa: E402
from repro_torch.models.small import params_from_reference  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    rparams = RCNN.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 62, size=6).astype(np.int32)
    pparams = params_from_reference(
        {k: np.asarray(v) for k, v in jax.device_get(rparams).items()})
    return rparams, pparams, x, y


def test_logits_loss_accuracy(setup):
    rparams, pparams, x, y = setup
    rlogits = np.asarray(RCNN.apply(rparams, jnp.asarray(x)))
    plogits = PCNN.apply(pparams, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(plogits, rlogits, rtol=1e-5, atol=1e-5)
    rb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    pb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    np.testing.assert_allclose(float(PCNN.loss(pparams, pb)),
                               float(RCNN.loss(rparams, rb)), rtol=1e-5)
    assert float(PCNN.accuracy(pparams, pb)) == \
        float(RCNN.accuracy(rparams, rb))


def test_flat_gradient(setup):
    rparams, pparams, x, y = setup
    rspec = rflat.make_flat_spec(rparams)
    rrow = rflat.ravel(rspec, rparams)
    rb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    rgrad = np.asarray(jax.grad(
        lambda v: RCNN.loss(rflat.unravel(rspec, v), rb))(rrow))

    pspec = pflat.make_flat_spec(pparams)
    prow = pflat.ravel(pspec, pparams)
    pb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    pgrad = torch.func.grad(
        lambda v: PCNN.loss(pflat.unravel(pspec, v), pb))(prow).numpy()
    assert pgrad.shape == rgrad.shape == (1_280_478,)
    scale = np.abs(rgrad).max()
    np.testing.assert_allclose(pgrad, rgrad, rtol=0, atol=1e-5 * scale)


def test_init_distribution():
    """Initial weights follow the reference's distributions (not its
    bits: torch cannot draw jax.random's stream)."""
    p = PCNN.init(torch.Generator().manual_seed(0))
    r = jax.device_get(RCNN.init(jax.random.PRNGKey(0)))
    for k in ("c1", "c2", "fc1", "fc2"):
        assert tuple(p[k].shape) == r[k].shape
        np.testing.assert_allclose(float(p[k].std()), float(r[k].std()),
                                   rtol=0.1)
    for k in ("b1", "b2"):
        assert not p[k].any()
