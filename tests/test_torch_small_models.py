"""The port's Sent140 LSTM and iNaturalist ResNet against
`repro.models.small`, from the reference's weights carried across with
`params_from_reference`, on the same numpy inputs.

Tolerances: both sides sum the same products in other orders (XLA:CPU's
im2col + matmul and `lax.scan` against `F.conv2d` and a loop with the
input projection taken for all steps at once), so logits and losses
agree within rtol 1e-5 (atol 1e-5 for logits near zero) and flat
gradients within 1e-5 of their largest entry for the LSTM. The ResNet's
gradients pass through 20 batch normalisations of four samples, whose
backward pass loses precision in fp32 on both sides: against a float64
evaluation of the same function the reference's fp32 gradient is off by
4.0e-4 of the largest entry and the port's by 1.5e-4, and the two differ
by 4.0e-4 of it (seed 3, batch 4). The limit is 1e-3 of it.
`_bn` and the strided SAME convolutions are held within 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.fl import flat as rflat  # noqa: E402
from repro.models import small as rsmall  # noqa: E402

from repro_torch.fl import flat as pflat  # noqa: E402
from repro_torch.models import small as psmall  # noqa: E402

B = 4
MODELS = {"sent140_lstm": 5_070_882, "inat_resnet": 11_685_170}


def _inputs(name, rng):
    spec = rsmall.SMALL_MODELS[name]
    if spec.input_dtype == "int32":
        x = rng.integers(0, 15_000, size=(B,) + spec.input_shape,
                         dtype=np.int32)
    else:
        x = rng.normal(size=(B,) + spec.input_shape).astype(np.float32)
    y = rng.integers(0, spec.num_classes, size=B).astype(np.int32)
    return x, y


@pytest.fixture(scope="module", params=sorted(MODELS))
def setup(request):
    name = request.param
    rparams = rsmall.SMALL_MODELS[name].init(jax.random.PRNGKey(3))
    pparams = psmall.params_from_reference(jax.device_get(rparams))
    x, y = _inputs(name, np.random.default_rng(0))
    return name, rparams, pparams, x, y


def test_specs_match_reference():
    for name, r in rsmall.SMALL_MODELS.items():
        p = psmall.SMALL_MODELS[name]
        assert (p.input_shape, p.num_classes, p.input_dtype) == \
            (r.input_shape, r.num_classes, r.input_dtype)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_param_count_and_shapes(name):
    p = psmall.SMALL_MODELS[name].init(torch.Generator().manual_seed(0))
    r = jax.eval_shape(rsmall.SMALL_MODELS[name].init, jax.random.PRNGKey(0))
    assert psmall.param_count(p) == rsmall.param_count(r) == MODELS[name]
    pspec, rspec = pflat.make_flat_spec(p), rflat.make_flat_spec(r)
    assert pspec.shapes == tuple(tuple(s) for s in rspec.shapes)
    assert pspec.size == rspec.size == MODELS[name]


def test_logits_loss_accuracy(setup):
    name, rparams, pparams, x, y = setup
    rspec, pspec = rsmall.SMALL_MODELS[name], psmall.SMALL_MODELS[name]
    rlogits = np.asarray(rspec.apply(rparams, jnp.asarray(x)))
    plogits = pspec.apply(pparams, torch.from_numpy(x)).numpy()
    assert plogits.shape == (B, pspec.num_classes)
    np.testing.assert_allclose(plogits, rlogits, rtol=1e-5, atol=1e-5)
    rb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    pb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    np.testing.assert_allclose(float(pspec.loss(pparams, pb)),
                               float(rspec.loss(rparams, rb)), rtol=1e-5)
    assert float(pspec.accuracy(pparams, pb)) == \
        float(rspec.accuracy(rparams, rb))


GRAD_TOL = {"sent140_lstm": 1e-5, "inat_resnet": 1e-3}


def test_flat_gradient(setup):
    name, rparams, pparams, x, y = setup
    rspec_m, pspec_m = rsmall.SMALL_MODELS[name], psmall.SMALL_MODELS[name]
    rspec = rflat.make_flat_spec(rparams)
    rrow = rflat.ravel(rspec, rparams)
    rb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    rgrad = np.asarray(jax.grad(
        lambda v: rspec_m.loss(rflat.unravel(rspec, v), rb))(rrow))

    pspec = pflat.make_flat_spec(pparams)
    prow = pflat.ravel(pspec, pparams)
    np.testing.assert_array_equal(prow.numpy(), np.asarray(rrow))
    pb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    pgrad = torch.func.grad(
        lambda v: pspec_m.loss(pflat.unravel(pspec, v), pb))(prow).numpy()
    assert pgrad.shape == rgrad.shape == (MODELS[name],)
    scale = np.abs(rgrad).max()
    np.testing.assert_allclose(pgrad, rgrad, rtol=0,
                               atol=GRAD_TOL[name] * scale)


def test_resnet_flat_packing_bit_equal():
    """The nested `s{i}b{j}` tree packs into the reference's row order."""
    rparams = jax.device_get(
        rsmall.INAT_RESNET.init(jax.random.PRNGKey(5)))
    pparams = psmall.params_from_reference(rparams)
    assert isinstance(pparams["s1b0"]["bn1"]["scale"], torch.Tensor)
    rspec = rflat.make_flat_spec(rparams)
    pspec = pflat.make_flat_spec(pparams)
    assert pspec.offsets == tuple(rspec.offsets)
    np.testing.assert_array_equal(pflat.ravel(pspec, pparams).numpy(),
                                  np.asarray(rflat.ravel(rspec, rparams)))
    back = pflat.unravel(pspec, pflat.ravel(pspec, pparams))
    np.testing.assert_array_equal(back["s3b0"]["proj"].numpy(),
                                  rparams["s3b0"]["proj"])


def test_bn_population_variance():
    """`_bn` normalises over N, H, W with ddof 0, in the reference's
    order, and keeps no running statistics."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 6, 4)) * 3 + 1).astype(np.float32)  # NHWC
    p = {"scale": rng.normal(size=4).astype(np.float32),
         "bias": rng.normal(size=4).astype(np.float32)}
    want = np.asarray(rsmall._bn({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x)))
    got = psmall._bn(psmall.params_from_reference(p),
                     torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    # a batch of two: the unbiased estimate would be twice as large
    x2 = np.asarray([[[[1.0]]], [[[3.0]]]], np.float32)
    one = {"scale": torch.ones(1), "bias": torch.zeros(1)}
    out = psmall._bn(one, torch.from_numpy(x2).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.flatten().numpy(),
                               [-1 / np.sqrt(1 + 1e-5), 1 / np.sqrt(1 + 1e-5)],
                               rtol=1e-6)


@pytest.mark.parametrize("k,stride,h", [(3, 2, 32), (3, 2, 7), (1, 2, 16),
                                        (1, 2, 9), (3, 1, 5), (5, 2, 6)])
def test_strided_same_conv(k, stride, h):
    rng = np.random.default_rng(k * 100 + h)
    x = rng.normal(size=(2, h, h + 1, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = np.asarray(rsmall._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = psmall._conv_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                            torch.from_numpy(w), stride)
    assert want.shape == (2, -(-h // stride), -(-(h + 1) // stride), 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_lstm_takes_int32_tokens():
    p = psmall.SENT140_LSTM.init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, 15_000, (3, 32), dtype=torch.int32)
    np.testing.assert_array_equal(psmall.SENT140_LSTM.apply(p, tok).numpy(),
                                  psmall.SENT140_LSTM.apply(p, tok.long())
                                  .numpy())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_distribution(name):
    """Initial weights follow the reference's distributions (not its
    bits: torch cannot draw jax.random's stream)."""
    pp = psmall.SMALL_MODELS[name].init(torch.Generator().manual_seed(0))
    rp = jax.device_get(rsmall.SMALL_MODELS[name].init(
        jax.random.PRNGKey(0)))
    pleaves = pflat._leaves(pp)
    rleaves = pflat._leaves(psmall.params_from_reference(rp))
    for (pn, pv), (rn, rv) in zip(pleaves, rleaves):
        assert pn == rn and pv.shape == rv.shape
        if rv.numel() > 1000 and float(rv.std()) > 0:
            np.testing.assert_allclose(float(pv.std()), float(rv.std()),
                                       rtol=0.1, err_msg=pn)
        else:
            np.testing.assert_allclose(float(pv.mean()), float(rv.mean()),
                                       atol=0.25, err_msg=pn)



def _tied_femnist_input():
    """Four FEMNIST images with a flat 20 x 20 patch at 0.5: inside it
    both pools see windows of exactly equal, non-zero maxima."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 28, 28, 1)).astype(np.float32)
    x[:, 4:24, 4:24, :] = 0.5
    return x


def _pool_grads(h_nhwc, cot_nhwc):
    """The gradient of <pool(h), cot> through each package's pool."""
    want = jax.grad(lambda v: jnp.sum(rsmall._maxpool2(v) * cot_nhwc))(
        jnp.asarray(h_nhwc))
    h = torch.from_numpy(h_nhwc).permute(0, 3, 1, 2).requires_grad_()
    (psmall._maxpool2(h) * torch.from_numpy(cot_nhwc).permute(0, 3, 1, 2)
     ).sum().backward()
    return h.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want)


def test_femnist_pool_ties_split_like_reference():
    """The FEMNIST CNN's 2 x 2 max pool splits a window's gradient evenly
    among equal maxima, as `repro.models.small._maxpool2` does under
    `jax.grad` (`F.max_pool2d` sends it all to the first maximum).

    Held on one window (3, 3, 0, 1), exactly; on the first conv's tied
    activations of inputs with a flat patch, within 1e-7 of the largest
    entry; and through `femnist_cnn_apply` on those inputs: the gradients
    with respect to the input and to c1, c2 and fc1 within 5e-6 of their
    largest entry. The last limit is fp32 rounding of two convolution
    orders (im2col + matmul against `F.conv2d`): 1.4e-6 at most here,
    while a first-maximum pool puts the input gradient 0.58 off."""
    win = np.asarray([[3.0, 3.0], [0.0, 1.0]], np.float32)[None, :, :, None]
    got, want = _pool_grads(win, np.ones((1, 1, 1, 1), np.float32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :, :, 0], [[0.5, 0.5], [0.0, 0.0]])

    rparams = jax.device_get(rsmall.FEMNIST_CNN.init(jax.random.PRNGKey(3)))
    xin = _tied_femnist_input()
    rng = np.random.default_rng(12)
    h1 = np.array(jax.nn.relu(rsmall._conv(jnp.asarray(xin),
                                             rparams["c1"])))
    cot1 = rng.normal(size=(4, 14, 14, 32)).astype(np.float32)
    got, want = _pool_grads(h1, cot1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-7 * np.abs(want).max())

    cot = rng.normal(size=(4, 62)).astype(np.float32)
    rgp, rgx = jax.grad(
        lambda p, v: jnp.sum(rsmall.femnist_cnn_apply(p, v) * cot),
        argnums=(0, 1))({k: jnp.asarray(v) for k, v in rparams.items()},
                        jnp.asarray(xin))
    pparams = {k: v.requires_grad_()
               for k, v in psmall.params_from_reference(rparams).items()}
    px = torch.from_numpy(xin).requires_grad_()
    (psmall.femnist_cnn_apply(pparams, px)
     * torch.from_numpy(cot)).sum().backward()
    for name, got, want in [("x", px.grad, rgx)] + [
            (k, pparams[k].grad, rgp[k]) for k in ("c1", "c2", "fc1")]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=5e-6 * np.abs(want).max(),
                                   err_msg=name)
