"""The port's flat packing and `flat_sgd` against the reference.

Layout is compared exactly, for the FEMNIST CNN's flat dict and for a
reduced mamba2 param tree (nested dicts, bf16 and fp32 leaves). `flat_sgd` is elementwise and each product
is rounded before the add in both packages (torch runs every op as its
own kernel), so its updates are compared with `np.array_equal`; the
momentum case checks the same against the reference's pinned path.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import dataclasses  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.fl import flat as rflat  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.models.small import FEMNIST_CNN as RCNN  # noqa: E402
from repro.optim import flat_sgd as rflat_sgd  # noqa: E402

from repro_torch.fl import flat as pflat  # noqa: E402
from repro_torch.models.small import FEMNIST_CNN as PCNN  # noqa: E402
from repro_torch.models.small import params_from_reference  # noqa: E402
from repro_torch.models.transformer import \
    params_from_reference as tree_from_reference  # noqa: E402
from repro_torch.optim import flat_sgd as pflat_sgd  # noqa: E402


def _ref_params():
    return jax.device_get(RCNN.init(jax.random.PRNGKey(0)))


def test_flat_spec_matches_reference():
    rspec = rflat.make_flat_spec(RCNN.init(jax.random.PRNGKey(0)))
    pspec = pflat.make_flat_spec(PCNN.init(torch.Generator().manual_seed(0)))
    assert pspec.names == ("b1", "b2", "c1", "c2", "fc1", "fc2")
    assert pspec.shapes == rspec.shapes
    assert pspec.offsets == rspec.offsets
    assert pspec.size == rspec.size == 1_280_478


def test_carried_row_equals_reference_row():
    p = _ref_params()
    rrow = np.asarray(rflat.ravel(rflat.make_flat_spec(p), p))
    params = params_from_reference({k: np.asarray(v) for k, v in p.items()})
    prow = pflat.ravel(pflat.make_flat_spec(params), params)
    np.testing.assert_array_equal(prow.numpy(), rrow)


def test_ravel_unravel_round_trip_and_views():
    params = PCNN.init(torch.Generator().manual_seed(1))
    spec = pflat.make_flat_spec(params)
    flat = pflat.ravel(spec, params)
    back = pflat.unravel(spec, flat)
    for k in spec.names:
        assert torch.equal(back[k], params[k])
        assert back[k]._base is flat  # a view, no copy
    back["c1"][0, 0, 0, 0] = 123.0
    assert flat[spec.offsets[spec.names.index("c1")]] == 123.0

    stacked = {k: torch.stack([v, 2 * v, -v]) for k, v in params.items()}
    mat = pflat.ravel_stacked(spec, stacked)
    assert mat.shape == (3, spec.size)
    torch.testing.assert_close(mat[1], 2 * pflat.ravel(spec, params),
                               rtol=0, atol=0)
    unst = pflat.unravel_stacked(spec, mat)
    for k in spec.names:
        assert torch.equal(unst[k], stacked[k])
        assert unst[k]._base is mat


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_flat_sgd_matches_reference(momentum):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(5, 301)).astype(np.float32)
    grads = [rng.normal(size=w.shape).astype(np.float32) for _ in range(3)]
    ropt = rflat_sgd(0.05, momentum=momentum, weight_decay=1e-4)
    popt = pflat_sgd(0.05, momentum=momentum, weight_decay=1e-4)
    rw, rs = jnp.asarray(w), ropt.init(jnp.asarray(w))
    pw, ps = torch.from_numpy(w.copy()), popt.init(torch.from_numpy(w))
    for g in grads:
        rw, rs = ropt.update(rw, jnp.asarray(g), rs, 0.5)
        pw, ps = popt.update(pw, torch.from_numpy(g), ps, 0.5)
        # bit-equal: every product is rounded before its add on both sides
        np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
    assert ps["step"] == int(rs["step"]) == 3


def _mamba_tree(dtype="bfloat16", seed=0):
    cfg = dataclasses.replace(
        rconfigs.reduce(rconfigs.get_config("mamba2_370m")), d_model=64,
        vocab_size=128, dtype=dtype)
    return jax.device_get(rtf.init_params(cfg, jax.random.PRNGKey(seed)))


def test_nested_spec_order_and_types_match_reference():
    ref = _mamba_tree()
    rspec = rflat.make_flat_spec(ref)
    pspec = pflat.make_flat_spec(tree_from_reference(ref))
    paths = ["/".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert list(pspec.names) == paths          # jax.tree.flatten's order
    assert pspec.shapes == rspec.shapes
    assert pspec.offsets == rspec.offsets
    assert pspec.size == rspec.size
    assert [str(d).split(".")[-1] for d in pspec.dtypes] == \
        [np.dtype(d).name for d in rspec.dtypes]
    assert {"bfloat16", "float32"} <= {str(d).split(".")[-1]
                                       for d in pspec.dtypes}
    assert pspec.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_nested_ravel_bit_equal_to_reference(dtype):
    ref = _mamba_tree(dtype)
    rspec = rflat.make_flat_spec(ref)
    params = tree_from_reference(ref)
    pspec = pflat.make_flat_spec(params)
    rrow = np.asarray(rflat.ravel(rspec, ref))
    prow = pflat.ravel(pspec, params)
    np.testing.assert_array_equal(prow.numpy(), rrow)
    out = torch.full((pspec.size,), float("nan"))
    assert pflat.ravel(pspec, params, out=out) is out
    np.testing.assert_array_equal(out.numpy(), rrow)

    back = pflat.unravel(pspec, prow)
    rback = jax.device_get(rflat.unravel(rspec, jnp.asarray(rrow)))
    for (path, leaf), r, orig in zip(pflat._leaves(back),
                                     jax.tree.leaves(rback),
                                     jax.tree.leaves(params)):
        assert leaf.dtype == orig.dtype, path   # leaf types restored
        assert torch.equal(leaf, orig), path
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(r, np.float32))
        if leaf.dtype == torch.float32:          # a view of the row
            assert leaf._base is prow
    with pytest.raises(ValueError):
        pflat.ravel(pspec, {"embed": params["embed"]})


def test_nested_stacked_round_trip():
    reps = [_mamba_tree(seed=s) for s in range(3)]
    stacked = jax.tree.map(lambda *x: np.stack(x), *reps)
    rspec = rflat.make_flat_spec(reps[0])
    params = tree_from_reference(stacked)
    pspec = pflat.make_flat_spec(tree_from_reference(reps[0]))
    mat = pflat.ravel_stacked(pspec, params)
    np.testing.assert_array_equal(
        mat.numpy(), np.asarray(rflat.ravel_stacked(rspec, stacked)))
    back = pflat.unravel_stacked(pspec, mat)
    for (_, leaf), orig in zip(pflat._leaves(back),
                               jax.tree.leaves(params)):
        assert leaf.dtype == orig.dtype and torch.equal(leaf, orig)
