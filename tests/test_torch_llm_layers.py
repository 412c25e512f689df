"""The port's layer primitives (`repro_torch.models.layers`) against
`repro.models.layers` on the same numpy-seeded f32 inputs, within 1e-6
relative (both sides compute in fp32; sums may run in another order)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.models import layers as rl  # noqa: E402

from repro_torch.models import layers as pl  # noqa: E402

RTOL = dict(rtol=1e-6, atol=1e-6)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """numpy dict -> (jax dict, torch dict)."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 64, scale=3.0)
    jp, tp = _both({"scale": _rand(rng, 64) + 1.0})
    want = np.asarray(rl.rmsnorm(jp, jnp.asarray(x), 1e-6))
    got = pl.rmsnorm(tp, torch.from_numpy(x), 1e-6).numpy()
    np.testing.assert_allclose(got, want, **RTOL)


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_rope_freqs(theta):
    np.testing.assert_allclose(pl.rope_freqs(128, theta).numpy(),
                               np.asarray(rl.rope_freqs(128, theta)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["sequence", "per_slot"])
def test_apply_rope(kind):
    rng = np.random.default_rng(1)
    if kind == "sequence":   # prefill: positions (1, S), shared by batch
        x = _rand(rng, 2, 12, 4, 32)
        pos = np.arange(12)[None, :]
    else:                    # decode: per-slot positions (B, 1)
        x = _rand(rng, 3, 1, 4, 32)
        pos = np.array([[0], [7], [1234]])
    want = np.asarray(rl.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    10_000.0))
    got = pl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        10_000.0).numpy()
    # angles reach 1234 rad: cos/sin of the same fp32 angle agree to a
    # few ulps of the result
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 3, 32)
    jp, tp = _both({"w_gate": _rand(rng, 32, 48, scale=0.2),
                    "w_up": _rand(rng, 32, 48, scale=0.2),
                    "w_down": _rand(rng, 48, 32, scale=0.2)})
    want = np.asarray(rl.mlp(jp, jnp.asarray(x), act))
    got = pl.mlp(tp, torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(got, want, **RTOL)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_unembed(tie):
    rng = np.random.default_rng(3)
    tree = {"tok": _rand(rng, 50, 16)}
    if not tie:
        tree["unembed"] = _rand(rng, 16, 50)
    jp, tp = _both(tree)
    tokens = rng.integers(0, 50, (2, 7))
    emb = pl.embed(tp, torch.from_numpy(tokens))
    np.testing.assert_array_equal(
        emb.numpy(), np.asarray(rl.embed(jp, jnp.asarray(tokens))))
    x = _rand(rng, 2, 7, 16)
    np.testing.assert_allclose(
        pl.unembed(tp, torch.from_numpy(x)).numpy(),
        np.asarray(rl.unembed(jp, jnp.asarray(x))), **RTOL)


def test_cross_entropy():
    rng = np.random.default_rng(4)
    logits = _rand(rng, 3, 5, 11, scale=2.0)
    labels = rng.integers(0, 11, (3, 5))
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = float(rl.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        got = float(pl.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, **RTOL)


def test_dense_init_distribution():
    gen = torch.Generator().manual_seed(0)
    w = pl._dense_init(gen, (256, 64), dtype=torch.bfloat16)
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (256, 64)
    np.testing.assert_allclose(float(w.float().std()), 1 / 16, rtol=0.05)
    e = pl.embed_init(gen, 300, 64, torch.float32, tie=False)
    np.testing.assert_allclose(float(e["tok"].std()), 0.02, rtol=0.05)
    assert tuple(e["unembed"].shape) == (64, 300)
