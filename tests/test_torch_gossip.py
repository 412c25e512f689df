"""The port's ring gossip round (`repro_torch.fl.gossip` on
`launch.mesh.StackedSilos`) against `repro.fl.gossip` under
`jax.vmap(axis_name="silo")`, the reference's own single-program binding
of its silo axis.

Inputs are made with numpy from a seed and fed to both packages: a flat
dict of fp32 arrays, and n replicas of a reduced mamba2 param tree (bf16
matrices, fp32 norms and SSM constants) from the reference's
`init_params`, carried across by `params_from_reference`.

Tolerances:
* use_kernel=False: bit-equal. Both packages multiply, then add, in the
  order self, left, right in fp32 and cast; XLA:CPU does not contract
  this vmapped elementwise sum.
* use_kernel=True: the reference runs its Pallas `gossip_combine` in
  interpret mode, where XLA:CPU contracts `jnp.sum(w * a, 0)` into the
  FMA chain fma(a2, w2, fma(a1, w1, a0*w0)) (`_combine_order` shows the
  reference equal to that chain, bit for bit); the port's kernel rounds
  every product. On these inputs a third of the fp32 elements and under
  1 % of the bf16 ones differ, by up to 2.4e-7 (fp32) and one bf16 ulp.
  Bound: |port - ref| <= eps * sum_k |a_k w_k| with eps 2^-22 (fp32
  accumulation) or 2^-7 (one bf16 ulp of the output). The port's kernel
  path is bit-equal to its use_kernel=False path.
* Buffers: bit-equal to `np.roll` of the params (fresh) or to the stale
  buffers (inactive direction).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as rconfigs  # noqa: E402
from repro.fl import gossip as rgossip  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402

from repro_torch.fl import gossip as pgossip  # noqa: E402
from repro_torch.kernels.gossip_combine import ops  # noqa: E402
from repro_torch.launch.fl8 import STATES, build_step  # noqa: E402
from repro_torch.launch.mesh import StackedSilos, tree_bytes  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402

SIZES = [2, 3, 5, 8]
EPS = {np.dtype(np.float32): 2.0 ** -22, "bfloat16": 2.0 ** -7}


def _mamba_replica(seed):
    cfg = dataclasses.replace(
        rconfigs.reduce(rconfigs.get_config("mamba2_370m")), d_model=64,
        vocab_size=128, dtype="bfloat16")
    return jax.device_get(rtf.init_params(cfg, jax.random.PRNGKey(seed)))


def _flat_replica(seed):
    rng = np.random.default_rng(seed)
    return {"b": rng.normal(size=(7,)).astype(np.float32),
            "a": rng.normal(size=(3, 33)).astype(np.float32),
            "w": rng.normal(size=(129,)).astype(np.float32)}


TREES = {"flat": _flat_replica, "mamba2": _mamba_replica}


def _stacked(tree, n, base):
    """n replicas, seeds base..base+n-1, stacked on a leading axis."""
    reps = [TREES[tree](base + s) for s in range(n)]
    return jax.tree.map(lambda *x: np.stack(x), *reps)


def _inputs(tree, n):
    p = _stacked(tree, n, 0)
    bufs = {"left": _stacked(tree, n, 100), "right": _stacked(tree, n, 200)}
    return p, bufs


def _torch(tree):
    return ptf.params_from_reference(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree.float().numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree, np.float32)]


def _ref_round(p, bufs, n, left, right, use_kernel):
    cs, cl, cr = rgossip.ring_coefficients(n)

    def f(pp, bb):
        return rgossip.gossip_ring_ppermute(
            pp, bb, coeff_self=cs, coeff_left=cl, coeff_right=cr,
            axis="silo", active_left=left, active_right=right,
            use_kernel=use_kernel)

    return jax.device_get(jax.vmap(f, axis_name="silo")(p, bufs))


def _port_round(p, bufs, n, left, right, use_kernel):
    axis = StackedSilos(n)
    step = build_step(None, left, right, axis, use_kernel=use_kernel)
    new, nb = step(_torch(p), {k: _torch(v) for k, v in bufs.items()})
    return new, nb, axis.bytes_moved


def _bound(p, bufs, got_dtype_tree, n, left, right):
    """eps * sum_k |a_k w_k| per element, for the leaves in order."""
    cs, cl, cr = (c.numpy().astype(np.float64)
                  for c in pgossip.ring_coefficients(n))
    recv_l = (jax.tree.map(lambda x: np.roll(x, 1, 0), p) if right
              else bufs["left"])
    recv_r = (jax.tree.map(lambda x: np.roll(x, -1, 0), p) if left
              else bufs["right"])
    out = []
    for w, l, r, like in zip(_leaves(p), _leaves(recv_l), _leaves(recv_r),
                             jax.tree.leaves(got_dtype_tree)):
        shape = (n,) + (1,) * (w.ndim - 1)
        mag = (np.abs(cs.reshape(shape) * w) + np.abs(cl.reshape(shape) * l)
               + np.abs(cr.reshape(shape) * r))
        key = "bfloat16" if np.dtype(like.dtype).name == "bfloat16" \
            else np.dtype(np.float32)
        out.append(EPS[key] * mag)
    return out


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("state", STATES, ids=[s[0] for s in STATES])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("tree", list(TREES))
def test_ring_round_matches_reference(tree, n, state, use_kernel):
    name, left, right = state
    p, bufs = _inputs(tree, n)
    ref_new, ref_bufs = _ref_round(p, bufs, n, left, right, use_kernel)
    before = ops.gossip_combine.launches
    new, nb, moved = _port_round(p, bufs, n, left, right, use_kernel)
    assert ops.gossip_combine.launches == before  # CPU: plain version

    # buffers: the rolls where fresh, the stale ones where not
    want_l = (jax.tree.map(lambda x: np.roll(x, 1, 0), p) if right
              else bufs["left"])
    want_r = (jax.tree.map(lambda x: np.roll(x, -1, 0), p) if left
              else bufs["right"])
    for got, want, ref in ((nb["left"], want_l, ref_bufs["left"]),
                           (nb["right"], want_r, ref_bufs["right"])):
        for g, w, r in zip(_leaves(got), _leaves(want), _leaves(ref)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, r)

    # bytes across the silo axis
    rep = tree_bytes(_torch(p)) // n
    assert moved == {"overlay": 2, "half": 1, "isolated": 0}[name] * n * rep

    got, want = _leaves(new), _leaves(ref_new)
    assert [g.shape for g in got] == [w.shape for w in want]
    for leaf_new, leaf_ref in zip(jax.tree.leaves(new),
                                  jax.tree.leaves(ref_new)):
        assert str(leaf_new.dtype).split(".")[-1] == \
            np.dtype(leaf_ref.dtype).name
    if not use_kernel:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        for g, w, b in zip(got, want, _bound(p, bufs, ref_new, n, left,
                                             right)):
            assert (np.abs(g - w) <= b).all(), float(np.abs(g - w).max())
        plain, _, _ = _port_round(p, bufs, n, left, right, False)
        for g, w in zip(got, _leaves(plain)):
            np.testing.assert_array_equal(g, w)


def test_combine_order():
    """The reference's kernel-path sum is XLA:CPU's FMA chain (or, on an
    XLA that does not contract, the port's rounded chain); the port's is
    the rounded chain."""
    p, bufs = _inputs("flat", 5)
    ref_new, _ = _ref_round(p, bufs, 5, True, True, True)
    new, _, _ = _port_round(p, bufs, 5, True, True, True)
    a = np.float32(1.0 / 3.0)
    for key in ("a", "b", "w"):
        w = [p[key], np.roll(p[key], 1, 0), np.roll(p[key], -1, 0)]
        rounded = (a * w[0] + a * w[1]) + a * w[2]
        fma = np.float32(a * w[0])
        for k in (1, 2):
            fma = (np.float64(a) * w[k].astype(np.float64)
                   + fma.astype(np.float64)).astype(np.float32)
        np.testing.assert_array_equal(new[key].numpy(), rounded)
        r = np.asarray(ref_new[key])
        assert np.array_equal(r, fma) or np.array_equal(r, rounded)


def test_stacked_ppermute_matches_jax_ppermute():
    """A full permutation against `jax.lax.ppermute` under vmap; a partial
    one (which vmap's ppermute refuses) against its semantics: silos that
    receive nothing get zeros."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    full = [(0, 2), (1, 0), (2, 4), (3, 1), (4, 3)]
    ref = jax.vmap(lambda v: jax.lax.ppermute(v, "silo", full),
                   axis_name="silo")(jnp.asarray(x))
    axis = StackedSilos(5)
    got = axis.ppermute({"x": torch.from_numpy(x)}, full)["x"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert axis.bytes_moved == 5 * 4 * 4

    axis.bytes_moved = 0
    got = axis.ppermute({"x": torch.from_numpy(x)}, [(0, 2), (3, 1), (4, 4)])
    want = np.zeros_like(x)
    want[2], want[1], want[4] = x[0], x[3], x[4]
    np.testing.assert_array_equal(got["x"].numpy(), want)
    assert axis.bytes_moved == 2 * 4 * 4   # (4, 4) stays on its silo
    with pytest.raises(ValueError):
        axis.ppermute({"x": torch.from_numpy(x)}, [(0, 1), (2, 1)])


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("n", [2, 5, 8])
def test_gossip_dense_matches_reference(tree, n):
    """All-gather consensus with the ring's Metropolis matrix. Both
    packages contract over the n silos with a matrix product, each in its
    own order, so each element is held within eps * sum_j |A_ij w_j|:
    eps 2^-20 for fp32 leaves (n <= 8 roundings), one bf16 ulp (2^-7)
    for bf16 leaves (near-cancelling sums make a relative bound of the
    result meaningless). The same bound holds between it and the port's
    ring round in the overlay state."""
    p, bufs = _inputs(tree, n)
    a = pgossip.ring_matrix(n)
    ref = jax.device_get(jax.vmap(
        lambda w: rgossip.gossip_dense(w, jnp.asarray(a.numpy()), "silo"),
        axis_name="silo")(p))
    axis = StackedSilos(n)
    got = pgossip.gossip_dense(_torch(p), a, axis)
    assert axis.bytes_moved == (n - 1) * tree_bytes(_torch(p))
    ring, _, _ = _port_round(p, bufs, n, True, True, True)
    absa = np.abs(a.numpy()).astype(np.float64)
    for g, w, rg, x, like in zip(_leaves(got), _leaves(ref), _leaves(ring),
                                 _leaves(p), jax.tree.leaves(ref)):
        eps = 2.0 ** (-7 if np.dtype(like.dtype).name == "bfloat16"
                      else -20)
        bound = eps * np.tensordot(absa, np.abs(x), axes=1)
        assert (np.abs(g - w) <= bound).all(), float(np.abs(g - w).max())
        assert (np.abs(rg - g) <= bound).all(), float(np.abs(rg - g).max())


@pytest.mark.parametrize("n", [2, 3, 8])
def test_ring_coefficients(n):
    for got, want in zip(pgossip.ring_coefficients(n),
                         rgossip.ring_coefficients(n)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    a = pgossip.ring_matrix(n).numpy()
    np.testing.assert_allclose(a.sum(1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(a, a.T)
    if n == 2:   # a single pair: half each, nothing to the right
        np.testing.assert_array_equal(a, np.full((2, 2), 0.5, np.float32))


def test_init_ring_buffers_are_copies():
    p = _torch(_stacked("mamba2", 3, 0))
    bufs = pgossip.init_ring_buffers(p)
    for side in ("left", "right"):
        b = bufs[side]["blocks"]["mamba"]["w_zx"]
        assert torch.equal(b, p["blocks"]["mamba"]["w_zx"])
        assert b.data_ptr() != p["blocks"]["mamba"]["w_zx"].data_ptr()
