"""The port's gossip kernels' plain versions against the reference's.

`gossip_combine` (fixed-K stacked combine), on the reference kernel
tests' cases (`tests/test_kernels.py`: K 2/5/8/3/4, T 1024/4096/1000/
70000/4096, fp32 and bf16; T = 65537; T = 0):
* The port's plain version multiplies, then adds, in ascending k, each
  product rounded: bit-equal to that chain done in numpy.
* The reference's oracle (an einsum) and its Pallas kernel in interpret
  mode are XLA:CPU's FMA chain fma(a[K-1], w[K-1], ... fma(a1, w1,
  a0*w0)): the port is held within 2^-22 * sum_k |a_k w_k| of both in
  fp32 (about a third of the elements differ, by one or two ulps of that
  magnitude) and one bf16 ulp (2^-7 of it) in bf16 (where the cases here
  agree bit for bit).
* `combine_pytree` on a nested tree, bf16 leaves staying bf16.

`edge_aggregate` (CSR):
* The plain version (`repro_torch.kernels.gossip_combine.ref`) is held
  bit for bit (`np.array_equal`) against `edge_aggregate_ref`, the
  reference's `segment_sum` oracle on XLA:CPU: both multiply, then add,
  in ascending edge order, with `diag*w` last.
* It is held within 1e-6 of the reference's Pallas kernel in interpret
  mode, which XLA contracts into FMAs (so up to about 7e-7 apart).
* On CPU tensors the dispatching op is the plain version and launches
  nothing.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core.delay import FEMNIST as RFEMNIST  # noqa: E402
from repro.fl import dpasgd as rdpasgd  # noqa: E402
from repro.kernels.gossip_combine import ops as rops  # noqa: E402
from repro.kernels.gossip_combine.ref import \
    edge_aggregate_ref as redge_ref  # noqa: E402
from repro.kernels.gossip_combine.ref import \
    gossip_combine_ref as rcombine_ref  # noqa: E402
from repro.networks.registry import get_network as rget  # noqa: E402

from repro_torch.kernels.gossip_combine import ops as pops  # noqa: E402
from repro_torch.kernels.gossip_combine.ref import \
    edge_aggregate_ref as pedge_ref  # noqa: E402
from repro_torch.kernels.gossip_combine.ref import \
    gossip_combine_ref as pcombine_ref  # noqa: E402
from repro_torch.models.transformer import \
    params_from_reference  # noqa: E402

# (K, T, dtype): the reference kernel tests' cases, T = 65537 (a 1-column
# tail past the reference's 65536 tile) and T = 0.
COMBINE_CASES = [(2, 1024, "float32"), (5, 4096, "float32"),
                 (8, 1000, "float32"), (3, 70000, "float32"),
                 (4, 4096, "bfloat16"), (3, 65537, "float32"),
                 (3, 65537, "bfloat16"), (2, 0, "float32"),
                 (1, 300, "float32"), (6, 257, "bfloat16")]


def _combine_inputs(k, t, dtype, seed=0):
    """Weights rounded to ``dtype``, carried as the same bits to both."""
    rng = np.random.default_rng(seed + 1000 * k + t)
    w = np.asarray(jnp.asarray(rng.normal(size=(k, t)).astype(np.float32),
                               dtype))
    a = rng.dirichlet(np.ones(k)).astype(np.float32)
    return w, a


def _chain(w, a):
    """The rounded chain in numpy fp32: ((0 + a0 w0) + a1 w1) + ..."""
    acc = np.zeros(w.shape[1:], np.float32)
    for k in range(len(a)):
        acc = acc + a[k] * w[k].astype(np.float32)
    return acc


@pytest.mark.parametrize("k,t,dtype", COMBINE_CASES)
def test_combine_plain_version_against_reference(k, t, dtype):
    w, a = _combine_inputs(k, t, dtype)
    before = pops.gossip_combine.launches
    got = pops.gossip_combine(params_from_reference(w), torch.from_numpy(a))
    assert pops.gossip_combine.launches == before  # CPU: plain version
    assert got.shape == (t,) and got.dtype == getattr(torch, dtype)
    torch.testing.assert_close(
        got, pcombine_ref(params_from_reference(w), torch.from_numpy(a)),
        rtol=0, atol=0)
    got = got.float().numpy()
    want = _chain(w, a)
    if dtype == "bfloat16":
        want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(got, want)

    mag = np.abs(a[:, None].astype(np.float64) * w.astype(np.float64)).sum(0)
    bound = (2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -22) * mag
    for ref in (rcombine_ref(jnp.asarray(w), jnp.asarray(a)),
                rops.gossip_combine(jnp.asarray(w), jnp.asarray(a),
                                    interpret=True)):
        ref = np.asarray(ref, np.float32)
        assert ref.shape == (t,)
        assert (np.abs(got - ref) <= bound).all()


def test_combine_pytree_nested_tree():
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(3, 8, 16)).astype(np.float32),
            "b": {"c": np.asarray(jnp.asarray(rng.normal(size=(3, 50)),
                                              jnp.bfloat16)),
                  "d": rng.normal(size=(3,)).astype(np.float32)}}
    a = np.asarray([0.2, 0.3, 0.5], np.float32)
    before = pops.gossip_combine.launches
    got = pops.combine_pytree(params_from_reference(tree),
                              torch.from_numpy(a))
    assert pops.gossip_combine.launches == before
    ref = rops.combine_pytree(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(a), interpret=True)
    assert got["b"]["c"].dtype == torch.bfloat16
    assert got["b"]["d"].shape == ()
    leaves = {("a",): tree["a"], ("b", "c"): tree["b"]["c"],
              ("b", "d"): tree["b"]["d"]}
    for path, w in leaves.items():
        g, r = got, ref
        for key in path:
            g, r = g[key], r[key]
        assert tuple(g.shape) == w.shape[1:]
        chain = _chain(w.reshape(3, -1), a).astype(w.dtype)
        np.testing.assert_array_equal(g.float().numpy().reshape(-1),
                                      chain.astype(np.float32))
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32),
                                   rtol=1e-5, atol=1e-5)


def _case(seed, n, e2, t, isolated=True):
    """Random dst-sorted CSR inputs; destination 0 is isolated."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, t)).astype(np.float32)
    buf = rng.normal(size=(e2, t)).astype(np.float32)
    lo = 1 if (isolated and n > 1) else 0
    dst = rng.integers(lo, n, size=e2).astype(np.int32)
    coeffs = rng.random(e2).astype(np.float32)
    diag = rng.random(n).astype(np.float32)
    order, row_ptr = pops.csr_sort(dst, n)
    return (w, buf[order], coeffs[order], row_ptr, diag, dst[order])


def _port(w, buf, coeffs, row_ptr, diag):
    return pops.edge_aggregate(torch.from_numpy(w), torch.from_numpy(buf),
                               torch.from_numpy(coeffs),
                               torch.from_numpy(row_ptr),
                               torch.from_numpy(diag)).numpy()


def _segment_sum_ref(w, buf, coeffs, dst, diag):
    return np.asarray(redge_ref(jnp.asarray(w), jnp.asarray(buf),
                                jnp.asarray(coeffs), jnp.asarray(dst),
                                jnp.asarray(diag)))


def _pallas(w, buf, coeffs, row_ptr, diag):
    return np.asarray(rops.edge_aggregate(
        jnp.asarray(w), jnp.asarray(buf), jnp.asarray(coeffs),
        jnp.asarray(row_ptr), jnp.asarray(diag), block_t=256,
        interpret=True))


@pytest.mark.parametrize("seed,n,e2,t", [
    (0, 11, 22, 1000), (1, 5, 37, 333), (2, 12, 1, 129), (3, 2, 40, 700),
    (4, 7, 9, 1), (5, 3, 6, 4099)])
def test_plain_bit_equal_to_segment_sum_and_close_to_pallas(seed, n, e2, t):
    w, buf, coeffs, row_ptr, diag, dst = _case(seed, n, e2, t)
    before = pops.edge_aggregate.launches
    out = _port(w, buf, coeffs, row_ptr, diag)
    assert pops.edge_aggregate.launches == before  # CPU: plain version
    ref = _segment_sum_ref(w, buf, coeffs, dst, diag)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(out, _pallas(w, buf, coeffs, row_ptr, diag),
                               rtol=0, atol=1e-6)
    if n > 1:  # the isolated destination: diag-scaled own weights only
        np.testing.assert_array_equal(out[0], diag[0] * w[0])


def test_gaia_plan_every_state():
    """The real gaia plan (N=11, 2E=22) at a ragged width, every state."""
    plan, _ = rdpasgd.make_round_schedule("multigraph", rget("gaia"),
                                          RFEMNIST)
    n, e2, t = 11, len(plan.src), 2051
    rng = np.random.default_rng(0)
    w = rng.normal(size=(n, t)).astype(np.float32)
    buf = rng.normal(size=(e2, t)).astype(np.float32)
    order, row_ptr = pops.csr_sort(plan.dst, n)
    for k in range(plan.num_rounds_cycle):
        coeffs = plan.coeffs[k][order]
        diag = plan.diag[k]
        out = _port(w, buf[order], coeffs, row_ptr, diag)
        np.testing.assert_array_equal(
            out, _segment_sum_ref(w, buf[order], coeffs, plan.dst[order],
                                  diag))
        np.testing.assert_allclose(
            out, _pallas(w, buf[order], coeffs, row_ptr, diag),
            rtol=0, atol=1e-6)


def test_degenerate_shapes():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    diag = np.full(4, 0.5, np.float32)
    # no edges at all: diag * w
    empty = (np.zeros((0, 16), np.float32), np.zeros(0, np.float32),
             np.zeros(5, np.int32))
    out = _port(w, *empty, diag)
    np.testing.assert_array_equal(out, 0.5 * w)
    np.testing.assert_array_equal(
        out, _pallas(w, *empty, diag))
    # zero-width model
    out = _port(np.zeros((4, 0), np.float32), np.zeros((3, 0), np.float32),
                np.ones(3, np.float32), np.array([0, 1, 2, 3, 3], np.int32),
                diag)
    assert out.shape == (4, 0)


def test_plain_version_is_the_op_on_cpu():
    w, buf, coeffs, row_ptr, diag, _ = _case(9, 6, 14, 77)
    args = [torch.from_numpy(a) for a in (w, buf, coeffs, row_ptr, diag)]
    torch.testing.assert_close(pops.edge_aggregate(*args), pedge_ref(*args),
                               rtol=0, atol=0)
