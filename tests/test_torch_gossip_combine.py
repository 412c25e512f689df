"""The port's CSR edge aggregation against the reference's.

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
from repro.networks.registry import get_network as rget  # noqa: E402

from repro_torch.kernels.gossip_combine import ops as pops  # noqa: E402
from repro_torch.kernels.gossip_combine.ref import \
    edge_aggregate_ref as pedge_ref  # noqa: E402


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
