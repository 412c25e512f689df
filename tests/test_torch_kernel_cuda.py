"""The CUDA `edge_aggregate` kernel against its plain PyTorch version.

This file imports no jax, so it collects on a machine with only the
port's dependencies. The tests marked ``cuda`` need an NVIDIA card and
skip without one; the others check the dispatch on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.gossip_combine import ops
from repro_torch.kernels.gossip_combine.ref import edge_aggregate_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(seed, n, e2, t, device):
    rng = np.random.default_rng(seed)
    dst = rng.integers(1 if n > 1 else 0, n, size=e2)  # row 0 isolated
    order, row_ptr = ops.csr_sort(dst, n)
    arrays = (rng.normal(size=(n, t)), rng.normal(size=(e2, t))[order],
              rng.random(e2)[order], row_ptr, rng.random(n))
    dtypes = (torch.float32,) * 3 + (torch.int32, torch.float32)
    return [torch.as_tensor(a, dtype=dt, device=device)
            for a, dt in zip(arrays, dtypes)]


def test_cpu_tensors_take_the_plain_version():
    args = _case(0, 5, 12, 33, "cpu")
    before = ops.edge_aggregate.launches
    torch.testing.assert_close(ops.edge_aggregate(*args),
                               edge_aggregate_ref(*args), rtol=0, atol=0)
    assert ops.edge_aggregate.launches == before


def test_no_device_and_no_card_raises():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_csr_sort_keeps_edge_order_within_rows():
    dst = np.array([3, 1, 3, 0, 1, 3])
    order, row_ptr = ops.csr_sort(dst, 5)
    np.testing.assert_array_equal(order, [3, 1, 4, 0, 2, 5])
    np.testing.assert_array_equal(row_ptr, [0, 1, 3, 3, 6, 6])


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,e2,t", [
    (0, 11, 22, 1_280_478), (1, 11, 22, 4099), (2, 5, 37, 333),
    (3, 12, 1, 1), (4, 3, 0, 1025)])
def test_kernel_equals_plain_version(cuda, seed, n, e2, t):
    args = _case(seed, n, e2, t, cuda)
    before = ops.edge_aggregate.launches
    out = ops.edge_aggregate(*args)
    torch.cuda.synchronize()
    assert ops.edge_aggregate.launches == before + 1
    torch.testing.assert_close(out, edge_aggregate_ref(*args), rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    w, buf, coeffs, row_ptr, diag = _case(0, 4, 6, 64, cuda)
    with pytest.raises(TypeError):
        ops.edge_aggregate(w.double(), buf, coeffs, row_ptr, diag)
    with pytest.raises(ValueError):
        ops.edge_aggregate(w, buf[:, :32], coeffs, row_ptr, diag)
    with pytest.raises(ValueError):
        ops.edge_aggregate(w, buf.t().contiguous().t(), coeffs, row_ptr, diag)
    with pytest.raises(ValueError):
        ops.edge_aggregate(w, buf.cpu(), coeffs, row_ptr, diag)
