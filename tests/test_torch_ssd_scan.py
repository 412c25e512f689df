"""The port's `ssd_scan` op on the CPU (its plain version) against the
reference's Pallas `ssd_scan` in interpret mode and its oracle
`ssd_scan_ref`, on the same numpy-seeded inputs, with the reference
kernel tests' tolerances (`test_kernels._tol`: 5e-4 for f32, 2e-2 for
bf16), plus chunk invariance, chunks that are not powers of two, and the
op's refusals. The three chunk-parallel passes that the kernel's bf16
route runs (`ref.ssd_scan_passes`) are held against the same, and their
bf16 roundings against fp32.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.ssd_scan.ops import ssd_scan as rssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref as rssd_ref  # noqa: E402

from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_passes, ssd_scan_ref)

SSD_CASES = [
    # (b, s, h, p, n, chunk, dtype) -- test_kernels.SSD_CASES
    (2, 32, 3, 8, 16, 8, "float32"),
    (1, 64, 2, 16, 32, 16, "float32"),
    (2, 48, 4, 8, 16, 16, "float32"),
    (1, 40, 2, 8, 16, 16, "float32"),    # padding path (40 % 16 != 0)
    (1, 64, 2, 64, 128, 32, "float32"),  # production-ish dims
    (2, 32, 2, 8, 16, 8, "bfloat16"),
]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=5e-4, atol=5e-4)


def _inputs(b, s, h, p, n, seed=0):
    """fp32 numpy inputs in the reference tests' distribution: dt =
    softplus(normal), A = -exp(0.5 * normal)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(f32)
    A = (-np.exp(0.5 * rng.standard_normal(h))).astype(f32)
    B = rng.standard_normal((b, s, n)).astype(f32)
    C = rng.standard_normal((b, s, n)).astype(f32)
    return x, dt, A, B, C


def _both(arrays, dtype):
    """The same values as jax arrays and torch tensors of ``dtype`` (fp32
    -> bf16 rounds to nearest even on both sides)."""
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_op_matches_interpret_kernel_and_oracle(case):
    b, s, h, p, n, chunk, dtype = case
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        _inputs(b, s, h, p, n), dtype)
    before = ops.ssd_scan.launches
    got = ops.ssd_scan(tx, tdt, tA, tB, tC, chunk=chunk)
    assert ops.ssd_scan.launches == before  # CPU tensors launch nothing
    assert got.dtype == getattr(torch, dtype) and got.shape == tx.shape
    kern = rssd_scan(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(kern), **_tol(dtype))
    ref_chunk = chunk if s % chunk == 0 else 8
    oracle = rssd_ref(*(a.astype(jnp.float32) for a in (jx, jdt, jA, jB, jC)),
                      chunk=ref_chunk)
    np.testing.assert_allclose(_f32(got), _f32(oracle), **_tol(dtype))


@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_plain_version_matches_reference_oracle(case):
    """`ssd_scan_ref` itself, in the inputs' own type, against the
    reference's oracle at a chunk that divides s. In bf16 both keep every
    intermediate and the state in bf16 but round at other places (XLA
    fuses elementwise chains and picks its own einsum order), so values
    near zero differ by bf16 steps of their larger neighbours: there the
    limit is 2e-2 of the output's scale."""
    b, s, h, p, n, chunk, dtype = case
    ref_chunk = chunk if s % chunk == 0 else 8
    j, t = _both(_inputs(b, s, h, p, n, seed=1), dtype)
    got = ssd_scan_ref(*t, chunk=ref_chunk)
    want = rssd_ref(*j, chunk=ref_chunk)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        err = float(np.abs(_f32(got) - _f32(want)).max())
        assert err <= 2e-2 * float(np.abs(_f32(want)).max()), err
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_chunk_invariance():
    _, (x, dt, A, B, C) = _both(_inputs(1, 64, 2, 8, 16, seed=2), "float32")
    outs = [ops.ssd_scan(x, dt, A, B, C, chunk=c).numpy()
            for c in (8, 16, 32, 64)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0], o, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,chunk", [(100, 256), (300, 100), (77, 24)],
                         ids=["chunk=s=100", "chunk=100", "padded-chunk=24"])
def test_chunk_not_a_power_of_two(s, chunk):
    """A prompt of 100 tokens takes a chunk of 100; 300 tokens at chunk 100
    carry the state over three chunks; 77 at 24 pads the last chunk."""
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        _inputs(2, s, 2, 8, 16, seed=3), "float32")
    assert ops.chunk_for(s, chunk) == (min(chunk, s) if s % chunk else chunk)
    got = ops.ssd_scan(tx, tdt, tA, tB, tC, chunk=chunk)
    kern = rssd_scan(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(kern), **_tol("float32"))
    oracle = rssd_ref(jx, jdt, jA, jB, jC, chunk=1)
    np.testing.assert_allclose(_f32(got), _f32(oracle), **_tol("float32"))


def test_padding_is_exact():
    """Padding with dt = 0 leaves the valid rows as an unpadded scan at a
    chunk that divides s gives them."""
    _, (x, dt, A, B, C) = _both(_inputs(1, 40, 2, 8, 16, seed=4), "float32")
    padded = ops.ssd_scan(x, dt, A, B, C, chunk=16)      # 40 -> 48
    exact = ssd_scan_ref(x, dt, A, B, C, chunk=8)
    np.testing.assert_allclose(padded.numpy(), exact.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_strided_inputs():
    """x, B and C as slices of one buffer, as the model hands them."""
    rng = np.random.default_rng(5)
    buf = torch.from_numpy(rng.standard_normal((2, 24, 3 * 8 + 2 * 16))
                           .astype(np.float32))
    x = buf[..., :24].reshape(2, 24, 3, 8)
    B, C = buf[..., 24:40], buf[..., 40:]
    _, (_, dt, A, _, _) = _both(_inputs(2, 24, 3, 8, 16, seed=6), "float32")
    torch.testing.assert_close(
        ops.ssd_scan(x, dt, A, B, C, chunk=8),
        ops.ssd_scan(x.contiguous(), dt, A, B.contiguous(), C.contiguous(),
                     chunk=8), rtol=0, atol=0)


def test_plain_version_refuses_a_chunk_that_does_not_divide():
    _, t = _both(_inputs(1, 40, 2, 8, 16), "float32")
    with pytest.raises(ValueError, match="seq 40 not divisible by chunk 16"):
        ssd_scan_ref(*t, chunk=16)


def test_op_refuses_bad_inputs():
    _, (x, dt, A, B, C) = _both(_inputs(1, 16, 2, 8, 16), "float32")
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssd_scan(x, dt[:, :8], A, B, C)
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssd_scan(x, dt, A[:1], B, C)
    with pytest.raises(ValueError, match="must be"):
        ops.ssd_scan(x[0], dt, A, B, C)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt, A, B.long(), C)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dt, A, B, C, chunk=0)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ssd_scan(*(t.to("meta") for t in (x, dt, A, B, C)))


@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_passes_compose_to_the_scan(case):
    """Chunk states, state passing and chunk scan, composed in fp32 on
    the op's padded inputs, against `ssd_scan_ref` and the reference's
    interpret-mode Pallas kernel (5e-4)."""
    b, s, h, p, n, chunk, dtype = case
    (jx, jdt, jA, jB, jC), t = _both(_inputs(b, s, h, p, n, seed=7), dtype)
    x, dt, A, B, C = (a.float() for a in t)
    q = ops.chunk_for(s, chunk)
    pad = (-s) % q
    padded = [torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
              for a in (x, dt, B, C)]
    got = ssd_scan_passes(padded[0], padded[1], A, padded[2], padded[3],
                          chunk=q)[:, :s]
    want = ssd_scan_ref(padded[0], padded[1], A, padded[2], padded[3],
                        chunk=q)[:, :s]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-4,
                               atol=5e-4)
    kern = rssd_scan(*(a.astype(jnp.float32) for a in (jx, jdt, jA, jB, jC)),
                     chunk=chunk, interpret=True)
    np.testing.assert_allclose(got.numpy(), _f32(kern), rtol=5e-4,
                               atol=5e-4)


@pytest.mark.parametrize("n", [128, 64], ids=["mamba2-n128", "zamba2-n64"])
def test_bf16_route_rounding_within_row_limit(n):
    """The bf16 route's roundings, emulated: on bf16 inputs at a reduced
    mamba2-like shape (b 1, s 1024, h 4, p 64, chunk 256), every formed
    operand as the kernel's bf16 hi + lo pair, products in fp32, the
    output cast to bf16. Each (token, head) row stays within 1e-2
    relative L2 of the fp32 scan, the limit the kernel is held to on the
    card (chip_smoke's FP32_ROW_REL_TOL), and each element within the
    reference tests' bf16 tolerance (2e-2 + 2e-2 |y|), which one rounding
    of each operand misses where a row's terms cancel."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in
                      _inputs(1, 1024, 4, 64, n, seed=8))
    x, B, C = (t.to(torch.bfloat16).float() for t in (x, B, C))
    want = ssd_scan_ref(x, dt, A, B, C, chunk=256)
    got = ssd_scan_passes(x, dt, A, B, C, chunk=256,
                          operands=torch.bfloat16).to(torch.bfloat16).float()
    row = (got - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(row.max()) < 1e-2, float(row.max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), **_tol("bfloat16"))
