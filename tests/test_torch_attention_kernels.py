"""The port's attention ops on the CPU (their plain versions) against the
reference's oracles and its Pallas kernels in interpret mode, on the same
numpy-seeded inputs, with the reference kernel tests' tolerances
(`test_kernels._tol`: 5e-4 for f32, 2e-2 for bf16).

* `flash_attention` (model layout (B, S, H, hd)) against
  `flash_attention_ref` and the interpret-mode `flash_attention` kernel;
* `decode_attention` (cache layout (B, S, Hkv, hd)) against
  `decode_attention_ref` and the interpret-mode `decode_attention` kernel;
* cache rows past `lengths` have no effect; Sq != Sk and lengths of 0
  are refused; CPU tensors launch nothing.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.decode_attention.kernel import \
    decode_attention as rdec_kernel  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as rdec_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import \
    flash_attention as rfa_kernel  # noqa: E402
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as rfa_ref  # noqa: E402

from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref as pdec_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref as pfa_ref  # noqa: E402

FA_CASES = [
    # (b, hq, hkv, s, hd, window, prefix, dtype) -- test_kernels.FA_CASES
    (2, 4, 2, 64, 32, 0, 0, "float32"),
    (1, 8, 1, 128, 64, 0, 0, "float32"),      # MQA
    (1, 8, 8, 96, 32, 0, 0, "float32"),       # MHA, ragged blocks
    (2, 4, 4, 96, 32, 16, 0, "float32"),      # sliding window
    (1, 2, 1, 64, 32, 0, 24, "float32"),      # bidirectional prefix
    (1, 4, 2, 64, 32, 8, 16, "float32"),      # window + prefix
    (2, 4, 2, 64, 64, 0, 0, "bfloat16"),      # bf16
    (1, 16, 4, 80, 128, 0, 0, "float32"),     # hd=128, non-multiple seq
    # the shapes of the card's wgmma-route cases, in fp32
    (1, 14, 2, 300, 128, 0, 0, "float32"),    # group 7 (126-row CTAs)
    (1, 8, 1, 40, 64, 0, 0, "float32"),       # S under one key tile
    (2, 8, 1, 333, 64, 0, 0, "float32"),      # ragged 128-key tiles
    (1, 4, 2, 520, 128, 200, 130, "float32"),  # window/prefix across tiles
    # hd 256 (paligemma's), which the card takes in 64-key tiles: MQA with
    # a group of 8, a prefix across a tile edge and a ragged last tile; a
    # window
    (1, 8, 1, 136, 256, 0, 40, "float32"),
    (1, 8, 1, 136, 256, 0, 40, "bfloat16"),
    (2, 4, 2, 72, 256, 24, 0, "float32"),
]
DEC_CASES = [
    # (b, hq, hkv, s, hd, block_s, dtype) -- test_kernels.DEC_CASES
    (2, 4, 2, 128, 32, 32, "float32"),
    (1, 8, 1, 256, 64, 64, "float32"),    # MQA
    (2, 16, 4, 200, 128, 64, "float32"),  # ragged blocks
    (1, 4, 4, 96, 32, 32, "bfloat16"),    # MHA bf16
]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=5e-4, atol=5e-4)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``
    (fp32 -> bf16 rounds to nearest even on both sides)."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("case", FA_CASES, ids=[str(c) for c in FA_CASES])
def test_flash_plain_matches_ref_and_interpret_kernel(case):
    b, hq, hkv, s, hd, win, pre, dt = case
    rng = np.random.default_rng(0)
    # kernel layout (B, H, S, hd) for the reference's functions
    qn, kn, vn = (rng.standard_normal((b, h, s, hd)).astype(np.float32)
                  for h in (hq, hkv, hkv))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dt) for x in (qn, kn, vn))
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                                 vt.transpose(1, 2), window=win,
                                 prefix=pre).transpose(1, 2)
    assert fa_ops.flash_attention.launches == before  # CPU: plain version
    assert got.dtype == qt.dtype and tuple(got.shape) == (b, hq, s, hd)
    ref = rfa_ref(qj, kj, vj, window=win, prefix=pre)
    np.testing.assert_allclose(_f32(got), _f32(ref), **_tol(dt))
    ker = rfa_kernel(qj, kj, vj, window=win, prefix=pre, block_q=32,
                     block_k=32, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(ker), **_tol(dt))
    # the plain version itself, in the oracle's layout
    np.testing.assert_allclose(_f32(pfa_ref(qt, kt, vt, window=win,
                                            prefix=pre)), _f32(got),
                               rtol=0, atol=0)


def test_flash_plain_fused_projection_slice():
    """q, k, v as column slices of one fused (B, S, (Hq + 2 Hkv) hd)
    projection (q's sequence stride is not Hq hd), against the
    reference's oracle and interpret-mode kernel on contiguous copies."""
    b, hq, hkv, s, hd = 2, 14, 2, 72, 128
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((b, s, (hq + 2 * hkv) * hd)).astype(np.float32)
    t = torch.from_numpy(qkv)
    q = t[..., :hq * hd].unflatten(-1, (hq, hd))
    k = t[..., hq * hd:(hq + hkv) * hd].unflatten(-1, (hkv, hd))
    v = t[..., (hq + hkv) * hd:].unflatten(-1, (hkv, hd))
    assert q.stride(1) == (hq + 2 * hkv) * hd
    got = fa_ops.flash_attention(q, k, v, window=40, prefix=9)
    qj, kj, vj = (jnp.asarray(x.transpose(1, 2).contiguous().numpy())
                  for x in (q, k, v))
    want = rfa_ref(qj, kj, vj, window=40, prefix=9)
    np.testing.assert_allclose(_f32(got.transpose(1, 2)), _f32(want),
                               **_tol("float32"))
    ker = rfa_kernel(qj, kj, vj, window=40, prefix=9, block_q=32,
                     block_k=32, interpret=True)
    np.testing.assert_allclose(_f32(got.transpose(1, 2)), _f32(ker),
                               **_tol("float32"))


@pytest.mark.parametrize("case", DEC_CASES, ids=[str(c) for c in DEC_CASES])
def test_decode_plain_matches_ref_and_interpret_kernel(case):
    b, hq, hkv, s, hd, bs, dt = case
    rng = np.random.default_rng(1)
    qn = rng.standard_normal((b, hq, hd)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
              for _ in range(2))
    lengths = rng.integers(1, s + 1, b).astype(np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dt) for x in (qn, kn, vn))
    before = dec_ops.decode_attention.launches
    # the op takes the transformer's (B, S, Hkv, hd) cache layout
    got = dec_ops.decode_attention(qt, kt.transpose(1, 2),
                                   vt.transpose(1, 2),
                                   torch.from_numpy(lengths))
    assert dec_ops.decode_attention.launches == before
    assert got.dtype == qt.dtype and tuple(got.shape) == (b, hq, hd)
    lj = jnp.asarray(lengths)
    np.testing.assert_allclose(_f32(got), _f32(rdec_ref(qj, kj, vj, lj)),
                               **_tol(dt))
    ker = rdec_kernel(qj, kj, vj, lj, block_s=bs, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(ker), **_tol(dt))
    np.testing.assert_allclose(
        _f32(pdec_ref(qt, kt, vt, torch.from_numpy(lengths))), _f32(got),
        rtol=0, atol=0)


def test_decode_entries_past_lengths_have_no_effect():
    rng = np.random.default_rng(2)
    b, hq, hkv, s, hd = 2, 4, 2, 128, 32
    q = torch.from_numpy(rng.standard_normal((b, hq, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, hd))
                             .astype(np.float32)) for _ in range(2))
    lengths = torch.tensor([40, 97], dtype=torch.int32)
    out1 = dec_ops.decode_attention(q, k, v, lengths)
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lengths.tolist()):
        k2[i, n:] = 999.0
        v2[i, n:] = -999.0
    out2 = dec_ops.decode_attention(q, k2, v2, lengths)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6,
                               atol=1e-6)
    # and the reference's kernel agrees on the same cut
    ker = rdec_kernel(jnp.asarray(q.numpy()),
                      jnp.asarray(k2.transpose(1, 2).numpy()),
                      jnp.asarray(v2.transpose(1, 2).numpy()),
                      jnp.asarray(lengths.numpy()), block_s=32,
                      interpret=True)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ker), **_tol("f32"))


def test_flash_rejects_sq_not_sk():
    q = torch.zeros(1, 8, 2, 32)
    k = torch.zeros(1, 12, 2, 32)
    with pytest.raises(ValueError, match="Sq=8 != Sk=12"):
        fa_ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.flash_attention(torch.zeros(1, 8, 3, 32),
                               torch.zeros(1, 8, 2, 32),
                               torch.zeros(1, 8, 2, 32))


@pytest.mark.parametrize("b,hkv,s,sms,want", [
    (8, 4, 2048, 132, 8),    # yi-9b decode: 32 clusters, capped at 8
    (8, 4, 4096, 132, 8),    # DEC_MAIN
    (8, 32, 2048, 132, 2),   # zamba2's shared block: 256 clusters
    (1, 1, 2048, 132, 8),    # B = 1, Hkv = 1
    (1, 1, 100, 132, 2),     # no more splits than 64-row tiles
    (1, 1, 64, 132, 1),
    (16, 32, 2048, 132, 1),  # more clusters than twice the SMs
    (8, 4, 2048, 114, 8),    # an H100 PCIe's SMs
    (8, 16, 2048, 66, 2),
])
def test_num_splits(b, hkv, s, sms, want):
    """CTAs per (sequence, KV head): min(8, max(1, ceil(2 SMs / (B Hkv))),
    ceil(S / 64)), from the shapes alone."""
    assert dec_ops.num_splits(b, hkv, s, sms) == want
    assert dec_ops.TILE == 64 and dec_ops.MAX_SPLITS == 8


@pytest.mark.parametrize("bad", [[0, 3], [2, 17]])
def test_decode_rejects_lengths_outside_cache(bad):
    q = torch.zeros(2, 4, 32)
    k = torch.zeros(2, 16, 2, 32)
    with pytest.raises(ValueError, match="lengths must lie in 1..16"):
        dec_ops.decode_attention(q, k, k, torch.tensor(bad))


def test_other_devices_raise():
    q = torch.zeros(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa_ops.flash_attention(q, q, q)
    qd = torch.zeros(1, 2, 32, device="meta")
    kd = torch.zeros(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        dec_ops.decode_attention(qd, kd, kd, torch.tensor([3]))
