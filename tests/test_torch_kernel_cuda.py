"""The CUDA kernels (`edge_aggregate`, `gossip_combine`,
`flash_attention`, `decode_attention`, `ssd_scan`) against their plain
PyTorch versions.

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


# ---------------------------------------------------------------------------
# the fused, grouped refresh-and-aggregate
# ---------------------------------------------------------------------------

from _refresh_cases import CASES as REFRESH_CASES  # noqa: E402
from _refresh_cases import multi_t_cases, segment_case  # noqa: E402
from repro_torch.kernels.gossip_combine.ref import (  # noqa: E402
    Segment, refresh_aggregate_ref)


def _refresh_segment(case, device):
    t = lambda a, dt=torch.float32: None if a is None else torch.tensor(
        a, dtype=dt, device=device)
    return Segment(t(case["w"]), t(case["buf"]), t(case["coeffs"]),
                   t(case["row_ptr"], torch.int32), t(case["diag"]),
                   fresh=t(case["fresh"]), src=t(case["src"], torch.int32),
                   strong=t(case["strong"], torch.bool),
                   edge_row=t(case["edge_row"], torch.int32))


def _same(a, b):
    """Equal, NaN where NaN (a NaN's payload may differ between kernels)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


def _kernel_against_plain(cases, device):
    segs = [_refresh_segment(c, device) for c in cases]
    plain = [_refresh_segment(c, device) for c in cases]
    before = ops.edge_aggregate.launches
    outs = ops.refresh_aggregate(segs)
    torch.cuda.synchronize()
    assert ops.edge_aggregate.launches == before + 1
    for seg, ref, out, want in zip(segs, plain, outs,
                                   refresh_aggregate_ref(plain)):
        assert _same(out, want)
        assert _same(seg.buf, ref.buf)


def test_refresh_aggregate_on_cpu_launches_nothing():
    cases = multi_t_cases(0)
    segs = [_refresh_segment(c, "cpu") for c in cases]
    plain = [_refresh_segment(c, "cpu") for c in cases]
    before = ops.edge_aggregate.launches
    for out, want in zip(ops.refresh_aggregate(segs),
                         refresh_aggregate_ref(plain)):
        assert torch.equal(out, want)
    assert ops.edge_aggregate.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REFRESH_CASES))
def test_refresh_aggregate_equals_plain_version(cuda, name):
    _kernel_against_plain([segment_case(7, **REFRESH_CASES[name])], cuda)


@pytest.mark.cuda
def test_refresh_aggregate_grouped_equals_plain_version(cuda):
    """One launch over segments of T = 1, 3, 4,099 and T % 4 = 0..3 plus
    every single case."""
    cases = multi_t_cases(1) + [segment_case(8, **kw)
                                for kw in REFRESH_CASES.values()]
    _kernel_against_plain(cases, cuda)


@pytest.mark.cuda
def test_refresh_aggregate_rows_off_the_grid_and_many_rows(cuda):
    """Rows whose starts are 4 or 8 bytes off the 16-byte grid (views
    into a larger buffer) take narrower loads; 300 rows and 700 edges,
    and 40 segments (two launches), work as a few do."""
    case = segment_case(9, n=300, e2=700, t=1026)
    _kernel_against_plain([case], cuda)
    segs = [_refresh_segment(segment_case(20 + k, n=3, e2=5, t=100 + k),
                             cuda) for k in range(40)]
    plain = [s._replace(buf=s.buf.clone()) for s in segs]
    before = ops.edge_aggregate.launches
    outs = ops.refresh_aggregate(segs)
    assert ops.edge_aggregate.launches == before + 2
    for seg, ref, out, want in zip(segs, plain, outs,
                                   refresh_aggregate_ref(plain)):
        assert _same(out, want) and _same(seg.buf, ref.buf)
    for offset in (1, 2):
        seg = _refresh_segment(segment_case(10, n=5, e2=9, t=4096), cuda)
        plain = _refresh_segment(segment_case(10, n=5, e2=9, t=4096), cuda)
        w = torch.zeros(5 * 4096 + offset, device=cuda)[offset:].view(5, 4096)
        w.copy_(seg.w)
        got, = ops.refresh_aggregate([seg._replace(w=w)])
        want, = refresh_aggregate_ref([plain])
        assert _same(got, want) and _same(seg.buf, plain.buf)


@pytest.mark.cuda
def test_refresh_aggregate_refuses(cuda, monkeypatch):
    """A launch the entry point refuses (more segments than its
    parameters hold) raises; so do inputs the wrapper does not take."""
    seg = _refresh_segment(segment_case(0, n=4, e2=6, t=64), cuda)
    monkeypatch.setattr(ops, "MAX_SEGMENTS", 64)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.refresh_aggregate([seg] * 33)
    monkeypatch.undo()
    with pytest.raises(TypeError):
        ops.refresh_aggregate([seg._replace(src=seg.src.long())])
    with pytest.raises(ValueError):
        ops.refresh_aggregate([seg._replace(strong=seg.strong[:3])])
    with pytest.raises(ValueError):
        ops.refresh_aggregate([seg._replace(fresh=seg.w.cpu())])


@pytest.mark.cuda
def test_cycle_takes_column_major_plan_slices(cuda):
    """The fault layer's masks (`expand_pair_mask`) are column-major: the
    flat cycle on the card takes them and gives what the contiguous
    slices give, bit for bit."""
    from repro_torch.core.delay import FEMNIST
    from repro_torch.fl import dpasgd, runtime
    from repro_torch.networks.registry import get_network
    from repro_torch.optim import flat_sgd

    plan, _ = dpasgd.make_round_schedule("multigraph", get_network("gaia"),
                                         FEMNIST)
    rt = runtime.make_flat_runtime(plan, {"w": torch.zeros(300)}, 11)
    pairs = np.random.default_rng(0).random((4, len(plan.src) // 2)) < 0.5
    strong = torch.as_tensor(rt.expand_pair_mask(pairs), device=cuda)
    assert not strong.is_contiguous()
    rest = [torch.as_tensor(x[:4], device=cuda) for x in (rt.coeffs, rt.diag)]
    opt = flat_sgd(0.05)
    loss = lambda p, b: torch.sum(p["w"] * b["g"])
    batches = {"g": torch.randn((4, 1, 11, 300), device=cuda)}
    outs = []
    for mask in (strong, strong.contiguous()):
        cycle = runtime.make_cycle_fn(rt, loss_fn=loss, opt=opt)
        state = runtime.init_flat_state(torch.ones(300, device=cuda), opt, rt)
        outs.append(cycle(state, batches, mask, *rest)[0])
    assert torch.equal(outs[0].w, outs[1].w)
    assert torch.equal(outs[0].buffers, outs[1].buffers)


# ---------------------------------------------------------------------------
# gossip_combine and the ring gossip round
# ---------------------------------------------------------------------------

from repro_torch.fl import gossip  # noqa: E402
from repro_torch.kernels.gossip_combine.ref import \
    gossip_combine_ref  # noqa: E402
from repro_torch.launch.fl8 import STATES, build_step  # noqa: E402
from repro_torch.launch.mesh import StackedSilos  # noqa: E402

# (K, T, dtype, offset): the reference kernel tests' cases, T = 65537,
# T = 0, K up to the kernel's 8 at odd T, and weights starting `offset`
# elements into their buffer (rows off the 16-byte grid).
COMBINE_CASES = [
    (2, 1024, torch.float32, 0), (5, 4096, torch.float32, 0),
    (8, 1000, torch.float32, 0), (3, 70000, torch.float32, 0),
    (4, 4096, torch.bfloat16, 0), (3, 65537, torch.float32, 0),
    (3, 65537, torch.bfloat16, 0), (2, 0, torch.float32, 0),
    (1, 7, torch.float32, 0), (7, 4099, torch.bfloat16, 0),
    (8, 4097, torch.float32, 0), (3, 4096, torch.float32, 1),
    (3, 4096, torch.bfloat16, 3), (6, 333, torch.float32, 2)]


def _combine_inputs(k, t, dtype, offset, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed + k * 100003 + t)
    buf = torch.randn((k * t + offset,), generator=gen).to(dtype)
    w = buf.to(device)[offset:].view(k, t)   # a view past the offset
    a = torch.rand((k,), generator=gen)
    return w, (a / a.sum()).to(device)


def test_combine_op_on_cpu_launches_nothing():
    w, a = _combine_inputs(3, 1001, torch.bfloat16, 0, "cpu")
    before = ops.gossip_combine.launches
    out = ops.gossip_combine(w, a)
    assert ops.gossip_combine.launches == before
    torch.testing.assert_close(out, gossip_combine_ref(w, a), rtol=0, atol=0)
    assert out.dtype == torch.bfloat16
    assert ops.gossip_combine(w[:, :0], a).shape == (0,)


def test_ring_round_on_cpu_launches_nothing():
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.normal(size=(4, 9)).astype(np.float32))}
    before = ops.gossip_combine.launches
    build_step(None, True, True, StackedSilos(4))(
        p, gossip.init_ring_buffers(p))
    assert ops.gossip_combine.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", COMBINE_CASES,
                         ids=[str(c) for c in COMBINE_CASES])
def test_combine_kernel_equals_plain_version(cuda, case):
    k, t, dtype, offset = case
    w, a = _combine_inputs(k, t, dtype, offset, cuda)
    before = ops.gossip_combine.launches
    out = ops.gossip_combine(w, a)
    torch.cuda.synchronize()
    assert ops.gossip_combine.launches == before + (1 if t else 0)
    assert out.shape == (t,) and out.dtype == dtype
    torch.testing.assert_close(out, gossip_combine_ref(w, a), rtol=0, atol=0)


@pytest.mark.cuda
def test_combine_kernel_rejects_bad_inputs(cuda):
    w, a = _combine_inputs(3, 64, torch.float32, 0, cuda)
    with pytest.raises(TypeError):
        ops.gossip_combine(w.double(), a)
    with pytest.raises(TypeError):
        ops.gossip_combine(w, a.double())
    with pytest.raises(ValueError):
        ops.gossip_combine(w, a[:2])
    with pytest.raises(ValueError):
        ops.gossip_combine(w.t().contiguous().t(), a)
    with pytest.raises(ValueError):
        ops.gossip_combine(w, a.cpu())
    w9, a9 = _combine_inputs(9, 64, torch.float32, 0, cuda)
    with pytest.raises(ValueError):
        ops.gossip_combine(w9, a9)


@pytest.mark.cuda
@pytest.mark.parametrize("state", STATES, ids=[s[0] for s in STATES])
def test_ring_round_kernel_path_equals_plain_path(cuda, state):
    """A small mixed bf16 / fp32 tree on 5 stacked silos: one launch per
    silo, bit-equal to the elementwise path, buffers bit-equal to the
    rolls where fresh."""
    _, left, right = state
    gen = torch.Generator(device="cpu").manual_seed(1)
    p = {"a": torch.randn((5, 3, 37), generator=gen).to(torch.bfloat16),
         "b": {"c": torch.randn((5, 129), generator=gen)}}
    p = {"a": p["a"].to(cuda), "b": {"c": p["b"]["c"].to(cuda)}}
    bufs = {"left": {"a": -p["a"], "b": {"c": 2 * p["b"]["c"]}},
            "right": {"a": p["a"] / 2, "b": {"c": -p["b"]["c"]}}}
    before = ops.gossip_combine.launches
    new, nb = build_step(None, left, right, StackedSilos(5))(p, bufs)
    torch.cuda.synchronize()
    assert ops.gossip_combine.launches == before + 5
    plain, _ = build_step(None, left, right, StackedSilos(5),
                          use_kernel=False)(p, bufs)
    assert torch.equal(new["a"], plain["a"]) and new["a"].dtype == \
        torch.bfloat16
    assert torch.equal(new["b"]["c"], plain["b"]["c"])
    if right:
        assert torch.equal(nb["left"]["a"], torch.roll(p["a"], 1, 0))
    if left:
        assert torch.equal(nb["right"]["b"]["c"],
                           torch.roll(p["b"]["c"], -1, 0))


# ---------------------------------------------------------------------------
# flash_attention and decode_attention
# ---------------------------------------------------------------------------

from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402

# (b, hq, hkv, s, hd, window, prefix, dtype): the reference kernel tests'
# cases, the yi-9b prefill shape, and bf16 cases for the tensor-core route
FA_CASES = [
    (2, 4, 2, 64, 32, 0, 0, torch.float32),
    (1, 8, 1, 128, 64, 0, 0, torch.float32),
    (1, 8, 8, 96, 32, 0, 0, torch.float32),
    (2, 4, 4, 96, 32, 16, 0, torch.float32),
    (1, 2, 1, 64, 32, 0, 24, torch.float32),
    (1, 4, 2, 64, 32, 8, 16, torch.float32),
    (2, 4, 2, 64, 64, 0, 0, torch.bfloat16),
    (1, 16, 4, 80, 128, 0, 0, torch.float32),
    (1, 4, 2, 200, 128, 16, 40, torch.bfloat16),
    (2, 6, 2, 80, 64, 0, 0, torch.bfloat16),
    (1, 1, 1, 256, 128, 8, 0, torch.bfloat16),
    (4, 32, 4, 2048, 128, 0, 0, torch.bfloat16),
    (1, 4, 2, 72, 256, 0, 0, torch.float32),      # hd=256 (paligemma)
    (1, 4, 2, 72, 256, 8, 16, torch.bfloat16),    # hd=256 on the wgmma route
    # what the wgmma route does differently: 126 rows a CTA (G=7, qwen2-7b's
    # group), S under one tile, ragged 128-key tiles, window and prefix
    # edges across tiles
    (1, 14, 2, 300, 128, 0, 0, torch.bfloat16),
    (1, 8, 1, 40, 64, 0, 0, torch.bfloat16),
    (2, 8, 1, 333, 64, 0, 0, torch.bfloat16),
    (1, 4, 2, 520, 128, 200, 130, torch.bfloat16),
    # hd 256 on the wgmma route, in 64-key tiles: S under one tile, ragged
    # tiles, G=7, paligemma's MQA and prefix over four tiles, window and
    # prefix edges across tiles, rows masked over whole tiles
    (1, 8, 1, 40, 256, 0, 0, torch.bfloat16),
    (2, 8, 1, 333, 256, 0, 0, torch.bfloat16),
    (1, 14, 2, 300, 256, 0, 0, torch.bfloat16),
    (1, 8, 1, 600, 256, 0, 256, torch.bfloat16),
    (1, 4, 2, 520, 256, 200, 130, torch.bfloat16),
    (1, 1, 1, 256, 256, 8, 0, torch.bfloat16),
]
DEC_CASES = [
    (2, 4, 2, 128, 32, torch.float32),
    (1, 8, 1, 256, 64, torch.float32),
    (2, 16, 4, 200, 128, torch.float32),
    (1, 4, 4, 96, 32, torch.bfloat16),
    (8, 32, 4, 4096, 128, torch.bfloat16),
    (2, 8, 2, 300, 256, torch.bfloat16),          # hd=256
    # groups of the configs: G=2 (gemma3, granite), 5 (qwen2.5-14b), 7
    # (qwen2-7b); MQA with G=32 (4 n8 tiles over the same K/V tiles); G=40
    # (a second CTA along grid z)
    (2, 4, 2, 300, 128, torch.bfloat16),
    (2, 10, 2, 333, 128, torch.bfloat16),
    (1, 28, 4, 700, 128, torch.bfloat16),
    (2, 32, 1, 520, 64, torch.bfloat16),
    (1, 40, 1, 260, 32, torch.bfloat16),
    (2, 32, 1, 130, 256, torch.float32),
    (2, 8, 2, 96, 32, torch.bfloat16),           # hd=32, 64-byte swizzle
]


def _tol(dtype):
    """The reference kernel tests' tolerances (test_kernels._tol)."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else \
        dict(rtol=5e-4, atol=5e-4)


def _fa_plain(q, k, v, window=0, prefix=0):
    return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), window=window,
                               prefix=prefix).transpose(1, 2)


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def test_attention_ops_on_cpu_launch_nothing():
    gen = torch.Generator().manual_seed(0)
    q, k = _randn(gen, (1, 16, 4, 32), torch.float32, "cpu"), \
        _randn(gen, (1, 16, 2, 32), torch.float32, "cpu")
    before = (fa_ops.flash_attention.launches,
              dict(fa_ops.flash_attention.launches_by_route),
              dec_ops.decode_attention.launches)
    torch.testing.assert_close(fa_ops.flash_attention(q, k, k),
                               _fa_plain(q, k, k), rtol=0, atol=0)
    lengths = torch.tensor([5])
    torch.testing.assert_close(
        dec_ops.decode_attention(q[:, 0], k, k, lengths),
        decode_attention_ref(q[:, 0], k.transpose(1, 2), k.transpose(1, 2),
                             lengths), rtol=0, atol=0)
    assert (fa_ops.flash_attention.launches,
            fa_ops.flash_attention.launches_by_route,
            dec_ops.decode_attention.launches) == before


def _fa_expected_route(case):
    """The route rule: bf16 at hd 64/128/256 (every case here has a
    group of at most 128 and aligned, contiguous tensors) takes wgmma."""
    dt, hd = case[7], case[4]
    return "wgmma" if dt == torch.bfloat16 and hd in (64, 128, 256) else \
        "cuda_core"


def _fused_qkv(gen, b, s, hq, hkv, hd, dtype, device):
    """q, k, v as column slices of one fused (B, S, (Hq + 2 Hkv) hd)
    projection, as a model's qkv GEMM hands them: q_ss != Hq hd."""
    qkv = _randn(gen, (b, s, (hq + 2 * hkv) * hd), dtype, device)
    q = qkv[..., :hq * hd].unflatten(-1, (hq, hd))
    k = qkv[..., hq * hd:(hq + hkv) * hd].unflatten(-1, (hkv, hd))
    v = qkv[..., (hq + hkv) * hd:].unflatten(-1, (hkv, hd))
    return q, k, v


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


# (id, q/k/v builder, route)
ROUTE_CASES = [
    ("bf16-hd128", lambda: (_bf16(1, 8, 4, 128),) * 3, "wgmma"),
    ("fp32", lambda: (_bf16(1, 8, 4, 128).float(),) * 3, "cuda_core"),
    ("rows-off-16-bytes",  # stride 132: rows off the 16-byte grid
     lambda: (_bf16(1, 8, 4, 132)[..., :128], _bf16(1, 8, 4, 128),
              _bf16(1, 8, 4, 128)), "cuda_core"),
    ("hd256", lambda: (_bf16(1, 8, 4, 256),) * 3, "wgmma"),
    ("hd256-rows-off-16-bytes",  # stride 260: rows off the 16-byte grid
     lambda: (_bf16(1, 8, 4, 260)[..., :256], _bf16(1, 8, 4, 256),
              _bf16(1, 8, 4, 256)), "cuda_core"),
    ("hd256-group256", lambda: (_bf16(1, 8, 256, 256), _bf16(1, 8, 1, 256),
                                _bf16(1, 8, 1, 256)), "cuda_core"),
    ("hd64", lambda: (_bf16(1, 8, 4, 64),) * 3, "wgmma"),
    ("hd32", lambda: (_bf16(1, 8, 4, 32),) * 3, "cuda_core"),
    ("group7", lambda: (_bf16(1, 8, 14, 128), _bf16(1, 8, 2, 128),
                        _bf16(1, 8, 2, 128)), "wgmma"),
    ("fused-projection-slice",
     lambda: _fused_qkv(torch.Generator().manual_seed(0), 1, 8, 14, 2, 128,
                        torch.bfloat16, "cpu"), "wgmma"),
    ("stride-off-16-bytes",  # sequence stride of 516 elements
     lambda: (_bf16(1, 8 * 516).as_strided((1, 8, 4, 128),
                                            (8 * 516, 516, 128, 1)),
              _bf16(1, 8, 4, 128), _bf16(1, 8, 4, 128)), "cuda_core"),
    ("base-off-16-bytes",
     lambda: (_bf16(1 + 8 * 4 * 128)[1:].view(1, 8, 4, 128),
              _bf16(1, 8, 4, 128), _bf16(1, 8, 4, 128)), "cuda_core"),
    ("group256", lambda: (_bf16(1, 8, 256, 64), _bf16(1, 8, 1, 64),
                          _bf16(1, 8, 1, 64)), "cuda_core"),
]


@pytest.mark.parametrize("make,want", [c[1:] for c in ROUTE_CASES],
                         ids=[c[0] for c in ROUTE_CASES])
def test_tensor_core_route_choice(make, want):
    q, k, v = make()
    assert fa_ops.route(q, k, v) == want
    assert fa_ops.tensor_core_route(q, k, v) == (want == "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CASES, ids=[str(c) for c in FA_CASES])
def test_flash_kernel_matches_plain_version(cuda, case):
    b, hq, hkv, s, hd, win, pre, dt = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_randn(gen, (b, s, h, hd), dt, cuda) for h in (hq, hkv, hkv))
    route = _fa_expected_route(case)
    assert fa_ops.route(q, k, v) == route
    before = fa_ops.flash_attention.launches
    by_route = fa_ops.flash_attention.launches_by_route[route]
    out = fa_ops.flash_attention(q, k, v, window=win, prefix=pre)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    assert fa_ops.flash_attention.launches_by_route[route] == by_route + 1
    assert out.dtype == dt and out.shape == q.shape
    torch.testing.assert_close(out.float(),
                               _fa_plain(q, k, v, win, pre).float(),
                               **_tol(dt))


@pytest.mark.cuda
def test_flash_kernel_fused_projection_slice(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = _fused_qkv(gen, 2, 300, 28, 4, 128, torch.bfloat16, cuda)
    assert q.stride(1) != q.shape[2] * q.shape[3]
    assert fa_ops.route(q, k, v) == "wgmma"
    out = fa_ops.flash_attention(q, k, v)
    torch.testing.assert_close(out.float(), _fa_plain(q, k, v).float(),
                               **_tol(torch.bfloat16))


@pytest.mark.cuda
def test_flash_kernel_refused_launch_raises(cuda, monkeypatch):
    """A wgmma-route input whose launch the card refuses (more row blocks
    than the grid's y axis holds: group 128 puts one query position in a
    CTA, so S = 65536 needs 65536 of them) raises, at hd 64 and at hd 256
    (64-key tiles), and nothing falls back to the plain version or to the
    CUDA-core route."""
    def no_plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(fa_ops, "flash_attention_ref", no_plain)
    s = 65536
    for hd in (64, 256):
        q = torch.zeros((1, s, 128, hd), dtype=torch.bfloat16, device=cuda)
        k = torch.zeros((1, s, 1, hd), dtype=torch.bfloat16, device=cuda)
        assert fa_ops.route(q, k, k) == "wgmma"
        with pytest.raises(RuntimeError, match="cudaError 9"):
            fa_ops.flash_attention(q, k, k)
        del q, k


@pytest.mark.cuda
def test_flash_kernel_cuda_core_route_for_unaligned_bf16(cuda):
    """bf16 q whose rows lie off the 16-byte grid (stride hd + 4) takes
    the CUDA-core route, at hd 64 and at hd 256."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    for hd in (64, 256):
        q = _randn(gen, (2, 70, 4, hd + 4), torch.bfloat16, cuda)[..., :hd]
        k, v = (_randn(gen, (2, 70, 2, hd), torch.bfloat16, cuda)
                for _ in range(2))
        assert fa_ops.route(q, k, v) == "cuda_core"
        out = fa_ops.flash_attention(q, k, v, window=9)
        torch.testing.assert_close(out.float(),
                                   _fa_plain(q, k, v, 9).float(),
                                   **_tol(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("case", DEC_CASES, ids=[str(c) for c in DEC_CASES])
def test_decode_kernel_matches_plain_version(cuda, case):
    b, hq, hkv, s, hd, dt = case
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, (b, hq, hd), dt, cuda)
    k, v = (_randn(gen, (b, s, hkv, hd), dt, cuda) for _ in range(2))
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=cuda)
    before = dec_ops.decode_attention.launches
    out = dec_ops.decode_attention(q, k, v, lengths)          # on the card
    out_host = dec_ops.decode_attention(q, k, v, lengths.cpu())  # on host
    torch.cuda.synchronize()
    assert dec_ops.decode_attention.launches == before + 2
    torch.testing.assert_close(out, out_host, rtol=0, atol=0)
    plain = decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                 lengths)
    torch.testing.assert_close(out.float(), plain.float(), **_tol(dt))
    # rows at or past lengths are never read
    past = (torch.arange(s, device=cuda)[None, :, None, None]
            >= lengths[:, None, None, None])
    nan_k, nan_v = (torch.where(past, float("nan"), x) for x in (k, v))
    torch.testing.assert_close(
        dec_ops.decode_attention(q, nan_k, nan_v, lengths), out, rtol=0,
        atol=0)


def _dec_ref(q, k, v, lengths):
    return decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_decode_kernel_split_edges(cuda, dt):
    """Lengths 1 and S, a length on a split boundary (nsplit whole tiles)
    and one row past it, and lengths under nsplit (CTAs of the cluster
    with no rows), on the same caches; bit-identical over two runs."""
    b, hq, hkv, s, hd = 7, 16, 2, 1024, 128
    nsplit = dec_ops.num_splits(b, hkv, s, dec_ops._sms(cuda))
    assert nsplit == 8
    edge = nsplit * dec_ops.TILE
    lengths = torch.tensor([1, s, edge, edge + 1, 3, nsplit - 1, 65],
                           dtype=torch.int32)
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(gen, (b, hq, hd), dt, cuda)
    k, v = (_randn(gen, (b, s, hkv, hd), dt, cuda) for _ in range(2))
    out = dec_ops.decode_attention(q, k, v, lengths)
    again = dec_ops.decode_attention(q, k, v, lengths)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    torch.testing.assert_close(out.float(),
                               _dec_ref(q, k, v, lengths.to(cuda)).float(),
                               **_tol(dt))


@pytest.mark.cuda
def test_decode_kernel_reads_a_layer_of_a_stacked_cache(cuda):
    """A layer of an (L, B, S, Hkv, hd) cache, as the decode step hands
    it: read in place through its strides, same result as a copy."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = _randn(gen, (4, 16, 128), torch.bfloat16, cuda)
    kv = _randn(gen, (2, 3, 4, 640, 4, 128), torch.bfloat16, cuda)
    k, v = kv[0, 2], kv[1, 2]
    lengths = torch.tensor([5, 640, 300, 129], dtype=torch.int32)
    out = dec_ops.decode_attention(q, k, v, lengths)
    torch.testing.assert_close(
        dec_ops.decode_attention(q, k.contiguous(), v.contiguous(), lengths),
        out, rtol=0, atol=0)
    torch.testing.assert_close(out.float(),
                               _dec_ref(q, k, v, lengths.to(cuda)).float(),
                               **_tol(torch.bfloat16))


@pytest.mark.cuda
def test_decode_kernel_refused_launch_raises(cuda, monkeypatch):
    """A cluster past the portable 8 CTAs (16) is refused at launch and
    raises, and nothing falls back to the plain version."""
    def no_plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(dec_ops, "decode_attention_ref", no_plain)
    monkeypatch.setattr(dec_ops, "num_splits", lambda *args: 16)
    q = torch.zeros((1, 8, 64), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 2048, 1, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        dec_ops.decode_attention(q, k, k, torch.tensor([2048]))


@pytest.mark.cuda
def test_gemma3_decode_kernel_matches_reference_impl(cuda):
    """Reduced gemma3-27b on the card (window 16, a global layer every
    2nd: G=2 against a 16-row ring cache and a 32-row one), 24 steps from
    positions (0, 5): impl="kernel" against impl="reference"."""
    import dataclasses

    from repro_torch.configs import get_config, reduce
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(reduce(get_config("gemma3_27b")),
                              sliding_window=16, global_every=2)
    assert cfg.num_heads // cfg.num_kv_heads == 2
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    b, steps = 2, 24
    toks = torch.randint(0, cfg.vocab_size, (b, steps), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    states = [tf.init_decode_state(cfg, b, 32, dtype=torch.float32,
                                   device=cuda) for _ in range(2)]
    for st in states:
        st.position = torch.tensor([0, 5])
    for t in range(steps):
        before = dec_ops.decode_attention.launches
        got, states[0] = tf.decode_step(params, cfg, toks[:, t:t + 1],
                                        states[0], impl="kernel")
        assert dec_ops.decode_attention.launches == before + cfg.num_layers
        want, states[1] = tf.decode_step(params, cfg, toks[:, t:t + 1],
                                         states[1], impl="reference")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_decode_kernel_reads_lengths_dev(cuda):
    """Lengths handed on the card as well are read in place and give the
    same output as lengths copied from the host."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, (2, 8, 64), torch.bfloat16, cuda)
    k, v = (_randn(gen, (2, 300, 2, 64), torch.bfloat16, cuda)
            for _ in range(2))
    lengths = torch.tensor([7, 300], dtype=torch.int32)
    out = dec_ops.decode_attention(q, k, v, lengths)
    torch.testing.assert_close(
        dec_ops.decode_attention(q, k, v, lengths,
                                 lengths_dev=lengths.to(cuda)),
        out, rtol=0, atol=0)
    for bad in (lengths.to(cuda).long(), lengths, lengths.to(cuda)[:1]):
        with pytest.raises(ValueError, match="lengths_dev"):
            dec_ops.decode_attention(q, k, v, lengths, lengths_dev=bad)


@pytest.mark.cuda
def test_serve_step_launches_the_decode_kernel(cuda):
    """Reduced yi-9b on the card: `make_serve_step` launches the decode
    kernel once per layer per step and matches impl="reference"."""
    from repro_torch.configs import get_config, reduce
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as tf

    cfg = reduce(get_config("yi_9b"))
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    b, steps = 3, 6
    toks = torch.randint(0, cfg.vocab_size, (b, steps), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    states = [tf.init_decode_state(cfg, b, 16, dtype=torch.float32,
                                   device=cuda) for _ in range(2)]
    for st in states:
        st.position = torch.tensor([0, 5, 2])
    serve = make_serve_step(cfg)
    for t in range(steps):
        before = dec_ops.decode_attention.launches
        got, states[0] = serve(params, toks[:, t:t + 1], states[0])
        assert dec_ops.decode_attention.launches == before + cfg.num_layers
        want, states[1] = tf.decode_step(params, cfg, toks[:, t:t + 1],
                                         states[1], impl="reference")
        torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
def test_attention_kernels_reject_bad_inputs(cuda):
    q = torch.zeros(1, 8, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, q, q)
    q32 = q.float()
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q32, q32.cpu(), q32)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(torch.zeros(1, 8, 4, 48, device=cuda),
                               torch.zeros(1, 8, 4, 48, device=cuda),
                               torch.zeros(1, 8, 4, 48, device=cuda))
    cache = torch.zeros(1, 16, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="lengths"):
        dec_ops.decode_attention(q32[:, 0], cache, cache,
                                 torch.tensor([0], device=cuda))
    with pytest.raises(ValueError, match="aligned"):
        dec_ops.decode_attention(
            q32[:, 0], torch.zeros(1, 16, 4, 66, device=cuda)[..., :64],
            cache, torch.tensor([3]))


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------

import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402

# (b, s, h, p, n, chunk, dtype): the reference kernel tests' cases, chunks
# that are not powers of two (100: a 300-token prompt over three chunks;
# 256 on 333 tokens: a padded last chunk), and the mamba2-370m and
# zamba2-1.2b prefill shapes
SSD_CASES = [
    (2, 32, 3, 8, 16, 8, torch.float32),
    (1, 64, 2, 16, 32, 16, torch.float32),
    (2, 48, 4, 8, 16, 16, torch.float32),
    (1, 40, 2, 8, 16, 16, torch.float32),
    (1, 64, 2, 64, 128, 32, torch.float32),
    (2, 32, 2, 8, 16, 8, torch.bfloat16),
    (2, 300, 3, 64, 64, 100, torch.bfloat16),
    (1, 333, 2, 16, 32, 256, torch.float32),
    (4, 2048, 32, 64, 128, 256, torch.bfloat16),
    (4, 2048, 64, 64, 64, 256, torch.bfloat16),
]


def _ssd_inputs(case, device, seed=0, extra=0):
    """x, B and C as slices of one buffer, as the model's conv output
    hands them (``extra`` more columns make its rows odd-sized); dt =
    softplus(normal), A = -exp(0.5 * normal)."""
    b, s, h, p, n, _, dt = case
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = _randn(gen, (b, s, h * p + 2 * n + extra), dt, device)
    x = buf[..., :h * p].reshape(b, s, h, p)
    B, C = buf[..., h * p:h * p + n], buf[..., h * p + n:h * p + 2 * n]
    dtv = F.softplus(torch.randn((b, s, h), generator=gen, device=device))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=device))
    return x, dtv, A, B, C


def _ssd_plain(x, dt, A, B, C, chunk):
    """The plain version in fp32 on the inputs padded by the op's rule."""
    s = x.shape[1]
    chunk = ssd_ops.chunk_for(s, chunk)
    pad = (-s) % chunk
    xs = [x.float(), dt.float(), B.float(), C.float()]
    if pad:
        xs = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in xs]
    return ssd_scan_ref(xs[0], xs[1], A.float(), xs[2], xs[3],
                        chunk=chunk)[:, :s]


def test_ssd_op_on_cpu_launches_nothing():
    x, dt, A, B, C = _ssd_inputs(SSD_CASES[3], "cpu")
    before = ssd_ops.ssd_scan.launches
    torch.testing.assert_close(ssd_ops.ssd_scan(x, dt, A, B, C, chunk=16),
                               _ssd_plain(x, dt, A, B, C, 16), rtol=0,
                               atol=0)
    assert ssd_ops.ssd_scan.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_kernel_matches_plain_version(cuda, case):
    x, dt, A, B, C = _ssd_inputs(case, cuda)
    chunk, dtype = case[5], case[6]
    before = ssd_ops.ssd_scan.launches
    out = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    torch.testing.assert_close(out.float(),
                               _ssd_plain(x, dt, A, B, C, chunk),
                               **_tol(dtype))
    # the strided views read as their contiguous copies do
    torch.testing.assert_close(
        ssd_ops.ssd_scan(x.contiguous(), dt, A, B.contiguous(),
                         C.contiguous(), chunk=chunk), out, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_reads_unaligned_rows(cuda, dtype):
    """Rows of an odd number of elements cannot be read 16 bytes at a
    time; the kernel's element-wise loads give the same result."""
    case = (2, 300, 3, 16, 32, 100, dtype)
    x, dt, A, B, C = _ssd_inputs(case, cuda, seed=4, extra=1)
    assert x.stride(1) % 2 == 1
    out = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=100)
    torch.testing.assert_close(out.float(),
                               _ssd_plain(x, dt, A, B, C, 100), **_tol(dtype))
    torch.testing.assert_close(
        ssd_ops.ssd_scan(x.contiguous(), dt, A, B.contiguous(),
                         C.contiguous(), chunk=100), out, rtol=0, atol=0)


# bf16 edges of the chunk-parallel route: head counts 3 and 5, one chunk
# (s = chunk, and s < chunk, which takes a chunk of s), chunk 100 over
# three and four chunks (the last of 30 rows), and 333 tokens at chunk 256
# (a padded last chunk of 77 rows)
SSD_EDGES = [
    (2, 512, 3, 64, 128, 256, torch.bfloat16),
    (2, 512, 5, 64, 64, 256, torch.bfloat16),
    (2, 256, 4, 64, 128, 256, torch.bfloat16),
    (2, 100, 4, 64, 64, 256, torch.bfloat16),
    (2, 300, 3, 64, 64, 100, torch.bfloat16),
    (2, 330, 3, 64, 128, 100, torch.bfloat16),
    (1, 333, 2, 64, 128, 256, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_EDGES, ids=[str(c) for c in SSD_EDGES])
def test_ssd_kernel_bf16_edges(cuda, case):
    x, dt, A, B, C = _ssd_inputs(case, cuda, seed=5)
    out = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=case[5])
    torch.testing.assert_close(out.float(),
                               _ssd_plain(x, dt, A, B, C, case[5]),
                               **_tol(case[6]))


def _row_rel_l2(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES[-2:], ids=["mamba2", "zamba2"])
def test_ssd_kernel_prefill_rows_against_fp32(cuda, case):
    """At the mamba2-370m and zamba2-1.2b prefill shapes each (token,
    head) row of the bf16 output stays within 1e-2 relative L2 of the
    plain version run in fp32 (chip_smoke's FP32_ROW_REL_TOL)."""
    x, dt, A, B, C = _ssd_inputs(case, cuda, seed=6)
    out = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=case[5])
    assert _row_rel_l2(out, _ssd_plain(x, dt, A, B, C, case[5])) < 1e-2


@pytest.mark.cuda
def test_ssd_kernel_is_deterministic(cuda):
    """Fixed orders of summation and no atomics: two runs, same bits."""
    case = SSD_CASES[-2]
    x, dt, A, B, C = _ssd_inputs(case, cuda, seed=7)
    first = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=case[5])
    torch.testing.assert_close(ssd_ops.ssd_scan(x, dt, A, B, C,
                                                chunk=case[5]),
                               first, rtol=0, atol=0)


@pytest.mark.cuda
def test_ssd_kernel_rejects_bad_inputs(cuda):
    x, dt, A, B, C = _ssd_inputs((1, 32, 2, 8, 16, 8, torch.float32), cuda)
    with pytest.raises(TypeError):
        ssd_ops.ssd_scan(x.half(), dt, A, B.half(), C.half())
    with pytest.raises(TypeError):
        ssd_ops.ssd_scan(x, dt, A, B.to(torch.bfloat16), C)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_ops.ssd_scan(x[..., :6], dt, A, B, C)
    with pytest.raises(ValueError, match="state size"):
        ssd_ops.ssd_scan(x, dt, A, B[..., :12], C[..., :12])
    with pytest.raises(ValueError, match="chunk 512"):
        ssd_ops.ssd_scan(*_ssd_inputs((1, 512, 1, 8, 16, 512,
                                       torch.float32), cuda), chunk=512)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_scan(x, dt, A, B.transpose(1, 2).contiguous()
                         .transpose(1, 2), C)
    with pytest.raises(ValueError, match="on cpu"):
        ssd_ops.ssd_scan(x, dt.cpu(), A, B, C)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_1p2b"])
def test_ssm_prefill_and_serve_step_launch_the_kernels(cuda, arch):
    """Reduced mamba2 / zamba2 on the card: the prefill step launches
    `ssd_scan` once per layer (and, for zamba2, `flash_attention` once per
    application of the shared block); the serve step launches
    `decode_attention` once per application; both match impl="reference"
    or the plain path."""
    from repro_torch.configs import get_config, reduce
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as tf

    cfg = reduce(get_config(arch))
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    apps = tf.num_shared_attn_apps(cfg)
    toks = torch.randint(0, cfg.vocab_size, (3, 40), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    before = (ssd_ops.ssd_scan.launches, fa_ops.flash_attention.launches)
    got = make_prefill_step(cfg)(params, {"tokens": toks})
    assert (ssd_ops.ssd_scan.launches - before[0],
            fa_ops.flash_attention.launches - before[1]) == (cfg.num_layers,
                                                             apps)
    want = make_prefill_step(cfg, impl="reference")(params,
                                                    {"tokens": toks[:, :32]})
    torch.testing.assert_close(
        make_prefill_step(cfg)(params, {"tokens": toks[:, :32]}), want,
        rtol=5e-4, atol=5e-4)
    assert torch.isfinite(got).all()
    st = [tf.init_decode_state(cfg, 3, 16, dtype=torch.float32, device=cuda)
          for _ in range(2)]
    serve = make_serve_step(cfg)
    for t in range(5):
        before = dec_ops.decode_attention.launches
        a, st[0] = serve(params, toks[:, t:t + 1], st[0])
        assert dec_ops.decode_attention.launches == before + apps
        b, st[1] = tf.decode_step(params, cfg, toks[:, t:t + 1], st[1],
                                  impl="reference")
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-4)


# ---------------------------------------------------------------------------
# the rest of run_fl on the card: in-cycle metrics, checkpoints, wan64
# ---------------------------------------------------------------------------


@pytest.fixture
def deterministic(cuda):
    """Deterministic algorithms in full fp32, as `run_fl` runs, restored
    afterwards."""
    from repro_torch.device import pin_fp32
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.benchmark,
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    pin_fp32(cuda)
    yield cuda
    torch.use_deterministic_algorithms(before[0], warn_only=True)
    (torch.backends.cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = before[1:]


@pytest.mark.cuda
def test_cycle_with_metrics_keeps_state_bitwise(deterministic):
    """The FEMNIST cycle on the card with `metrics=` leaves w, buffers,
    momentum and losses bit-equal to the cycle without; the count
    columns equal what the strong masks give."""
    from repro_torch.core.delay import FEMNIST
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl import dpasgd, flat as flatmod, runtime as flrt
    from repro_torch.models.small import FEMNIST_CNN
    from repro_torch.networks.registry import get_network
    from repro_torch.obs import MetricsSpec
    from repro_torch.optim import flat_sgd

    dev = deterministic
    n, r = 11, 4
    plan, _ = dpasgd.make_round_schedule("multigraph", get_network("gaia"),
                                         FEMNIST)
    params = FEMNIST_CNN.init(torch.Generator().manual_seed(0))
    rt = flrt.make_flat_runtime(plan, params, n)
    opt = flat_sgd(0.05, momentum=0.9)
    data = make_federated_dataset("femnist", n, samples_per_silo=32)
    rng = np.random.default_rng(1)
    per = [[data.sample_batch(s, 8, rng) for s in range(n)]
           for _ in range(r)]
    batches = {k: torch.as_tensor(np.stack([[np.stack([b[k] for b in p])]
                                            for p in per]), device=dev)
               for k in ("x", "y")}
    batches["y"] = batches["y"].long()
    args = [torch.as_tensor(getattr(rt, k)[:r], device=dev)
            for k in ("strong", "coeffs", "diag")]
    w0 = flatmod.ravel(rt.spec, params).to(dev)
    outs = [flrt.make_cycle_fn(rt, loss_fn=FEMNIST_CNN.loss, opt=opt,
                               metrics=ms)(
        flrt.init_flat_state(w0, opt, rt), batches, *args)
        for ms in (None, MetricsSpec())]
    (off, loss_off), (on, loss_on, mets) = outs
    for a, b in ((on.w, off.w), (on.buffers, off.buffers),
                 (on.opt_state["mu"], off.opt_state["mu"]),
                 (loss_on, loss_off)):
        assert torch.equal(a, b)
    mets = mets.cpu().numpy()
    assert mets.shape == (r, 17) and np.isfinite(mets).all()
    n_strong = rt.strong[:r].sum(axis=1).astype(np.float32)
    e2 = np.float32(rt.strong.shape[1])
    np.testing.assert_array_equal(mets[:, 14], np.float32(1) - n_strong / e2)
    np.testing.assert_array_equal(mets[:, 16],
                                  n_strong * np.float32(rt.spec.size * 4))


@pytest.mark.cuda
def test_checkpoint_from_card_tensors_restores_bitwise(cuda, tmp_path):
    """Rows and a bf16 leaf on the card are written once to the host and
    restore bit for bit; the bytes equal those written from host copies."""
    from repro_torch.checkpoint import (CheckpointManager, load_fl_checkpoint,
                                        restore_pytree, save_fl_checkpoint,
                                        save_pytree)
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn((11, 1_280_478), generator=gen, device=cuda)
    save_fl_checkpoint(CheckpointManager(tmp_path / "card"), 15, w, round=15)
    save_fl_checkpoint(CheckpointManager(tmp_path / "host"), 15, w.cpu(),
                       round=15)
    assert (tmp_path / "card" / "step_15.msgpack").read_bytes() == \
        (tmp_path / "host" / "step_15.msgpack").read_bytes()
    got = load_fl_checkpoint(tmp_path / "card")
    assert torch.equal(torch.from_numpy(got.w.copy()).to(cuda), w)
    b = torch.randn((7, 33), generator=gen, device=cuda).to(torch.bfloat16)
    save_pytree(tmp_path / "bf16.msgpack", {"b": b, "s": b[:, ::2]})
    back = restore_pytree(tmp_path / "bf16.msgpack")
    assert back["b"].dtype == torch.bfloat16
    assert torch.equal(back["b"].to(cuda), b)
    assert torch.equal(back["s"].to(cuda), b[:, ::2])


@pytest.mark.cuda
def test_kernel_equals_plain_version_on_wan64(cuda):
    """`edge_aggregate` at the wan64 multigraph's shape (N = 64, 2E =
    128, FEMNIST's T)."""
    from repro_torch.core.delay import FEMNIST
    from repro_torch.fl.dpasgd import make_round_schedule
    from repro_torch.networks.registry import get_network

    plan, _ = make_round_schedule("multigraph", get_network("wan64"),
                                  FEMNIST)
    n, e2 = 64, len(plan.dst)
    assert e2 == 128
    order, row_ptr = ops.csr_sort(plan.dst, n)
    gen = torch.Generator(device=cuda).manual_seed(4)
    k = 1 % plan.num_rounds_cycle
    args = (torch.randn((n, 1_280_478), generator=gen, device=cuda),
            torch.randn((e2, 1_280_478), generator=gen, device=cuda),
            torch.as_tensor(plan.coeffs[k][order], device=cuda),
            torch.as_tensor(row_ptr, device=cuda),
            torch.as_tensor(plan.diag[k], device=cuda))
    before = ops.edge_aggregate.launches
    out = ops.edge_aggregate(*args)
    torch.cuda.synchronize()
    assert ops.edge_aggregate.launches == before + 1
    assert torch.equal(out, edge_aggregate_ref(*args))


@pytest.mark.cuda
def test_frontier_candidate_equals_run_fl_on_card(cuda):
    """One `evaluate_frontier` candidate on the card (Algorithm 1's t = 3
    vector on gaia, 6 rounds) equals `evaluate_design`, i.e. `run_fl` of
    the same vector, bit for bit in every field but the host seconds,
    with one `edge_aggregate` launch a round. Deterministic algorithms
    are on for both runs, as in the smoke's FL phases."""
    import dataclasses
    from repro_torch.core.delay import FEMNIST
    from repro_torch.core.multigraph import build_multigraph
    from repro_torch.design import evaluate
    from repro_torch.design.catalog import ring_topology
    from repro_torch.networks.registry import get_network

    gaia = get_network("gaia")
    overlay = ring_topology(gaia, FEMNIST).graph
    mg = build_multigraph(gaia, FEMNIST, overlay, t=3)
    vec = tuple(int(mg.multiplicity[p]) for p in overlay.pairs)
    kw = dict(rounds=6, samples_per_silo=32, batch_size=8, seed=3)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        before = ops.edge_aggregate.launches
        got = evaluate.evaluate_frontier("gaia", "femnist", [("t3", vec)],
                                         device=cuda, **kw)[0]
        assert ops.edge_aggregate.launches == before + kw["rounds"]
        one = evaluate.evaluate_design("gaia", "femnist", multiplicity=vec,
                                       name="t3", device=cuda, **kw)
    finally:
        torch.use_deterministic_algorithms(was)
    assert dataclasses.replace(one, train_s=0.0) == \
        dataclasses.replace(got, train_s=0.0)
    assert np.isfinite(got.final_loss)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi_9b", "zamba2_1p2b"])
def test_decode_step_reads_positions_on_the_card(cuda, arch):
    """Per-slot positions kept on the card (`device_positions=True`, the
    captured step's path: indices derived there, lengths unchecked on the
    host) give the same logits bit for bit as the same positions read on
    the host."""
    from repro_torch.configs import get_config, reduce
    from repro_torch.models import transformer as tf
    cfg = reduce(get_config(arch))
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    states = [tf.init_decode_state(cfg, 3, 32, dtype=torch.float32,
                                   device=cuda) for _ in range(2)]
    pos = torch.tensor([0, 4, 9])
    tokens = torch.tensor([[3], [7], [11]], device=cuda)
    for _ in range(5):
        states[0].position, states[1].position = pos, pos.to(cuda)
        a, _ = tf.decode_step(params, cfg, tokens, states[0], impl="kernel")
        b, _ = tf.decode_step(params, cfg, tokens, states[1], impl="kernel",
                              device_positions=True)
        assert torch.equal(a, b)
        pos = pos + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi_9b", "zamba2_1p2b"])
def test_captured_engine_matches_eager(cuda, arch):
    """The serving engine's captured step gives the eager engine's tokens
    (more requests than slots, so slots are reused under the live graph),
    and again after a `reset()`, which zeroes the caches in place: one
    capture, the same cache addresses."""
    from repro_torch.configs import get_config, reduce
    from repro_torch.models import transformer as tf
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.engine import _cache_leaves
    cfg = reduce(get_config(arch))
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (3, 9, 5, 12, 7, 4)]

    def serve(engine):
        reqs = [Request(prompt=list(p), max_new_tokens=6) for p in prompts]
        for r in reqs:
            engine.submit(r)
        engine.run()
        return [r.output for r in reqs]

    kw = dict(max_slots=4, max_seq=32, device=cuda)
    eager = ServingEngine(cfg, params, cuda_graph=False, **kw)
    graph = ServingEngine(cfg, params, **kw)
    want = serve(eager)
    assert serve(graph) == want
    ptrs = [a.data_ptr() for a in _cache_leaves(graph.caches)]
    graph.reset()
    assert all(not a.any() for a in _cache_leaves(graph.caches))
    assert serve(graph) == want
    assert (graph.captures, eager.captures) == (1, 0)
    assert [a.data_ptr() for a in _cache_leaves(graph.caches)] == ptrs


@pytest.mark.cuda
def test_moe_is_bit_equal_across_runs(cuda):
    """The MoE layer's gather dispatch at granite-moe's full width (32
    experts, top-8, bf16, 4 rows of 512 tokens): two runs on the card
    give the same output bit for bit (no atomics: each token's k slots
    are summed in a fixed order); in fp32 it computes the dense oracle's
    function when nothing drops (in bf16 the two round sums of outputs
    near 100 apart: the experts' 1/sqrt(E) init scale)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("granite_moe_1b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.moe_init(gen, cfg, torch.bfloat16, device=cuda)
    x = torch.randn((4, 512, cfg.d_model), generator=gen,
                    device=cuda).to(torch.bfloat16)
    a, aux_a = moe.moe(p, cfg, x)
    b, aux_b = moe.moe(p, cfg, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    p32 = {k: v.float() for k, v in p.items()}
    x32 = x[:1].float()
    full, _ = moe.moe(p32, cfg, x32, capacity_factor=cfg.num_experts
                      / cfg.experts_per_token)
    dense, _ = moe.moe(p32, cfg, x32, impl="dense")
    torch.testing.assert_close(full, dense, rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
def test_gemma3_prefill_kernel_matches_reference_impl(cuda):
    """Reduced gemma3-27b on the card (window 16, a global layer every
    2nd; 40 tokens, so the local layer's window binds): the prefill step
    through the flash kernel, one launch a layer with the layer's own
    window, against impl="reference" within 5e-4."""
    import dataclasses

    from repro_torch.configs import get_config, reduce
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(reduce(get_config("gemma3_27b")),
                              sliding_window=16, global_every=2)
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (3, 40), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    before = fa.flash_attention.launches
    got = make_prefill_step(cfg, impl="kernel")(params, {"tokens": toks})
    assert fa.flash_attention.launches - before == cfg.num_layers
    want = make_prefill_step(cfg, impl="reference")(params, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
def test_fl_round_step_kernel_equals_plain_aggregation(deterministic,
                                                       monkeypatch):
    """Two rounds of `fl_round_step` over reduced mamba2-370m on 4 gaia
    silos (the LLM trainer's round): through the fused `edge_aggregate`
    kernel, one launch a round for all leaves, bit-equal to the same
    rounds refreshed and aggregated by the plain version."""
    from repro_torch.configs import get_config, reduce
    from repro_torch.core.delay import FEMNIST
    from repro_torch.fl import dpasgd
    from repro_torch.kernels.gossip_combine.ref import refresh_aggregate_ref
    from repro_torch.launch import train
    from repro_torch.launch.mesh import tree_leaves
    from repro_torch.models import transformer as tf
    from repro_torch.optim import sgd

    cuda = deterministic
    cfg = reduce(get_config("mamba2-370m"))
    net = train._sub_network(train.get_network("gaia"), 4)
    plan, _ = dpasgd.make_round_schedule("multigraph", net, FEMNIST)
    pt = {k: torch.as_tensor(getattr(plan, k), device=cuda)
          for k in ("strong", "coeffs", "diag")}
    toks = torch.randint(0, cfg.vocab_size, (2, 1, 4, 2, 33), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))

    def loss_fn(p, batch):
        return tf.loss_fn(p, cfg, batch)[0]

    def run():
        opt = sgd(3e-3, momentum=0.9)
        params = train.initial_params(cfg, 0, cuda)
        state = dpasgd.init_fl_state(params, opt, 4, plan.src)
        losses = []
        for k in range(2):
            pk = k % plan.num_rounds_cycle
            state, loss = dpasgd.fl_round_step(
                state, {"tokens": toks[k, ..., :-1],
                        "labels": toks[k, ..., 1:]},
                plan.src, plan.dst, pt["strong"][pk], pt["coeffs"][pk],
                pt["diag"][pk], loss_fn=loss_fn, opt=opt, local_updates=1)
            losses.append(float(loss))
        return state, losses

    before = ops.edge_aggregate.launches
    kernel, kl = run()
    assert len(tree_leaves(kernel.silo_params)) > 1
    assert ops.edge_aggregate.launches - before == 2
    monkeypatch.setattr(dpasgd, "refresh_aggregate", refresh_aggregate_ref)
    plain, pl = run()
    assert kl == pl
    for a, b in zip(tree_leaves(kernel.silo_params),
                    tree_leaves(plain.silo_params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(kernel.buffers), tree_leaves(plain.buffers)):
        assert torch.equal(a, b)
