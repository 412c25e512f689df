"""The port's dense-family serving forward (prefill and KV-cache decode)
against `repro.models.transformer` and `repro.launch.steps`, on reduced
yi-9b (`reduce(get_config("yi_9b"))`, f32), with the reference's weights
carried across by `params_from_reference`.

Tolerance 5e-4 (rtol and atol) in f32, as the reference's own
kernel-path model tests use: the online-softmax paths reorder sums. In
bf16, 2e-2 of the logits' scale (max |diff| <= 2e-2 * max |logit|): XLA
fuses elementwise chains and rounds once where PyTorch rounds after every
op, so logits near zero differ by a few bf16 ulps of their larger
neighbours (up to 0.035 at a scale of about 4, two layers deep).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402

from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402


def F32(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4,
                               err_msg=msg)


def BF16(got, want, msg=""):
    err = float(np.abs(got - want).max())
    assert err <= 2e-2 * float(np.abs(want).max()), (msg, err)


def _cfgs(arch="yi_9b", **kw):
    r = dataclasses.replace(rconfigs.reduce(rconfigs.get_config(arch)), **kw)
    p = dataclasses.replace(pconfigs.reduce(pconfigs.get_config(arch)), **kw)
    return r, p


def _setup(arch="yi_9b", seed=0, **kw):
    rcfg, pcfg = _cfgs(arch, **kw)
    rparams = rtf.init_params(rcfg, jax.random.PRNGKey(seed))
    pparams = ptf.params_from_reference(jax.device_get(rparams))
    return rcfg, pcfg, rparams, pparams


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.fixture(scope="module")
def yi():
    return _setup()


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("impl", ["reference", "chunked", "kernel"])
def test_forward_matches_reference(yi, impl):
    rcfg, pcfg, rparams, pparams = yi
    toks = _tokens(pcfg, (2, 40))
    want, _ = rtf.forward(rparams, rcfg, jnp.asarray(toks), impl="reference")
    got, aux = ptf.forward(pparams, pcfg, torch.from_numpy(toks), impl=impl)
    assert tuple(got.shape) == (2, 40, pcfg.vocab_size)
    assert float(aux) == 0.0
    F32(_np(got), _np(want))


def test_forward_kernel_on_cpu_launches_nothing(yi):
    _, pcfg, _, pparams = yi
    before = fa_ops.flash_attention.launches
    ptf.forward(pparams, pcfg, torch.from_numpy(_tokens(pcfg, (1, 9))),
                impl="kernel")
    assert fa_ops.flash_attention.launches == before


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_prefill_step_matches_reference(yi, impl):
    rcfg, pcfg, rparams, pparams = yi
    toks = _tokens(pcfg, (3, 33), seed=2)
    want = rsteps.make_prefill_step(rcfg, impl="reference")(
        rparams, {"tokens": jnp.asarray(toks)})
    got = psteps.make_prefill_step(pcfg, impl=impl)(
        pparams, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == (3, pcfg.vocab_size)
    F32(_np(got), _np(want))


def _decode_both(rcfg, pcfg, rparams, pparams, toks, positions, max_seq,
                 rimpls=("reference", "pallas"), pimpls=("reference",
                                                         "kernel"),
                 dtype="float32", tol=F32):
    """Step both packages through the same tokens from the same (B,)
    start positions; compare logits at every step."""
    b, steps = toks.shape
    rstates = {i: rtf.init_decode_state(rcfg, b, max_seq,
                                        dtype=getattr(jnp, dtype))
               for i in rimpls}
    pstates = {i: ptf.init_decode_state(pcfg, b, max_seq,
                                        dtype=getattr(torch, dtype),
                                        device="cpu") for i in pimpls}
    pos0 = np.asarray(positions)
    for i in rimpls:
        rstates[i].position = jnp.asarray(pos0, jnp.int32)
    for i in pimpls:
        pstates[i].position = torch.from_numpy(pos0)
    for t in range(steps):
        tj, tt = jnp.asarray(toks[:, t:t + 1]), torch.from_numpy(
            toks[:, t:t + 1])
        rl = {}
        for i in rimpls:
            rl[i], rstates[i] = rtf.decode_step(rparams, rcfg, tj,
                                                rstates[i], impl=i)
        want = _np(rl[rimpls[0]])
        for i in rimpls[1:]:
            tol(_np(rl[i]), want)
        for i in pimpls:
            got, pstates[i] = ptf.decode_step(pparams, pcfg, tt, pstates[i],
                                              impl=i)
            assert tuple(got.shape) == (b, 1, pcfg.vocab_size)
            tol(_np(got), want, f"step {t}, impl {i}")
    for i in pimpls:
        np.testing.assert_array_equal(pstates[i].position.numpy(),
                                      pos0 + steps)
    return rstates, pstates


def test_decode_step_per_slot_positions(yi):
    rcfg, pcfg, rparams, pparams = yi
    before = dec_ops.decode_attention.launches
    _decode_both(rcfg, pcfg, rparams, pparams,
                 _tokens(pcfg, (3, 6), seed=3), [0, 2, 5], max_seq=16)
    assert dec_ops.decode_attention.launches == before  # CPU


def test_decode_step_scalar_position_and_kv_cache(yi):
    rcfg, pcfg, rparams, pparams = yi
    rst, pst = _decode_both(rcfg, pcfg, rparams, pparams,
                            _tokens(pcfg, (2, 5), seed=4), 0, max_seq=8)
    # the in-place cache holds what the reference's functional one does
    for i in ("reference", "kernel"):
        for kv in ("k", "v"):
            F32(_np(pst[i].caches["kv"][0][kv]),
                _np(rst["reference"].caches["kv"][0][kv]))


def test_serve_step_decodes_through_the_kernel_path(yi):
    """`make_serve_step` decodes with DEFAULT_IMPL ("kernel"; its plain
    version on the CPU) and matches the reference's serve step."""
    rcfg, pcfg, rparams, pparams = yi
    assert psteps.DEFAULT_IMPL == "kernel"
    toks = _tokens(pcfg, (3, 5), seed=9)
    pos0 = np.array([0, 4, 1])
    rst = rtf.init_decode_state(rcfg, 3, 16, dtype=jnp.float32)
    rst.position = jnp.asarray(pos0, jnp.int32)
    pst, kst = (ptf.init_decode_state(pcfg, 3, 16, dtype=torch.float32,
                                      device="cpu") for _ in range(2))
    pst.position = kst.position = torch.from_numpy(pos0)
    rstep, pstep = rsteps.make_serve_step(rcfg), psteps.make_serve_step(pcfg)
    before = dec_ops.decode_attention.launches
    for t in range(toks.shape[1]):
        tt = torch.from_numpy(toks[:, t:t + 1])
        want, rst = rstep(rparams, jnp.asarray(toks[:, t:t + 1]), rst)
        got, pst = pstep(pparams, tt, pst)
        same, kst = ptf.decode_step(pparams, pcfg, tt, kst, impl="kernel")
        F32(_np(got), _np(want), f"step {t}")
        torch.testing.assert_close(got, same, rtol=0, atol=0)
    assert dec_ops.decode_attention.launches == before  # CPU
    np.testing.assert_array_equal(pst.position.numpy(), pos0 + 5)


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_module_decode_attention_matches_reference(yi, window,
                                                   with_lengths):
    """`models.attention.decode_attention` (one token at a scalar
    position, optional window and lengths) against the reference's."""
    rcfg, pcfg, rparams, pparams = yi
    rp = {k: v[0] for k, v in rparams["blocks"]["attn"].items()}
    pp = {k: v[0] for k, v in pparams["blocks"]["attn"].items()}
    rng = np.random.default_rng(10)
    b, s, position = 2, 12, 7
    x = rng.standard_normal((b, 1, pcfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, s, pcfg.num_kv_heads, pcfg.head_dim))
              .astype(np.float32) for _ in range(2))
    lengths = np.array([5, 8], np.int32) if with_lengths else None
    want = rattn.decode_attention(
        rp, rcfg, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        position, window=window,
        lengths=None if lengths is None else jnp.asarray(lengths))
    pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = pattn.decode_attention(
        pp, pcfg, torch.from_numpy(x), pk, pv, position, window=window,
        lengths=None if lengths is None else torch.from_numpy(lengths))
    assert got[1] is pk and got[2] is pv  # written in place
    for g, w in zip(got, want):
        F32(_np(g), _np(w))


def test_decode_ring_buffer_wraps():
    """sliding_window=8 at max_seq=16: an 8-row ring buffer, 12 steps."""
    rcfg, pcfg, rparams, pparams = _setup(sliding_window=8)
    assert ptf.kv_group_spec(pcfg, 16) == rtf.kv_group_spec(rcfg, 16) == \
        [(tuple(range(pcfg.num_layers)), 8, 8)]
    _decode_both(rcfg, pcfg, rparams, pparams,
                 _tokens(pcfg, (2, 12), seed=5), [0, 3], max_seq=16)


def test_gemma3_decode_matches_reference():
    """Reduced gemma3-27b (window 16, a global layer every 2nd): 24 steps
    from positions (0, 5) in a 32-slot cache, so the local layers' 16-row
    ring buffers wrap while the global layers' caches fill, against the
    reference's `decode_step`; max |logit difference| <= 1e-4."""
    rcfg, pcfg, rparams, pparams = _setup("gemma3_27b", seed=11,
                                          sliding_window=16, global_every=2)
    assert [g[1:] for g in ptf.kv_group_spec(pcfg, 32)] == \
        [g[1:] for g in rtf.kv_group_spec(rcfg, 32)] == [(16, 16), (32, 0)]

    def within_1e4(got, want, msg=""):
        err = float(np.abs(got - want).max())
        assert err <= 1e-4, (msg, err)

    before = dec_ops.decode_attention.launches
    _decode_both(rcfg, pcfg, rparams, pparams,
                 _tokens(pcfg, (2, 24), seed=12), [0, 5], max_seq=32,
                 rimpls=("reference",), tol=within_1e4)
    assert dec_ops.decode_attention.launches == before  # CPU


def test_qkv_bias_variant():
    """Reduced qwen2-7b (biased q/k/v projections), prefill and decode."""
    rcfg, pcfg, rparams, pparams = _setup("qwen2_7b", seed=3)
    assert pcfg.qkv_bias and "bq" in pparams["blocks"]["attn"]
    # non-zero biases, so they count
    rng = np.random.default_rng(6)
    for name in ("bq", "bk", "bv"):
        val = rng.standard_normal(
            rparams["blocks"]["attn"][name].shape).astype(np.float32) * 0.5
        rparams["blocks"]["attn"][name] = jnp.asarray(val)
        pparams["blocks"]["attn"][name] = torch.from_numpy(val)
    toks = _tokens(pcfg, (2, 24), seed=7)
    want, _ = rtf.forward(rparams, rcfg, jnp.asarray(toks))
    for impl in ("reference", "kernel"):
        got, _ = ptf.forward(pparams, pcfg, torch.from_numpy(toks),
                             impl=impl)
        F32(_np(got), _np(want))
    _decode_both(rcfg, pcfg, rparams, pparams, toks[:, :4], [1, 0],
                 max_seq=8)


def test_bf16_forward_and_decode():
    rcfg, pcfg, rparams, pparams = _setup(dtype="bfloat16")
    assert pparams["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    toks = _tokens(pcfg, (2, 24), seed=8)
    want, _ = rtf.forward(rparams, rcfg, jnp.asarray(toks))
    for impl in ("reference", "kernel"):
        got, _ = ptf.forward(pparams, pcfg, torch.from_numpy(toks),
                             impl=impl)
        assert got.dtype == torch.bfloat16
        BF16(_np(got), _np(want))
    _decode_both(rcfg, pcfg, rparams, pparams, toks[:, :4], [0, 2],
                 max_seq=8, rimpls=("reference",), dtype="bfloat16",
                 tol=BF16)


def test_params_from_reference_keeps_the_leaves(yi):
    _, _, rparams, pparams = yi

    def walk(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k])
        else:
            yield tree

    rleaves = jax.tree.leaves(rparams)
    pleaves = list(walk(pparams))
    assert len(pleaves) == len(rleaves)
    for p, r in zip(pleaves, rleaves):
        r = np.asarray(r)
        assert tuple(p.shape) == r.shape
        np.testing.assert_array_equal(p.numpy(), r)
    for dt in ("bfloat16",):
        _, _, rp, pp = _setup(dtype=dt)
        for p, r in zip(walk(pp), jax.tree.leaves(rp)):
            assert p.dtype == getattr(torch, dt) or p.dtype == torch.float32
            np.testing.assert_array_equal(
                p.view(torch.int16).numpy() if p.dtype == torch.bfloat16
                else p.numpy(),
                np.asarray(r).view(np.int16) if p.dtype == torch.bfloat16
                else np.asarray(r))


def test_init_params_distribution_and_layout():
    _, pcfg = _cfgs()
    p = ptf.init_params(pcfg, torch.Generator().manual_seed(0), device="cpu")
    r = jax.device_get(rtf.init_params(_cfgs()[0], jax.random.PRNGKey(0)))
    pl, rl = [], []

    def walk(pt, rt, path=""):
        assert sorted(pt) == sorted(rt), path
        for k in sorted(pt):
            if isinstance(pt[k], dict):
                walk(pt[k], rt[k], f"{path}/{k}")
            else:
                pl.append((f"{path}/{k}", pt[k]))
                rl.append(np.asarray(rt[k]))

    walk(p, r)
    for (name, a), b in zip(pl, rl):
        assert tuple(a.shape) == b.shape, name
        assert str(a.dtype).split(".")[-1] == b.dtype.name, name
        if b.std() > 0:
            np.testing.assert_allclose(float(a.float().std()),
                                       float(b.std()), rtol=0.1,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="generator"):
        ptf.init_params(pcfg, torch.Generator(), device="meta")


@pytest.mark.parametrize("arch", ["granite_moe_1b", "paligemma_3b",
                                  "musicgen_large"])
def test_other_families_raise(arch):
    cfg = pconfigs.reduce(pconfigs.get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ptf.init_params(cfg, torch.Generator(), device="cpu")


def test_mixed_window_stack_raises():
    _, pcfg = _cfgs("gemma3_27b")
    params = ptf.init_params(dataclasses.replace(pcfg, global_every=0),
                             torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="_dyn_window_block"):
        ptf.forward(params, pcfg, torch.zeros(1, 4, dtype=torch.long))


def test_unknown_impl_raises(yi):
    _, pcfg, _, pparams = yi
    with pytest.raises(ValueError, match="unknown attention impl"):
        ptf.forward(pparams, pcfg, torch.zeros(1, 4, dtype=torch.long),
                    impl="pallas")
