"""The moe, vlm and audio families and gemma3's mixed local/global stack
in the port's model assembler (`repro_torch.models.transformer`) against
`repro.models.transformer`, on reduced configs (`configs.reduce`: 2
layers, fp32) with the reference's weights carried across by
`params_from_reference`: granite-moe and phi3.5-moe (4 experts, top-2),
paligemma (a bidirectional 8-token image prefix, MQA, hd 32), musicgen
(untied unembedding, a causal 8-token audio prefix) and gemma3 (window
16, a global layer every 2nd). The prefix arrays are the reference's
`synthetic_prefix`, fed to both sides.

fp32 within 5e-4 (rtol and atol), as the reference's own model tests.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import frontends as rfe  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402

from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.models import frontends as pfe  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from _torch_fl_parity import one_thread  # noqa: E402,F401

ARCHS = ["granite_moe_1b", "phi3p5_moe", "paligemma_3b", "musicgen_large",
         "gemma3_27b"]


def F32(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4, err_msg=msg)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    rcfg = rconfigs.reduce(rconfigs.get_config(arch))
    pcfg = pconfigs.reduce(pconfigs.get_config(arch))
    rparams = rtf.init_params(rcfg, jax.random.PRNGKey(4))
    pparams = ptf.params_from_reference(jax.device_get(rparams))
    return rcfg, pcfg, rparams, pparams


def _rforward(rcfg, **kw):
    """The reference's `forward`, compiled once per config and options."""
    return jax.jit(lambda p, t, pre: rtf.forward(p, rcfg, t,
                                                 prefix_embeds=pre, **kw))


def _inputs(cfg, b=2, s=24, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    pre = None
    if cfg.frontend != "none":
        pre = np.asarray(rfe.synthetic_prefix(cfg, b, seed=seed))
    return toks, pre


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("impl", ["reference", "chunked", "kernel"])
def test_forward_matches_reference(model, impl):
    """Logits and the aux loss for every impl against the reference's
    plain path; the moe families' aux is non-zero, the others' zero; on
    the CPU the kernel path launches nothing."""
    rcfg, pcfg, rparams, pparams = model
    toks, pre = _inputs(pcfg)
    want, want_aux = _rforward(rcfg)(rparams, _j(toks), _j(pre))
    before = fa_ops.flash_attention.launches
    got, aux = ptf.forward(pparams, pcfg, _t(toks), prefix_embeds=_t(pre),
                           impl=impl)
    assert fa_ops.flash_attention.launches == before
    p = 0 if pre is None else pre.shape[1]
    assert tuple(got.shape) == (2, p + 24, pcfg.vocab_size)
    F32(_np(got), _np(want))
    F32(float(aux), float(want_aux))
    assert (float(aux) > 0) == (pcfg.family == "moe")


@pytest.mark.parametrize("arch", ["granite_moe_1b", "phi3p5_moe"])
def test_moe_dense_dispatch_matches_reference(arch):
    rcfg = rconfigs.reduce(rconfigs.get_config(arch))
    pcfg = pconfigs.reduce(pconfigs.get_config(arch))
    rparams = rtf.init_params(rcfg, jax.random.PRNGKey(7))
    pparams = ptf.params_from_reference(jax.device_get(rparams))
    toks, _ = _inputs(pcfg)
    want, want_aux = _rforward(rcfg, moe_impl="dense")(rparams, _j(toks),
                                                       None)
    got, aux = ptf.forward(pparams, pcfg, _t(toks), moe_impl="dense")
    F32(_np(got), _np(want))
    F32(float(aux), float(want_aux))


def test_prefix_masks():
    """vlm's prefix is bidirectional (an early prefix row sees a later
    one), audio's stays causal (it does not)."""
    for arch, sees in (("paligemma_3b", True), ("musicgen_large", False)):
        cfg = pconfigs.reduce(pconfigs.get_config(arch))
        params = ptf.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        toks = torch.zeros(1, 4, dtype=torch.long)
        pre = pfe.synthetic_prefix(cfg, 1, seed=0, device="cpu")
        base, _ = ptf.forward(params, cfg, toks, prefix_embeds=pre)
        moved = pre.clone()
        moved[:, -1] += 1.0
        out, _ = ptf.forward(params, cfg, toks, prefix_embeds=moved)
        assert bool((out[:, 0] != base[:, 0]).any()) == sees, arch


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_prefill_step_matches_reference(model, impl):
    rcfg, pcfg, rparams, pparams = model
    toks, pre = _inputs(pcfg, b=3, s=20, seed=2)
    rb = {"tokens": _j(toks)}
    pb = {"tokens": _t(toks)}
    if pre is not None:
        rb["prefix_embeds"], pb["prefix_embeds"] = _j(pre), _t(pre)
    want = jax.jit(rsteps.make_prefill_step(rcfg, impl="reference"))(
        rparams, rb)
    got = psteps.make_prefill_step(pcfg, impl=impl)(pparams, pb)
    assert tuple(got.shape) == (3, pcfg.vocab_size)
    F32(_np(got), _np(want))


def test_decode_matches_reference(model):
    """`init_decode_state` and 20 `decode_step`s from per-slot positions
    (0, 3, 9) in a 24-row cache (gemma3's local ring of 16 wraps), every
    impl, against the reference's `decode_step`; the caches' layout and
    the final caches equal."""
    rcfg, pcfg, rparams, pparams = model
    b, steps, max_seq = 3, 20, 24
    toks = np.random.default_rng(3).integers(0, pcfg.vocab_size, (b, steps))
    pos0 = np.array([0, 3, 9])
    rst = rtf.init_decode_state(rcfg, b, max_seq, dtype=jnp.float32)
    rst.position = jnp.asarray(pos0, jnp.int32)
    pst = {i: ptf.init_decode_state(pcfg, b, max_seq, dtype=torch.float32,
                                    device="cpu")
           for i in ("reference", "kernel")}
    for st in pst.values():
        assert [tuple(g["k"].shape) for g in st.caches["kv"]] == \
            [g["k"].shape for g in rst.caches["kv"]]
        st.position = torch.from_numpy(pos0)
    before = dec_ops.decode_attention.launches
    rdecode = jax.jit(lambda p, t, st: rtf.decode_step(p, rcfg, t, st))
    for t in range(steps):
        want, rst = rdecode(rparams, _j(toks[:, t:t + 1]), rst)
        for i, st in pst.items():
            got, pst[i] = ptf.decode_step(pparams, pcfg,
                                          _t(toks[:, t:t + 1]), st, impl=i)
            assert tuple(got.shape) == (b, 1, pcfg.vocab_size)
            F32(_np(got), _np(want), f"step {t}, impl {i}")
    assert dec_ops.decode_attention.launches == before  # CPU
    for g, rg in zip(pst["kernel"].caches["kv"], rst.caches["kv"]):
        F32(_np(g["k"]), _np(rg["k"]))
        F32(_np(g["v"]), _np(rg["v"]))


def test_serve_step_matches_reference(model):
    rcfg, pcfg, rparams, pparams = model
    toks = np.random.default_rng(6).integers(0, pcfg.vocab_size, (2, 4))
    rst = rtf.init_decode_state(rcfg, 2, 8, dtype=jnp.float32)
    pst = ptf.init_decode_state(pcfg, 2, 8, dtype=torch.float32,
                                device="cpu")
    rstep = jax.jit(rsteps.make_serve_step(rcfg))
    pstep = psteps.make_serve_step(pcfg)
    for t in range(4):
        want, rst = rstep(rparams, _j(toks[:, t:t + 1]), rst)
        got, pst = pstep(pparams, _t(toks[:, t:t + 1]), pst)
        F32(_np(got), _np(want), f"step {t}")


@pytest.mark.parametrize("arch", ["paligemma_3b", "musicgen_large"])
def test_synthetic_prefix_shape_and_unit_rows(arch):
    rcfg = rconfigs.reduce(rconfigs.get_config(arch))
    cfg = pconfigs.reduce(pconfigs.get_config(arch))
    x = pfe.synthetic_prefix(cfg, 3, seed=5, device="cpu")
    want = rfe.synthetic_prefix(rcfg, 3, seed=5)
    assert tuple(x.shape) == want.shape == pfe.prefix_shape(cfg, 3)
    assert str(x.dtype).split(".")[-1] == want.dtype.name
    np.testing.assert_allclose(torch.linalg.vector_norm(x, dim=-1).numpy(),
                               1.0, rtol=1e-6)
    assert torch.equal(x, pfe.synthetic_prefix(cfg, 3, seed=5, device="cpu"))
    assert not torch.equal(x, pfe.synthetic_prefix(cfg, 3, seed=6,
                                                   device="cpu"))
    full = pconfigs.get_config(arch)
    assert pfe.prefix_tokens(full) == rfe.prefix_tokens(
        rconfigs.get_config(arch)) == (256 if arch == "paligemma_3b" else 64)
    assert pfe.prefix_tokens(pconfigs.get_config("yi_9b")) == 0
