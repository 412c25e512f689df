"""The port's ssm and hybrid serving forward (prefill and recurrent
decode) against `repro.models.transformer` and `repro.launch.steps`, on
reduced mamba2-370m, reduced zamba2-1.2b (`attn_every=1`: the shared
block after each of the 2 layers) and a 3-layer zamba2 at `attn_every=2`
(one application, then a tail layer without it), f32, with the
reference's weights carried across by `params_from_reference`.

Tolerance 5e-4 (rtol and atol) in f32, as the reference's own
kernel-path model tests use. In bf16, a share of the logits' scale (XLA
rounds fused elementwise chains once where PyTorch rounds after each op):
2e-2 for mamba2, as for the dense family; 4e-2 for the hybrid, whose bf16
logits each lie about 2e-2 of their scale from the same weights run in
f32, in different directions. The bf16 test also holds that the port's
bf16 logits are no farther from that f32 run than 1.5 times the
reference's are.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402

from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402

MODELS = {
    "mamba2": ("mamba2_370m", {}),
    "zamba2": ("zamba2_1p2b", {}),
    "zamba2-tail": ("zamba2_1p2b", dict(num_layers=3, attn_every=2)),
}


def F32(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4,
                               err_msg=msg)


def BF16(got, want, msg="", share=2e-2):
    err = float(np.abs(got - want).max())
    assert err <= share * float(np.abs(want).max()), (msg, err)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _setup(name, seed=0, **extra):
    arch, kw = MODELS[name]
    kw = dict(kw, **extra)
    rcfg = dataclasses.replace(rconfigs.reduce(rconfigs.get_config(arch)),
                               **kw)
    pcfg = dataclasses.replace(pconfigs.reduce(pconfigs.get_config(arch)),
                               **kw)
    rparams = rtf.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, pcfg, rparams, ptf.params_from_reference(
        jax.device_get(rparams))


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    return _setup(request.param)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _fp32(params):
    if isinstance(params, dict):
        return {k: _fp32(v) for k, v in params.items()}
    return params.float()


def _launches():
    return (ssd_ops.ssd_scan.launches, fa_ops.flash_attention.launches,
            dec_ops.decode_attention.launches)


def test_structure(model):
    rcfg, pcfg, rparams, pparams = model
    assert ptf.num_shared_attn_apps(pcfg) == rtf.num_shared_attn_apps(rcfg)
    assert ("shared_attn" in pparams) == (pcfg.family == "hybrid")
    if pcfg.family == "hybrid":
        assert sorted(pparams["shared_attn"]) == sorted(
            rparams["shared_attn"])
    assert pparams["blocks"]["mamba"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("impl,rimpl", [("reference", "reference"),
                                        ("chunked", "reference"),
                                        ("kernel", "pallas")])
def test_forward_matches_reference(model, impl, rimpl):
    rcfg, pcfg, rparams, pparams = model
    toks = _tokens(pcfg, (2, 32))
    want, _ = rtf.forward(rparams, rcfg, jnp.asarray(toks), impl=rimpl)
    before = _launches()
    got, aux = ptf.forward(pparams, pcfg, torch.from_numpy(toks), impl=impl)
    assert _launches() == before  # CPU tensors launch nothing
    assert tuple(got.shape) == (2, 32, pcfg.vocab_size)
    assert float(aux) == 0.0
    F32(_np(got), _np(want))


def test_prefill_step_matches_reference(model):
    """`make_prefill_step` (the kernel path) on 40 tokens, which the
    kernel path pads to the reduced chunk of 16."""
    rcfg, pcfg, rparams, pparams = model
    toks = _tokens(pcfg, (3, 40), seed=2)
    want = rsteps.make_prefill_step(rcfg, impl="pallas")(
        rparams, {"tokens": jnp.asarray(toks)})
    got = psteps.make_prefill_step(pcfg)(
        pparams, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == (3, pcfg.vocab_size)
    F32(_np(got), _np(want))


def test_init_decode_state_matches_reference(model):
    rcfg, pcfg, _, _ = model
    rst = rtf.init_decode_state(rcfg, 3, 16, dtype=jnp.float32)
    pst = ptf.init_decode_state(pcfg, 3, 16, dtype=torch.float32,
                                device="cpu")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [layout(v) for v in tree]
        return (tuple(tree.shape), str(tree.dtype).split(".")[-1])

    assert layout(pst.caches) == layout(rst.caches)
    assert float(np.abs(_np(pst.caches["ssm"]["ssm"])).max()) == 0.0
    bf = ptf.init_decode_state(pcfg, 3, 16, device="cpu")
    assert bf.caches["ssm"]["ssm"].dtype == torch.float32
    if pcfg.family == "hybrid":
        assert bf.caches["shared_kv"]["k"].dtype == torch.bfloat16


def _decode_both(rcfg, pcfg, rparams, pparams, toks, positions, max_seq,
                 pimpls=("reference", "kernel")):
    b, steps = toks.shape
    rst = rtf.init_decode_state(rcfg, b, max_seq, dtype=jnp.float32)
    rst.position = jnp.asarray(positions, jnp.int32)
    pst = {i: ptf.init_decode_state(pcfg, b, max_seq, dtype=torch.float32,
                                    device="cpu") for i in pimpls}
    for i in pimpls:
        pst[i].position = torch.as_tensor(np.asarray(positions))
    for t in range(steps):
        want, rst = rtf.decode_step(rparams, rcfg,
                                    jnp.asarray(toks[:, t:t + 1]), rst)
        for i in pimpls:
            got, pst[i] = ptf.decode_step(
                pparams, pcfg, torch.from_numpy(toks[:, t:t + 1]), pst[i],
                impl=i)
            assert tuple(got.shape) == (b, 1, pcfg.vocab_size)
            F32(_np(got), _np(want), f"step {t}, impl {i}")
    return rst, pst


def test_decode_step_per_slot_positions(model):
    """(B,) positions, every impl; the caches written in place hold what
    the reference's functional ones do."""
    rcfg, pcfg, rparams, pparams = model
    before = _launches()
    rst, pst = _decode_both(rcfg, pcfg, rparams, pparams,
                            _tokens(pcfg, (3, 6), seed=3), [0, 2, 5],
                            max_seq=16)
    assert _launches() == before  # CPU
    for i, st in pst.items():
        np.testing.assert_array_equal(st.position.numpy(), [6, 8, 11])
        for k in ("ssm", "conv"):
            F32(_np(st.caches["ssm"][k]), _np(rst.caches["ssm"][k]),
                f"{k} state, impl {i}")
        if pcfg.family == "hybrid":
            for k in ("k", "v"):
                F32(_np(st.caches["shared_kv"][k]),
                    _np(rst.caches["shared_kv"][k]), f"shared {k}, impl {i}")


def test_decode_matches_prefill(model):
    """Token-by-token decode from position 0 ends on the logits that the
    prefill step gives for the same prompt."""
    _, pcfg, _, pparams = model
    toks = _tokens(pcfg, (2, 10), seed=4)
    st = ptf.init_decode_state(pcfg, 2, 16, dtype=torch.float32,
                               device="cpu")
    for t in range(10):
        logits, st = psteps.make_serve_step(pcfg)(
            pparams, torch.from_numpy(toks[:, t:t + 1]), st)
    pre = psteps.make_prefill_step(pcfg)(pparams,
                                         {"tokens": torch.from_numpy(toks)})
    F32(_np(logits[:, 0]), _np(pre))


def test_serve_step_matches_reference(model):
    rcfg, pcfg, rparams, pparams = model
    toks = _tokens(pcfg, (2, 4), seed=5)
    rst = rtf.init_decode_state(rcfg, 2, 8, dtype=jnp.float32)
    pst = ptf.init_decode_state(pcfg, 2, 8, dtype=torch.float32,
                                device="cpu")
    rstep, pstep = rsteps.make_serve_step(rcfg), psteps.make_serve_step(pcfg)
    for t in range(4):
        want, rst = rstep(rparams, jnp.asarray(toks[:, t:t + 1]), rst)
        got, pst = pstep(pparams, torch.from_numpy(toks[:, t:t + 1]), pst)
        F32(_np(got), _np(want), f"step {t}")


@pytest.mark.parametrize("name,share", [("mamba2", 2e-2), ("zamba2", 4e-2)])
def test_bf16_forward_and_decode(name, share):
    rcfg, pcfg, rparams, pparams = _setup(name, dtype="bfloat16")
    assert pparams["blocks"]["mamba"]["w_zx"].dtype == torch.bfloat16
    assert pparams["blocks"]["mamba"]["A_log"].dtype == torch.float32
    toks = _tokens(pcfg, (2, 32), seed=6)
    want, _ = rtf.forward(rparams, rcfg, jnp.asarray(toks), impl="pallas")
    got, _ = ptf.forward(pparams, pcfg, torch.from_numpy(toks),
                         impl="kernel")
    assert got.dtype == torch.bfloat16
    BF16(_np(got), _np(want), share=share)
    truth, _ = ptf.forward(_fp32(pparams), dataclasses.replace(
        pcfg, dtype="float32"), torch.from_numpy(toks), impl="kernel")
    scale = float(np.abs(_np(truth)).max())
    port_err = float(np.abs(_np(got) - _np(truth)).max()) / scale
    ref_err = float(np.abs(_np(want) - _np(truth)).max()) / scale
    assert port_err <= 1.5 * ref_err, (port_err, ref_err)
    rst = rtf.init_decode_state(rcfg, 2, 8)
    pst = ptf.init_decode_state(pcfg, 2, 8, device="cpu")
    for t in range(3):
        want, rst = rtf.decode_step(rparams, rcfg, jnp.asarray(toks[:, t:t + 1]),
                                    rst)
        got, pst = ptf.decode_step(pparams, pcfg,
                                   torch.from_numpy(toks[:, t:t + 1]), pst,
                                   impl="kernel")
        BF16(_np(got), _np(want), f"step {t}", share=share)


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_params_from_reference_keeps_the_leaves(name):
    """shared_attn and the fp32 A_log / D / dt_bias of a bf16 model come
    across bit for bit."""
    _, _, rparams, pparams = _setup(name, dtype="bfloat16")

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
        if p.dtype == torch.bfloat16:
            np.testing.assert_array_equal(p.view(torch.int16).numpy(),
                                          r.view(np.int16))
        else:
            assert p.dtype == torch.float32
            np.testing.assert_array_equal(p.numpy(), r)


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_init_params_distribution_and_layout(name):
    rcfg, pcfg, _, _ = _setup(name)
    p = ptf.init_params(pcfg, torch.Generator().manual_seed(0), device="cpu")
    r = jax.device_get(rtf.init_params(rcfg, jax.random.PRNGKey(0)))

    def walk(pt, rt, path=""):
        assert sorted(pt) == sorted(rt), path
        for k in sorted(pt):
            if isinstance(pt[k], dict):
                yield from walk(pt[k], rt[k], f"{path}/{k}")
            else:
                yield f"{path}/{k}", pt[k], np.asarray(rt[k])

    for path, a, b in walk(p, r):
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).split(".")[-1] == b.dtype.name, path
        if path.endswith(("A_log", "D", "dt_bias", "scale")):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, err_msg=path)
        else:
            np.testing.assert_allclose(float(a.float().std()),
                                       float(b.std()), rtol=0.1,
                                       err_msg=path)
