"""`repro_torch.launch.specs` against `repro.launch.specs` on the CPU:
the assigned shapes and their applicability, and the meta-tensor trees
of params, batches and decode states against the reference's
`jax.eval_shape` trees, leaf for leaf in `jax.tree.leaves` order (shape
and type). The one difference is documented: the decode state's position
is int64 in the port, int32 in the reference."""

import dataclasses

import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402

from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.launch import specs as pspecs  # noqa: E402

ARCHS = pconfigs.ARCH_IDS


def _leaf(x) -> tuple:
    """(shape, type name) of a jax ShapeDtypeStruct or a meta tensor."""
    if isinstance(x, torch.Tensor):
        assert x.device.type == "meta"
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), str(x.dtype)


def _ref_leaves(tree) -> list[tuple]:
    return [_leaf(x) for x in jax.tree.leaves(tree)]


def _port_leaves(tree) -> list[tuple]:
    return [_leaf(x) for x in pspecs.meta_leaves(tree)]


def test_shapes_equal_the_reference():
    assert list(pspecs.SHAPES) == list(rspecs.SHAPES)
    for name, shape in pspecs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            rspecs.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_equals_the_reference(arch):
    for name in pspecs.SHAPES:
        assert pspecs.shape_applicable(
            pconfigs.get_config(arch), pspecs.SHAPES[name]) == \
            rspecs.shape_applicable(rconfigs.get_config(arch),
                                    rspecs.SHAPES[name])


def _check_trees(pcfg, rcfg, shape_name):
    pshape, rshape = pspecs.SHAPES[shape_name], rspecs.SHAPES[shape_name]
    assert _port_leaves(pspecs.params_shape(pcfg)) == \
        _ref_leaves(rspecs.params_shape(rcfg))
    if pshape.mode == "decode":
        ptok, pstate = pspecs.decode_shapes(pcfg, pshape)
        rtok, rstate = rspecs.decode_shapes(rcfg, rshape)
        assert _port_leaves(ptok) == _ref_leaves(rtok)
        p, r = _port_leaves(pstate), _ref_leaves(rstate)
        assert p[:-1] == r[:-1]  # the caches
        assert p[-1] == ((), "int64") and r[-1] == ((), "int32")
        return
    for silos in (0, 2):
        assert _port_leaves(pspecs.batch_shape(pcfg, pshape,
                                               fl_silos=silos)) == \
            _ref_leaves(rspecs.batch_shape(rcfg, rshape, fl_silos=silos))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_trees_equal_eval_shape(arch):
    """Each arch's `reduce` config, every applicable shape."""
    pcfg = pconfigs.reduce(pconfigs.get_config(arch))
    rcfg = rconfigs.reduce(rconfigs.get_config(arch))
    for name in ("train_4k", "decode_32k"):
        _check_trees(pcfg, rcfg, name)


def test_full_width_trees_equal_eval_shape():
    """gemma3-27b at full width (two KV cache groups at decode), and its
    leaves hold exactly `param_count()` elements."""
    pcfg = pconfigs.get_config("gemma3_27b")
    rcfg = rconfigs.get_config("gemma3_27b")
    for name in ("train_4k", "decode_32k", "long_500k"):
        _check_trees(pcfg, rcfg, name)
    leaves = pspecs.meta_leaves(pspecs.params_shape(pcfg))
    assert sum(x.numel() for x in leaves) == pcfg.param_count()


def test_input_specs_equal_and_refuse_like_the_reference():
    p = pspecs.input_specs("yi-9b", "prefill_32k")
    r = rspecs.input_specs("yi-9b", "prefill_32k")
    assert sorted(p) == sorted(r) == ["batch", "params"]
    assert _port_leaves(p["batch"]) == _ref_leaves(r["batch"])
    with pytest.raises(ValueError) as pe:
        pspecs.input_specs("yi-9b", "long_500k")
    with pytest.raises(ValueError) as re_:
        rspecs.input_specs("yi-9b", "long_500k")
    assert str(pe.value) == str(re_.value)
