"""The port's sharding rules (`repro_torch.launch.sharding`) entry for
entry against the reference's `PartitionSpec`s (`repro.launch.sharding`):
`param_specs` for every architecture x fsdp_layers x pod_stacked x mesh
(none, (16, 16), (2, 16, 16), (2, 2), (2, 2, 2)) leaf by leaf in
`jax.tree.flatten` order; `fix_spec` on the reference test's cases;
`batch_specs` for every flag; `decode_cache_specs` for every family's
decode shapes at batch 1 and above with kv_seq_shard both ways;
`fl_leaf_spec` and `fl_plan_specs`. Each param spec's DTensor shard on a
fake (16, 16) world has the reference's shard shape (`NamedSharding` on
an `AbstractMesh`). `placements`' mapping, and `shard_ctx` returning its
input object when no spec is set or the tensor is plain; `core.topology`
re-exports the reference's names from the port's catalog."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as RP  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.launch import sharding as rsh  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402

from repro_torch.configs import get_config as pget  # noqa: E402
from repro_torch.launch import sharding as psh  # noqa: E402
from repro_torch.launch import specs as pspecs  # noqa: E402
from repro_torch.launch.mesh import (fake_world, make_debug_mesh,  # noqa: E402
                                     make_production_mesh, tree_leaves)
from repro_torch.models import shard_ctx  # noqa: E402

MESHES = {None: None, "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


class _RefMesh:
    """What the reference's `_axis_sizes` reads of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


def _sizes(mesh):
    return None if mesh is None else dict(zip(mesh[1], mesh[0]))


def _same(port, ref):
    assert tuple(port) == tuple(ref), (port, ref)


_SHAPES = {}


def _param_shapes(arch):
    if arch not in _SHAPES:
        _SHAPES[arch] = (rspecs.params_shape(rget(arch)),
                         pspecs.params_shape(pget(arch)))
    return _SHAPES[arch]


def _stack2(tree, n=2):
    if isinstance(tree, dict):
        return {k: _stack2(v, n) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype,
                           device="meta")
    return jax.ShapeDtypeStruct((n,) + tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh):
    rshape, pshape = _param_shapes(arch)
    m = MESHES[mesh]
    for fsdp in (True, False):
        for pod in (True, False):
            rs, ps = (_stack2(rshape), _stack2(pshape)) if pod else (rshape,
                                                                     pshape)
            kw = dict(fsdp_layers=fsdp, pod_stacked=pod)
            if m is not None and pod and "pod" not in m[1]:
                with pytest.raises(KeyError):
                    rsh.param_specs(rget(arch), rs, mesh=_RefMesh(*m), **kw)
                with pytest.raises(KeyError):
                    psh.param_specs(pget(arch), ps, mesh=_sizes(m), **kw)
                continue
            want = jax.tree.leaves(
                rsh.param_specs(rget(arch), rs, **kw,
                                mesh=None if m is None else _RefMesh(*m)),
                is_leaf=lambda x: isinstance(x, RP))
            got = tree_leaves(psh.param_specs(pget(arch), ps, **kw,
                                              mesh=_sizes(m)))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _same(g, w)


def test_param_shards_have_the_reference_shard_shapes():
    """Every arch's specs on (16, 16): the DTensor made from rank 0's
    shard has the global shape, and the shard the reference's."""
    amesh = AbstractMesh((16, 16), ("data", "model"))
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        for arch in ARCH_IDS:
            rshape, pshape = _param_shapes(arch)
            specs = psh.param_specs(pget(arch), pshape, mesh=mesh)
            for leaf, spec, rleaf in zip(tree_leaves(pshape),
                                         tree_leaves(specs),
                                         jax.tree.leaves(rshape)):
                local = psh.local_shape(leaf.shape, mesh, spec)
                want = NamedSharding(amesh, RP(*spec)).shard_shape(
                    tuple(rleaf.shape))
                assert local == tuple(want), (arch, spec, leaf.shape)
                with torch._subclasses.fake_tensor.FakeTensorMode():
                    dt = psh.sharded(torch.empty(local, dtype=leaf.dtype),
                                     mesh, spec, tuple(leaf.shape))
                assert tuple(dt.shape) == tuple(leaf.shape)
                assert tuple(dt.to_local().shape) == local


def test_fix_spec_cases():
    sizes = {"data": 16, "model": 16, "pod": 2}
    for spec, shape in [(("data", "model"), (4096, 4096)),
                        (("model", "data"), (50280, 1024)),
                        ((("model", "data"), None), (4096, 8)),
                        ((("model", "data"), None), (64, 8)),
                        (("data",), (7, 3, 2))]:
        _same(psh.fix_spec(psh.P(*spec), shape, sizes),
              rsh.fix_spec(RP(*spec), shape, sizes))
    assert psh.fix_spec(psh.P(("model", "data"), None), (64, 8),
                        sizes) == psh.P("model", None)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_batch_specs_equal_the_reference(mode):
    for multi in (True, False):
        for fl in (True, False):
            for prefix in (True, False):
                kw = dict(multi_pod=multi, fl=fl, has_prefix=prefix)
                got, want = psh.batch_specs(mode, **kw), rsh.batch_specs(
                    mode, **kw)
                assert sorted(got) == sorted(want)
                for k in got:
                    _same(got[k], want[k])


def _spec_leaves(tree):
    """Specs in `jax.tree.leaves` order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def _decode_cases():
    for arch in ARCH_IDS:
        cfg = rget(arch)
        for name in ("decode_32k", "long_500k"):
            if rspecs.shape_applicable(cfg, rspecs.SHAPES[name])[0]:
                yield arch, name


@pytest.mark.parametrize("arch,shape", list(_decode_cases()))
def test_decode_cache_specs_equal_the_reference(arch, shape):
    rshape = rspecs.SHAPES[shape]
    _, rstate = rspecs.decode_shapes(rget(arch), rshape)
    _, pstate = pspecs.decode_shapes(pget(arch), pspecs.SHAPES[shape])
    for batch in (1, rshape.global_batch):
        for kv_seq in (False, True):
            for mesh in MESHES:
                m = MESHES[mesh]
                multi = m is not None and "pod" in m[1]
                kw = dict(batch=batch, multi_pod=multi, kv_seq_shard=kv_seq)
                want = rsh.decode_cache_specs(
                    rget(arch), rstate, mesh=None if m is None
                    else _RefMesh(*m), **kw)
                got = psh.decode_cache_specs(pget(arch), pstate,
                                             mesh=_sizes(m), **kw)
                wl = jax.tree.leaves(want.caches,
                                     is_leaf=lambda x: isinstance(x, RP))
                gl = _spec_leaves(got.caches)
                assert len(gl) == len(wl)
                for g, w in zip(gl, wl):
                    _same(g, w)
                _same(got.position, want.position)


def test_fl_leaf_and_plan_specs_equal_the_reference():
    for shape in [(12, 33), (16, 33), (5,), (), (12, 4, 2), (3, 12)]:
        for axis in ("silo", "pod"):
            _same(psh.fl_leaf_spec(shape, 12, 16, axis=axis),
                  rsh.fl_leaf_spec(shape, 12, 16, axis=axis))
    for axis in ("silo", "x"):
        got, want = psh.fl_plan_specs(axis=axis), rsh.fl_plan_specs(axis=axis)
        assert sorted(got) == sorted(want)
        for k in got:
            _same(got[k], want[k])


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(8):
        mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                               device_type="cpu")
        P = psh.P
        assert psh.placements(mesh, P(("pod", "data"), None, "model"), 3) == (
            Shard(0), Shard(0), Shard(2))
        assert psh.placements(mesh, P(None, "data"), 2) == (
            Replicate(), Shard(1), Replicate())
        assert psh.placements(mesh, P(), 0) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="mesh's order"):
            psh.placements(mesh, P(("data", "pod")), 1)
        with pytest.raises(ValueError, match="used twice"):
            psh.placements(mesh, P("data", "data"), 2)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the "
                    "default device where there is no card")
def test_meshes_lie_on_the_card_unless_asked_for_the_cpu():
    with fake_world(4):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_debug_mesh((2, 2), ("data", "model"))
        assert make_debug_mesh((2, 2), ("data", "model"),
                               device_type="cpu").device_type == "cpu"


def test_shard_ctx_is_identity_without_specs():
    x = torch.ones(2, 3, 4)
    shard_ctx.clear()
    for f in (shard_ctx.constrain_act, shard_ctx.constrain_channels,
              shard_ctx.constrain_heads):
        assert f(x) is x
    P = psh.P
    with fake_world(4):
        mesh = make_debug_mesh((2, 2), ("data", "model"), device_type="cpu")
        shard_ctx.set_specs(act=P("data", None, None),
                            channels=P("data", None, "model"),
                            heads=P("data", None, "model", None), mesh=mesh)
        try:
            assert shard_ctx.constrain_act(x) is x  # a plain tensor
            d = psh.shard_of(x, mesh, P("data", None, None))
            assert shard_ctx.constrain_act(d) is d  # already laid out
            c = shard_ctx.constrain_channels(d)
            assert c.placements == psh.placements(
                mesh, P("data", None, "model"), 3)
        finally:
            shard_ctx.clear()
    assert shard_ctx.constrain_heads(x) is x


def test_core_topology_reexports_the_reference_names():
    import repro.core.topology as rtop

    import repro_torch.core.topology as ptop
    import repro_torch.design.catalog as pcat

    def names(mod):
        return sorted(n for n in vars(mod) if not n.startswith("__")
                      and n != "annotations")

    assert names(ptop) == names(rtop)
    for n in names(ptop):
        assert getattr(ptop, n) is getattr(pcat, n), n
