"""The port's public surface against the reference's: every public
top-level name of every module under `src/repro/` (read with `ast`, not
imported: some need jax 0.4) exists in the `repro_torch` module at the
same path, and every public member of a public class exists on the
port's class; or it stands in this file's tables with the counterpart
the port has instead, which must exist. Then parity cases, on the CPU,
for the plain-semantics names that came last: `core.parsing`'s
`max_states` and `state_schedule`, `core.consensus`'s `state_consensus`
and `uniform_star_weights`, `networks.registry.register`, the zoo's
deprecated shims, `flash_attention_reference`, `mamba2.ssd_reference`
and `transformer.set_activation_sharding`.
"""

import ast
import dataclasses
import importlib
import pathlib
import warnings

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

#: Reference modules with no port file: the file (under src/repro_torch)
#: that holds their counterpart.
FILE_COUNTERPARTS = {
    "core/timing_jax.py": "core/timing_torch.py",
    "kernels/decode_attention/kernel.py": "csrc/decode_attention.cu",
    "kernels/flash_attention/kernel.py": "csrc/flash_attention.cu",
    "kernels/gossip_combine/kernel.py": "csrc/gossip_combine.cu",
    "kernels/ssd_scan/kernel.py": "csrc/ssd_scan.cu",
}

#: XLA / shard_map machinery: (reference module, name) -> the port's
#: counterpart "module:attribute". Same-name aliases are not made: none of
#: these takes the same arguments and returns the same kind of thing.
XLA_COUNTERPARTS = {
    # an integer xor that keeps XLA:CPU from contracting a*b+c into an
    # FMA; torch's eager ops never contract, and the CUDA kernels pin
    # their rounding with __fmul_rn / __fadd_rn
    ("fl/flat.py", "pin_dtype"): "repro_torch.optim.optimizers:flat_sgd",
    ("fl/flat.py", "pin_f32"): "repro_torch.optim.optimizers:flat_sgd",
    # the silo axis is an object with a `size`, not a name inside shard_map
    ("launch/mesh.py", "axis_size"): "repro_torch.launch.mesh:StackedSilos",
    # shard_map's binding: one shard (or silo) per process-group rank
    ("launch/mesh.py", "shard_map_fn"): "repro_torch.launch.mesh:GroupShards",
    # "pod" manual, "data"/"model" left to the partitioner: the FL step's
    # local step per pod on the sub-mesh of DTensors
    ("launch/mesh.py", "shard_map_partial_auto"):
        "repro_torch.launch.steps:SiloSplit",
    # a jax Mesh with a "silo" axis -> the shard axis that `mesh=` names
    ("launch/mesh.py", "fl_mesh"): "repro_torch.launch.mesh:shard_axis",
    # NamedSharding per spec -> DTensor placements per mesh dim
    ("launch/sharding.py", "named"): "repro_torch.launch.sharding:placements",
    # `Compiled.cost_analysis()` -> FLOPs and bytes counted by dispatch
    ("launch/dryrun.py", "cost_dict"): "repro_torch.launch.dryrun:measure",
    # lower + compile -> one trace on fake tensors
    ("launch/dryrun.py", "lower_pair"): "repro_torch.launch.dryrun:dry_pair",
    # parsing HLO text -> counting the collectives as they dispatch
    ("launch/hlo_analysis.py", "shape_bytes"):
        "repro_torch.launch.hlo_analysis:CollectiveCounter",
    ("launch/hlo_analysis.py", "collective_stats"):
        "repro_torch.launch.hlo_analysis:CollectiveCounter",
    # fl8's cache of lowered states; `fl8 --dry` prints its states and
    # caches nothing, the perf variants write under perf.OUT
    ("launch/fl8.py", "OUT"): "repro_torch.launch.perf:OUT",
    # an (8, 8, 8) jax Mesh -> a DeviceMesh of that shape on a fake world
    ("launch/fl8.py", "make_mesh8"): "repro_torch.launch.fl8:DRY_MESH",
    ("launch/fl8.py", "lower_state"): "repro_torch.launch.fl8:dry_state",
}

#: Public class members the port's class lacks on purpose:
#: (reference module, class) -> {member: the port's counterpart or why}.
MEMBER_EXCEPTIONS = {
    ("fl/dpasgd.py", "FLSimState"): {
        "tree_flatten": "JAX pytree registration",
        "tree_unflatten": "JAX pytree registration"},
    ("fl/runtime.py", "FlatFLState"): {
        "tree_flatten": "JAX pytree registration",
        "tree_unflatten": "JAX pytree registration"},
    ("models/transformer.py", "DecodeState"): {
        "tree_flatten": "JAX pytree registration",
        "tree_unflatten": "JAX pytree registration"},
    ("fl/flat.py", "FlatSpec"): {"treedef": "FlatSpec.names, the key paths"},
    ("fl/flat.py", "MeshFlatSpec"): {
        "axis": "MeshRuntime.axis", "partition_of": "NamedSharding",
        "shard_tree": "NamedSharding", "sharding_of": "NamedSharding"},
    # the port's MeshRuntime keeps the flat runtime whole as `rt`
    ("fl/mesh.py", "MeshRuntime"): {
        **{m: "MeshRuntime.rt" for m in (
            "coeffs", "diag", "dst_sorted", "expand_pair_mask",
            "num_rounds_cycle", "num_silos", "order", "row_ptr", "spec",
            "src_sorted", "strong")},
        "mesh": "MeshRuntime.axis"},
    # eager PyTorch has no trace to count
    ("design/controller.py", "ControllerHarness"): {
        "trace_count": "no jit trace", "assert_single_trace": "no jit trace"},
    # fixed at the reference's defaults: catalog._DMBST_DELTA and
    # catalog._MATCHA_BUDGET (no caller of either package changes them)
    ("design/catalog.py", "DmbstFamily"): {"delta": "_DMBST_DELTA"},
    ("design/catalog.py", "MatchaFamily"): {"budget": "_MATCHA_BUDGET"},
}


def _module_name(rel: pathlib.Path) -> str:
    parts = rel.with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(("repro_torch",) + parts)


def _public_names(tree: ast.Module, is_init: bool) -> set[str]:
    """Top-level defs, classes and assigned names; `__all__`'s entries;
    and, in a package's `__init__.py`, its re-exports of its own modules."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Name):
                        out.add(e.id)
                if isinstance(t, ast.Name) and t.id == "__all__":
                    out |= set(ast.literal_eval(node.value))
        elif (is_init and isinstance(node, ast.ImportFrom)
              and (node.module or "").startswith("repro.")):
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.startswith("_")}


def _class_members(cls: ast.ClassDef) -> set[str]:
    out = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in out if not n.startswith("_")}


def _has_member(cls, name: str) -> bool:
    """An attribute of the class, or a field annotated on it (a dataclass
    field without a default is no class attribute)."""
    return hasattr(cls, name) or any(
        name in vars(c).get("__annotations__", {})
        for c in getattr(cls, "__mro__", ()))


def _resolve(path: str):
    mod, attr = path.split(":")
    return getattr(importlib.import_module(mod), attr)


REF_MODULES = sorted(p.relative_to(REF) for p in REF.rglob("*.py"))


def test_every_reference_module_has_a_counterpart():
    missing = []
    for rel in REF_MODULES:
        port = PORT / FILE_COUNTERPARTS.get(str(rel), rel)
        if not port.is_file():
            missing.append(str(rel))
    assert not missing, missing
    assert set(FILE_COUNTERPARTS) <= {str(r) for r in REF_MODULES}


@pytest.mark.parametrize("rel", [r for r in REF_MODULES
                                 if str(r) not in FILE_COUNTERPARTS], ids=str)
def test_public_names_exist_in_port(rel):
    tree = ast.parse((REF / rel).read_text())
    mod = importlib.import_module(_module_name(rel))
    missing = []
    for name in sorted(_public_names(tree, rel.name == "__init__.py")):
        counterpart = XLA_COUNTERPARTS.get((str(rel), name))
        if counterpart is not None:
            _resolve(counterpart)  # the counterpart exists
        elif not hasattr(mod, name):
            missing.append(name)
        cls = next((n for n in tree.body if isinstance(n, ast.ClassDef)
                    and n.name == name), None)
        if cls is None or counterpart is not None:
            continue
        skip = MEMBER_EXCEPTIONS.get((str(rel), name), {})
        missing += [f"{name}.{m}" for m in sorted(_class_members(cls))
                    if m not in skip and not _has_member(getattr(mod, name),
                                                         m)]
    assert not missing, missing


def test_exception_tables_name_real_reference_entries():
    """Every entry of the tables names a reference name that exists and a
    port counterpart that exists, and every listed member is really
    absent from the port's class (so the table shrinks with the gap)."""
    for (rel, name), counterpart in XLA_COUNTERPARTS.items():
        tree = ast.parse((REF / rel).read_text())
        assert name in _public_names(tree, False), (rel, name)
        _resolve(counterpart)
        assert not hasattr(importlib.import_module(
            _module_name(pathlib.Path(rel))), name), (rel, name)
    for (rel, cname), members in MEMBER_EXCEPTIONS.items():
        tree = ast.parse((REF / rel).read_text())
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == cname)
        assert set(members) <= _class_members(cls), (rel, cname)
        port_cls = getattr(importlib.import_module(
            _module_name(pathlib.Path(rel))), cname)
        assert not any(_has_member(port_cls, m) for m in members), \
            (rel, cname)


# ---------------------------------------------------------------------------
# parity of the names that came last, against the reference on the CPU
# ---------------------------------------------------------------------------

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import consensus as rcons  # noqa: E402
from repro.core import parsing as rparsing  # noqa: E402
from repro.core.delay import FEMNIST as RFEMNIST  # noqa: E402
from repro.core.multigraph import build_multigraph as rbuild  # noqa: E402
from repro.design import catalog as rcatalog  # noqa: E402
from repro.networks import registry as rregistry  # noqa: E402
from repro.networks import zoo as rzoo  # noqa: E402

from repro_torch.core import consensus as pcons  # noqa: E402
from repro_torch.core import parsing as pparsing  # noqa: E402
from repro_torch.core.delay import FEMNIST as PFEMNIST  # noqa: E402
from repro_torch.core.multigraph import build_multigraph as pbuild  # noqa: E402
from repro_torch.design import catalog as pcatalog  # noqa: E402
from repro_torch.networks import registry as pregistry  # noqa: E402
from repro_torch.networks import zoo as pzoo  # noqa: E402

PAPER_NETWORKS = ("gaia", "amazon", "geant", "exodus", "ebone")


def _multigraphs(name):
    rnet, pnet = rregistry.get_network(name), pregistry.get_network(name)
    rmg = rbuild(rnet, RFEMNIST, rcatalog.ring_topology(rnet, RFEMNIST).graph)
    pmg = pbuild(pnet, PFEMNIST, pcatalog.ring_topology(pnet, PFEMNIST).graph)
    return rmg, pmg


def _same_state(a, b) -> bool:
    return a.num_nodes == b.num_nodes and a.edge_type == b.edge_type


@pytest.mark.parametrize("name", PAPER_NETWORKS)
def test_state_schedule_and_max_states(name):
    rmg, pmg = _multigraphs(name)
    s_max = pparsing.max_states(pmg)
    assert s_max == rparsing.max_states(rmg)
    rstates, pstates = rparsing.parse_multigraph(rmg), \
        pparsing.parse_multigraph(pmg)
    assert len(pstates) == s_max
    rsched = list(rparsing.state_schedule(rstates, 3 * s_max))
    psched = list(pparsing.state_schedule(pstates, 3 * s_max))
    assert [k for k, _ in psched] == [k for k, _ in rsched] \
        == list(range(3 * s_max))
    assert all(_same_state(p, r) for (_, p), (_, r) in zip(psched, rsched))
    for k, st in psched:
        assert st is pstates[k % s_max]
        assert st.isolated_nodes() == rsched[k][1].isolated_nodes()
        assert st.has_isolated() == rsched[k][1].has_isolated()


@pytest.mark.parametrize("name", ["gaia", "geant"])
def test_state_consensus_bit_for_bit(name):
    rmg, pmg = _multigraphs(name)
    rstates, pstates = rparsing.parse_multigraph(rmg), \
        pparsing.parse_multigraph(pmg)
    assert len(pstates) == len(rstates)
    for p, r in zip(pstates, rstates):
        got, want = pcons.state_consensus(p), rcons.state_consensus(r)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        # isolated nodes keep an identity row
        for i in p.isolated_nodes():
            assert got[i, i] == 1.0 and got[i].sum() == 1.0


@pytest.mark.parametrize("n,hub", [(1, 0), (11, 3), (40, 39)])
def test_uniform_star_weights(n, hub):
    got, want = pcons.uniform_star_weights(n, hub), \
        rcons.uniform_star_weights(n, hub)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _same_spec(a, b) -> bool:
    """Equal specs, across packages too (their `Silo` classes differ)."""
    return (a.name == b.name
            and [dataclasses.astuple(s) for s in a.silos]
            == [dataclasses.astuple(s) for s in b.silos]
            and np.array_equal(a.latency_ms, b.latency_ms))


def test_register_like_reference(monkeypatch):
    monkeypatch.setattr(pregistry, "_FIXED", dict(pregistry._FIXED))
    monkeypatch.setattr(rregistry, "_FIXED", dict(rregistry._FIXED))
    for reg, zoo in ((pregistry, pzoo), (rregistry, rzoo)):
        reg.register("gaia_fast", lambda **kw: zoo._make_gaia(
            **{"capacity_gbps": 40.0, **kw}))
        assert "gaia_fast" in reg.list_networks()
        with pytest.raises(ValueError, match="'gaia' already registered"):
            reg.register("gaia", zoo._make_amazon)
        assert reg.get_network("gaia").num_silos == 11
        reg.register("gaia", zoo._make_amazon, overwrite=True)
        assert reg.get_network("gaia").num_silos == 22
    assert pregistry.list_networks() == rregistry.list_networks()
    assert _same_spec(pregistry.get_network("gaia_fast"),
                      rregistry.get_network("gaia_fast"))


@pytest.mark.parametrize("shim", list(pzoo.NETWORKS) + ["wan"])
def test_zoo_shims_warn_and_resolve_through_registry(shim):
    with pytest.warns(DeprecationWarning,
                      match=rf"repro_torch\.networks\.zoo\.{shim}\("):
        spec = getattr(pzoo, shim)(**({"num_silos": 16} if shim == "wan"
                                      else {}))
    key = "wan16" if shim == "wan" else shim
    assert _same_spec(spec, pregistry.get_network(key))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = getattr(rzoo, shim)(**({"num_silos": 16} if shim == "wan"
                                     else {}))
    assert _same_spec(spec, ref)
    assert _same_spec(pzoo.get_network(key, capacity_gbps=25.0),
                      rzoo.get_network(key, capacity_gbps=25.0))


def test_zoo_networks_map_in_reference_order():
    assert list(pzoo.NETWORKS) == list(rzoo.NETWORKS)
    assert all(f.__name__ == n for n, f in pzoo.NETWORKS.items())


#: (b, s, hq, hkv, hd, causal, window, prefix)
FLASH_CASES = [(2, 24, 4, 2, 16, True, 0, 0), (1, 40, 6, 3, 8, True, 7, 0),
               (2, 32, 4, 1, 16, True, 0, 12)]
#: both are the plain fp32 oracle (einsum, softmax, einsum); they differ
#: only in summation order
FLASH_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=["causal", "window", "prefix"])
def test_flash_attention_reference_matches(case):
    from repro.kernels.flash_attention.ops import \
        flash_attention_reference as rfar
    from repro_torch.kernels.flash_attention.ops import \
        flash_attention_reference as pfar
    b, s, hq, hkv, hd, causal, window, prefix = case
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for h in (hq, hkv, hkv))
    got = pfar(*map(torch.from_numpy, (q, k, v)), causal=causal,
               window=window, prefix=prefix)
    want = rfar(*map(jnp.asarray, (q, k, v)), causal=causal, window=window,
                prefix=prefix)
    assert tuple(got.shape) == (b, s, hq, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)


def test_ssd_reference_matches():
    """`SSD_CASES`' (2, 48, 4, 8, 16, 16) in fp32, within its 5e-4."""
    from repro.models.mamba2 import ssd_reference as rssd
    from repro_torch.models.mamba2 import ssd_reference as pssd
    b, s, h, p, n, chunk = 2, 48, 4, 8, 16, 16
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(f32)
    A = (-np.exp(0.5 * rng.standard_normal(h))).astype(f32)
    B = rng.standard_normal((b, s, n)).astype(f32)
    C = rng.standard_normal((b, s, n)).astype(f32)
    got = pssd(*map(torch.from_numpy, (x, dt, A, B, C)), chunk)
    want = rssd(*map(jnp.asarray, (x, dt, A, B, C)), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-4)


def test_set_activation_sharding_sets_act_only():
    from repro_torch.launch.sharding import P
    from repro_torch.models import shard_ctx
    from repro_torch.models import transformer as tf
    try:
        shard_ctx.set_specs(channels=P("data", None, "model"))
        tf.set_activation_sharding(P("data", None, None))
        assert shard_ctx._SPECS == {"act": P("data", None, None),
                                    "channels": None, "heads": None}
        x = torch.ones(2, 3, 4)
        assert shard_ctx.constrain_act(x) is x  # off a mesh: the identity
    finally:
        shard_ctx.clear()
