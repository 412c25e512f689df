"""Sharding rules: parameter / batch / cache specs per family, and the
DTensor placements they map to (counterpart of `repro.launch.sharding`).

Baseline layout (the perf variants start from here):
  * tensor parallel over "model": attention head projections, MLP ffn
    dim, MoE expert axis (expert parallel), Mamba z/x/dt head dims;
  * FSDP over "data": each weight's non-TP dim is sharded over the data
    axis (ZeRO-3 style; the per-use all-gather is the FSDP cost);
  * embeddings: vocab axis over "model", d_model over "data";
  * batch over "data" (and "pod" when multi-pod serving);
  * FL (multi-pod train): every leaf gains a leading silo axis sharded
    over "pod"; each pod holds its own replica, gossip syncs them.

A spec is a `P`: one entry per tensor dim, each None (replicated), a
mesh axis name, or a tuple of axis names (the dim split over several
axes, major to minor). It is the reference's `PartitionSpec`, entry for
entry. `placements` turns a spec into the DTensor placements of a
`DeviceMesh` whose dim names are the axis names, and `sharded` builds a
DTensor of a spec from its local shard without any collective (the dry
run's inputs).

Non-divisible dims (qwen2's 28 heads on a 16-way model axis) are legal
inside a step; `fix_spec` weakens an input spec until every sharded dim
divides, as pjit requires of the reference's inputs.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import shard_ctx
from repro_torch.models.config import ModelConfig

Params = Any


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "model"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# rules: param name -> spec WITHOUT the stacked layer axis. Megatron/
# MaxText layout: "model" on the TP dim, "data" (FSDP/ZeRO-3) on the
# OTHER dim; indivisible TP dims are weakened by fix_spec.
_ATTN = {
    "wq": P("data", "model"), "wk": P("data", "model"),
    "wv": P("data", "model"), "wo": P("model", "data"),
    "bq": P("model"), "bk": P("model"), "bv": P("model"),
}
_MLP = {"w_gate": P("data", "model"), "w_up": P("data", "model"),
        "w_down": P("model", "data")}
_MOE = {"router": P("data", None),
        "w_gate": P("model", "data", None), "w_up": P("model", "data", None),
        "w_down": P("model", None, "data")}
_MAMBA = {"w_zx": P("data", "model"), "w_bc": P("data", None),
          "w_dt": P("data", "model"), "conv_x": P(None, "model"),
          "conv_bc": P(None, None), "dt_bias": P("model"),
          "A_log": P("model"), "D": P("model"),
          "out_proj": P("model", "data")}
_NORM = {"scale": P(None)}


def _leaf_spec(path: tuple[str, ...]) -> P:
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    if parent == "embed" or name == "tok":
        if name == "tok":
            return P("model", "data")
        if name == "unembed":
            return P("data", "model")
    if parent == "attn":
        return _ATTN[name]
    if parent == "mlp":
        return _MLP[name]
    if parent == "moe":
        return _MOE[name]
    if parent == "mamba":
        return _MAMBA[name]
    if name == "scale":
        return P(None)
    raise KeyError(f"no sharding rule for param path {path}")


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` (or of a dict passed through)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def fix_spec(spec: P, shape: tuple[int, ...], sizes: dict) -> P:
    """Weaken a spec until every sharded dim divides evenly.

    Axes are dropped from the END of each dim's tuple first: rules append
    the FSDP axis last, so TP survives and only the data sharding
    degrades (e.g. mamba2's vocab 50280 is 16-indivisible -> replicated
    embed)."""
    parts = []
    for i, entry in enumerate(spec):
        if entry is None:
            parts.append(None)
            continue
        axes = list(entry) if isinstance(entry, tuple) else [entry]
        while axes:
            total = 1
            for a in axes:
                total *= sizes[a]
            if shape[i] % total == 0:
                break
            axes.pop()  # drop the last (lowest-priority) axis
        parts.append(tuple(axes) if len(axes) > 1 else
                     (axes[0] if axes else None))
    parts += [None] * (len(shape) - len(parts))
    return P(*parts)


def _with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict, the keys in sorted order."""
    if isinstance(tree, dict):
        return {k: _with_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    return fn(path, tree)


def param_specs(cfg: ModelConfig, params_shape: Params, *,
                fsdp_layers: bool = True, pod_stacked: bool = False,
                mesh=None) -> Params:
    """Spec tree matching a params tree (tensors, meta or real).

    fsdp_layers=False strips the FSDP axis "data" (pure TP); the stacked
    `blocks` axis is replicated; pod_stacked prepends "pod" (the FL silo
    axis). Pass ``mesh`` (a `DeviceMesh` or {axis: size}) to apply the
    divisibility fixup."""
    del cfg  # the rules depend on the names only, as in the reference

    def spec_for(names, leaf):
        in_blocks = "blocks" in names
        base = _leaf_spec(tuple(n for n in names if n != "blocks"))
        parts = list(base)
        if not fsdp_layers:
            parts = [None if e == "data" else
                     (tuple(a for a in e if a != "data") or None
                      if isinstance(e, tuple) else e) for e in parts]
        if in_blocks:
            parts = [None] + parts  # stacked layer axis: replicated
        if pod_stacked:
            parts = ["pod"] + parts
        assert len(parts) == leaf.ndim, (names, parts, leaf.shape)
        sp = P(*parts)
        if mesh is not None:
            sp = fix_spec(sp, tuple(leaf.shape), axis_sizes(mesh))
        return sp

    return _with_path(spec_for, params_shape)


def batch_specs(mode: str, *, multi_pod: bool, fl: bool,
                has_prefix: bool) -> dict:
    """Specs for the step's data inputs."""
    del mode
    if fl:
        # leading silo axis over pod; per-silo batch over data
        tok = P("pod", "data", None)
        pre = P("pod", "data", None, None)
    elif multi_pod:
        tok = P(("pod", "data"), None)
        pre = P(("pod", "data"), None, None)
    else:
        tok = P("data", None)
        pre = P("data", None, None)
    out = {"tokens": tok, "labels": tok}
    if has_prefix:
        out["prefix_embeds"] = pre
    return out


def fl_leaf_spec(shape: tuple[int, ...], rows_padded: int,
                 edges_padded: int, *, axis: str = "silo") -> P:
    """Spec for one flat-FL state leaf on the 1-D silo mesh: the (Np, T)
    param/opt matrix and the (E_pad, T) edge-buffer matrix are
    row-sharded on the silo axis (params by owning silo, edges by
    destination silo); anything else is replicated."""
    if len(shape) >= 1 and shape[0] in (rows_padded, edges_padded):
        return P(axis, *([None] * (len(shape) - 1)))
    return P(*([None] * len(shape)))


def fl_plan_specs(*, axis: str = "silo") -> dict:
    """Specs for the mesh cycle's per-round plan slices and batches:
    strong/coeffs (R, E_pad) and diag (R, Np) shard their trailing axis,
    batches (R, u, Np, b, ...) the silo axis (dim 2), per-shard index
    tables (D, .) their leading axis."""
    return {
        "edge_rounds": P(None, axis),        # strong / coeffs (R, E_pad)
        "diag_rounds": P(None, axis),        # diag (R, Np)
        "batches": P(None, None, axis),      # (R, u, Np, b...) + trailing None
        "table": P(axis, None),              # (D, .) per-shard index tables
    }


def decode_cache_specs(cfg: ModelConfig, state_shape, *, batch: int,
                       multi_pod: bool, mesh=None,
                       kv_seq_shard: bool = False) -> Any:
    """Specs for a `DecodeState`: KV caches (L', B, S, Hkv, hd), SSM
    states (L, B, nh, hp, ns), conv states (L, B, K-1, C).

      * batch over "data" (+"pod" multi-pod); batch == 1 (long_500k)
        moves the SEQUENCE onto "data" instead (flash-decoding layout);
      * KV heads over "model" when Hkv divides the axis, otherwise the
        cache SEQUENCE goes over "model" (the standard GQA fallback);
      * SSM state heads over "model"."""
    from repro_torch.models.transformer import DecodeState

    del cfg
    daxis = ("pod", "data") if multi_pod else "data"
    big_batch = batch > 1
    sizes = axis_sizes(mesh) if mesh is not None else {"model": 16,
                                                       "data": 16, "pod": 2}
    msize = sizes["model"]

    def fixed(sp, shp):
        return fix_spec(sp, shp, sizes) if mesh is not None else sp

    def spec_of(leaf):
        shp = tuple(leaf.shape)
        if len(shp) == 5:  # KV cache (L', B, S, Hkv, hd)
            heads_ok = (shp[3] % msize == 0) and not kv_seq_shard
            if big_batch:
                sp = (P(None, daxis, None, "model", None) if heads_ok
                      else P(None, daxis, "model", None, None))
            else:
                sp = (P(None, None, daxis, "model", None) if heads_ok
                      else P(None, None, (daxis, "model")
                             if not isinstance(daxis, tuple)
                             else tuple(list(daxis) + ["model"]),
                             None, None))
            return fixed(sp, shp)
        if len(shp) == 4:  # conv state (L, B, K-1, C)
            sp = (P(None, daxis, None, "model") if big_batch
                  else P(None, None, None, "model"))
            return fixed(sp, shp)
        if len(shp) == 0:
            return P()
        raise ValueError(f"unexpected cache leaf shape {shp}")

    def spec_ssm(leaf):
        shp = tuple(leaf.shape)
        if len(shp) == 5:  # (L, B, nh, hp, ns)
            sp = (P(None, daxis, "model", None, None) if big_batch
                  else P(None, None, "model", None, None))
            return fixed(sp, shp)
        return spec_of(leaf)

    def over(fn, tree):
        return {k: over(fn, tree[k]) for k in sorted(tree)} \
            if isinstance(tree, dict) else fn(tree)

    caches = state_shape.caches
    specs: dict = {}
    if "kv" in caches:
        specs["kv"] = [over(spec_of, g) for g in caches["kv"]]
    if "ssm" in caches:
        specs["ssm"] = over(spec_ssm, caches["ssm"])
    if "shared_kv" in caches:
        specs["shared_kv"] = over(spec_of, caches["shared_kv"])
    return DecodeState(caches=specs, position=P())


# ---------------------------------------------------------------------------
# DTensor placements (the counterpart of `named`)
# ---------------------------------------------------------------------------


def placements(mesh, spec: P, ndim: int) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` for a tensor of
    ``ndim`` dims: a mesh dim named on tensor dim d is `Shard(d)`, an
    unnamed one `Replicate()`. A tuple of axes on one dim is `Shard(d)`
    on each, which splits the dim major to minor in MESH order (JAX's
    order is the tuple's), so the tuple must be in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]} used twice in "
                                 f"{spec}")
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape, mesh, spec: P) -> tuple[int, ...]:
    """This rank's shard shape of a ``shape`` tensor under ``spec``:
    `torch.chunk`'s split, the ceil division that the reference's even
    shards also give."""
    return shard_ctx.local_box(shape, mesh,
                               placements(mesh, spec, len(shape)))[0]


def sharded(local: torch.Tensor, mesh, spec: P, shape) -> torch.Tensor:
    """A DTensor of global ``shape`` from this rank's shard ``local``,
    made without a collective (`from_local` with no check)."""
    return shard_ctx.wrap(local, mesh, placements(mesh, spec, len(shape)),
                          tuple(shape))


def shard_of(full: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """A DTensor of ``full`` (the same tensor on every rank) under
    ``spec``: each rank keeps its own slice, nothing is sent."""
    size, off = shard_ctx.local_box(tuple(full.shape), mesh,
                                    placements(mesh, spec, full.ndim))
    local = full
    for d, (n, o) in enumerate(zip(size, off)):
        local = local.narrow(d, o, n)
    return sharded(local.contiguous(), mesh, spec, tuple(full.shape))


def spec_map(fn, values, specs):
    """``fn(value, spec)`` over a tree of values and its spec tree (nested
    dicts, lists, a `DecodeState`)."""
    from repro_torch.models.transformer import DecodeState

    if isinstance(values, dict):
        return {k: spec_map(fn, values[k], specs[k]) for k in values}
    if isinstance(values, list):
        return [spec_map(fn, v, s) for v, s in zip(values, specs)]
    if isinstance(values, DecodeState):
        return DecodeState(caches=spec_map(fn, values.caches, specs.caches),
                           position=values.position)
    return fn(values, specs)


def shard_tree(tree, mesh, specs):
    """A tree of tensors (the same on every rank) -> the tree of DTensors
    of ``specs`` on ``mesh`` (`shard_of` leaf by leaf; a `DecodeState`'s
    position stays as it is)."""
    return spec_map(lambda x, s: shard_of(x, mesh, s), tree, specs)


def gather_tree(tree):
    """A tree of DTensors -> the tree of their full tensors."""
    from repro_torch.models.transformer import DecodeState

    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_tree(v) for v in tree]
    if isinstance(tree, DecodeState):
        return DecodeState(caches=gather_tree(tree.caches),
                           position=tree.position)
    return tree.full_tensor() if shard_ctx.is_dtensor(tree) else tree
