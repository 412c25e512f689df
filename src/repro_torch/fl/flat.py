"""Flat-parameter packing (counterpart of `repro.fl.flat`).

N silo replicas live in one contiguous `(N, T)` fp32 matrix and the 2E
edge buffers in one `(2E, T)` matrix, so local SGD, the buffer refresh
and the edge aggregation each run over one array; the ring gossip round
packs a whole replica into one row the same way.

Parameters are nested dicts of tensors. Leaves are ordered by sorted key
at every level, which is `jax.tree.flatten`'s order for dicts, keep the
reference's shapes, and are named by their `/`-joined key paths (for a
flat dict, the keys), so a row means the same thing in both packages:

    spec = make_flat_spec(params)           # from one replica
    flat = ravel(spec, params)              # (T,) in spec.dtype
    back = unravel(spec, flat)              # leaf types restored
    mat  = ravel_stacked(spec, stacked)     # leaves (N, ...) -> (N, T)

A leaf already of the storage type comes back from `unravel` and
`unravel_stacked` as a view (a slice and a reshape, no copy), so autograd
through `loss(unravel(spec, row))` of an fp32 model yields the flat
gradient with no extra arithmetic; a leaf of another type (bf16) comes
back as a cast copy.
"""

from __future__ import annotations

import dataclasses
import math

import torch

Params = dict  # nested dict of tensors


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Layout of a nested dict of tensors inside one flat vector."""

    names: tuple[str, ...]                # "/"-joined key paths, in order
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]       # each leaf's own type
    offsets: tuple[int, ...]              # start of each leaf
    size: int                             # T — total number of elements
    dtype: torch.dtype = torch.float32    # storage type of the flat vector


def _leaves(tree: Params, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) in `jax.tree.flatten` order: sorted keys, depth first."""
    out = []
    for key in sorted(tree):
        if "/" in key:
            raise ValueError(f"flat: key {key!r} contains '/'")
        v = tree[key]
        path = f"{prefix}{key}"
        if isinstance(v, dict):
            out += _leaves(v, path + "/")
        else:
            out.append((path, v))
    return out


def _tree(spec: FlatSpec, leaves) -> Params:
    """Nested dict from leaves in spec order."""
    tree: Params = {}
    for name, leaf in zip(spec.names, leaves):
        *parents, last = name.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _ordered(spec: FlatSpec, tree: Params) -> list[torch.Tensor]:
    pairs = _leaves(tree)
    if tuple(p for p, _ in pairs) != spec.names:
        raise ValueError("flat: the tree's leaves are not the spec's")
    return [leaf for _, leaf in pairs]


def make_flat_spec(params: Params, dtype=torch.float32) -> FlatSpec:
    pairs = _leaves(params)
    shapes = tuple(tuple(leaf.shape) for _, leaf in pairs)
    offsets, off = [], 0
    for s in shapes:
        offsets.append(off)
        off += math.prod(s)
    return FlatSpec(names=tuple(p for p, _ in pairs), shapes=shapes,
                    dtypes=tuple(leaf.dtype for _, leaf in pairs),
                    offsets=tuple(offsets), size=off, dtype=dtype)


def ravel(spec: FlatSpec, params: Params,
          out: torch.Tensor | None = None) -> torch.Tensor:
    """Tree -> (T,) in spec order and spec.dtype: a new tensor, or
    written into ``out`` (a (T,) tensor of spec.dtype) leaf by leaf."""
    leaves = _ordered(spec, params)
    if out is None:
        return torch.cat([leaf.to(spec.dtype).reshape(-1) for leaf in leaves])
    for leaf, shape, off in zip(leaves, spec.shapes, spec.offsets):
        out[off:off + math.prod(shape)].view(shape).copy_(leaf)
    return out


def unravel(spec: FlatSpec, flat: torch.Tensor) -> Params:
    """(T,) -> tree: views into ``flat`` where a leaf has flat's type,
    cast copies where it does not."""
    return _tree(spec, [
        flat[off:off + math.prod(shape)].view(shape).to(dt)
        for shape, dt, off in zip(spec.shapes, spec.dtypes, spec.offsets)])


def ravel_stacked(spec: FlatSpec, params: Params) -> torch.Tensor:
    """Tree with a leading stack axis on every leaf -> (N, T)."""
    leaves = _ordered(spec, params)
    n = leaves[0].shape[0]
    return torch.cat([leaf.to(spec.dtype).reshape(n, -1) for leaf in leaves],
                     dim=1)


def unravel_stacked(spec: FlatSpec, flat: torch.Tensor) -> Params:
    """(N, T) -> tree with leading axis N on every leaf (views where the
    leaf has flat's type)."""
    n = flat.shape[0]
    return _tree(spec, [
        flat[:, off:off + math.prod(shape)].view((n,) + shape).to(dt)
        for shape, dt, off in zip(spec.shapes, spec.dtypes, spec.offsets)])


# ---------------------------------------------------------------------------
# the mesh layout (counterpart of `repro.fl.flat.MeshFlatSpec`)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshFlatSpec:
    """FlatSpec + how its buffers split over a D-shard silo axis.

    The (N, T) param/opt matrix splits into contiguous row blocks (shard
    p owns silo rows [p*per, (p+1)*per), N padded up to `rows_padded` =
    D*per) and the (2E, T) edge-buffer matrix by DESTINATION: each shard
    owns the block of dst-sorted edge rows its silos aggregate into,
    padded to `edges_padded` = D*e_per. Both pads sit at the end of each
    shard's block, so every block has the same size; pad rows are inert
    by construction (fl/mesh.py). A process holds the blocks of its local
    shards (`local`), stacked in shard order.
    """

    spec: FlatSpec
    num_shards: int
    rows_padded: int      # Np = D * per
    edges_padded: int     # E_pad = D * e_per
    local: tuple[int, ...]  # this process's shards, consecutive

    def local_rows(self, shape0: int) -> int | None:
        """Rows per block of a local leaf whose leading axis is
        ``shape0``: per or e_per for a split leaf, None for a replicated
        one (e.g. the optimizer's step count)."""
        k = len(self.local)
        for total in (self.rows_padded, self.edges_padded):
            if shape0 == total // self.num_shards * k:
                return total // self.num_shards
        return None

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """A local (k*rows, ...) tensor -> its k local shards' blocks
        (views)."""
        rows = self.local_rows(x.shape[0])
        if rows is None:
            raise ValueError(f"MeshFlatSpec: leading axis {x.shape[0]} is "
                             f"neither the rows' nor the edges'")
        return [x[i * rows:(i + 1) * rows] for i in range(len(self.local))]
