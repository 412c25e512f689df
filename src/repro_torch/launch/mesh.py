"""The FL silo axis (counterpart of the named mesh axis that
`repro.fl.gossip` runs under, and of `repro.launch.mesh.axis_size`).

The reference binds its silo axis by name: `jax.vmap(..., axis_name=)`
in one program, or `shard_map` over devices. Here the axis is an object
with two bindings and one interface:

* `StackedSilos(n)` -- one process holds all n silos on a leading dim of
  every leaf (the counterpart of the vmap binding). `ppermute` permutes
  the rows of dim 0 on the tensors' own device.
* `GroupSilos(group)` -- one silo per rank of a `torch.distributed`
  process group (the counterpart of `shard_map`). `ppermute` is one
  `dist.batch_isend_irecv` per exchange.

Interface: `size`; `index` (the local silos' indices along the axis: an
(n,) tensor for the stacked binding, the rank for a group);
`local_silos()` and `silo(tree, s)`, one local silo's replica;
`from_silos(make)`, the axis's layout built from `make(s)` for each local
silo; `ppermute(tree, perm)` for (src, dst) pairs, silos that receive
nothing getting zeros as in `jax.lax.ppermute`; `all_gather(tree)`,
leaves (n, ...) holding every silo's replica, the same for each local
silo. `bytes_moved` counts the bytes that the local silos received from
other silos through `ppermute` and `all_gather` (the counterpart of the
reference's collective-permute bytes); a caller resets it to 0. Over a
group each rank counts its own silo's share.

Trees are nested dicts of tensors.

The mesh runtime's shard axis (`StackedShards`, `GroupShards`, chosen by
`shard_axis`) and the silo-to-shard block mapping (`SiloAssignment`,
copied from the reference) are at the end of the module.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure, in
    sorted-key order (`tree_leaves`' and `jax.tree.flatten`'s)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def tree_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _check_perm(perm, n: int) -> list[tuple[int, int]]:
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= i < n for i in srcs + dsts)):
        raise ValueError(f"ppermute: {perm} is not a partial permutation "
                         f"of {n} silos")
    return perm


class StackedSilos:
    """All n silos in one process, on a leading dim of every leaf."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"StackedSilos: n={n}")
        self.size = n
        self.bytes_moved = 0

    @property
    def index(self) -> torch.Tensor:
        return torch.arange(self.size)

    def local_silos(self) -> range:
        return range(self.size)

    def silo(self, tree, s: int):
        return tree_map(lambda x: x[s], tree)

    def from_silos(self, make):
        """Leaves (n, ...): row s is ``make(s)``'s leaf, copied in as each
        replica is made, so one replica at a time is alive beside the
        stack."""
        out = None
        for s in self.local_silos():
            rep = make(s)
            if out is None:
                out = tree_map(lambda x: torch.empty(
                    (self.size,) + tuple(x.shape), dtype=x.dtype,
                    device=x.device), rep)
            tree_map(lambda o, x: o[s].copy_(x), out, rep)
            del rep
        return out

    def ppermute(self, tree, perm):
        """Row d of each output leaf is a copy of row s, one device copy
        per (s, d) pair; rows that receive nothing are zeros."""
        perm = _check_perm(perm, self.size)
        crossing = sum(1 for s, d in perm if s != d)

        def leaf(x):
            self.bytes_moved += crossing * (x.numel() // self.size
                                            * x.element_size())
            out = (torch.empty_like(x) if len(perm) == self.size
                   else torch.zeros_like(x))
            for s, d in perm:
                out[d].copy_(x[s])
            return out

        return tree_map(leaf, tree)

    def all_gather(self, tree):
        # every silo receives the other n - 1 replicas
        self.bytes_moved += (self.size - 1) * tree_bytes(tree)
        return tree


class GroupSilos:
    """One silo per rank of a `torch.distributed` process group (the
    default group if None)."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.bytes_moved = 0

    @property
    def index(self) -> int:
        return dist.get_rank(self.group)

    def local_silos(self) -> list[int]:
        return [self.index]

    def silo(self, tree, s: int):
        if s != self.index:
            raise ValueError(f"GroupSilos: silo {s} is not this rank's "
                             f"({self.index})")
        return tree

    def from_silos(self, make):
        return make(self.index)

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def ppermute(self, tree, perm):
        """One batch of point-to-point ops: every leaf to the silo this
        rank sends to, every leaf from the silo it receives from."""
        perm = _check_perm(perm, self.size)
        me = self.index
        to = [d for s, d in perm if s == me]
        frm = [s for s, d in perm if d == me]
        leaves = tree_leaves(tree)
        if frm and frm[0] == me:          # a silo sending to itself
            got = [x.clone() for x in leaves]
        else:
            got = [torch.zeros_like(x) for x in leaves]
        ops = []
        if to and to[0] != me:
            ops += [dist.P2POp(dist.isend, x.contiguous(), self._peer(to[0]),
                               self.group, tag=i)
                    for i, x in enumerate(leaves)]
        if frm and frm[0] != me:
            ops += [dist.P2POp(dist.irecv, g, self._peer(frm[0]), self.group,
                               tag=i) for i, g in enumerate(got)]
            self.bytes_moved += tree_bytes(tree)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        it = iter(got)
        return tree_map(lambda _: next(it), tree)

    def all_gather(self, tree):
        def leaf(x):
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x.contiguous(), group=self.group)
            return torch.stack(parts)

        self.bytes_moved += (self.size - 1) * tree_bytes(tree)
        return tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# The FL shard axis (counterpart of `repro.launch.mesh`'s silo mesh)
# ---------------------------------------------------------------------------
#
# The mesh runtime (fl/mesh.py) splits the flat `(N, T)` silo rows into D
# contiguous blocks, one per shard, where the reference shards them over a
# 1-D `silo` device mesh with `shard_map`. A shard axis holds the shards
# this process computes and moves row blocks between shards:
#
# * `StackedShards(d, device)` -- all D shards in one process on one
#   device; a local tensor is the D blocks stacked, and a block is a view
#   of its rows (the counterpart of `xla_force_host_platform_device_count`);
# * `GroupShards(group, device)` -- one shard per rank of a
#   `torch.distributed` group (gloo on the CPU, NCCL across cards); a local
#   tensor is this rank's block.
#
# Interface: `size` (D); `local_shards()`; `root` (whether this process
# writes the run's files); `ppermute(blocks, perm, send_idx)`, where
# ``blocks`` are the local shards' row blocks (`fl/flat.MeshFlatSpec`
# splits a local tensor into them) and every shard q sends its rows
# ``send_idx[q]`` to the shard that ``perm`` pairs it with;
# `all_gather(blocks)`, the D blocks stacked, for each local shard.
# `bytes_moved` counts the bytes of the rows that cross from one shard to
# another through `ppermute` and `all_gather` (a caller resets it to 0);
# over a group each rank counts what it receives, so the ranks' counts add
# up to the stacked binding's.

FL_AXIS = "silo"


@dataclasses.dataclass(frozen=True)
class SiloAssignment:
    """Contiguous-block mapping of N silos onto a D-shard silo axis.

    Shard p owns global rows ``[p*per_shard, (p+1)*per_shard)``; rows
    ``>= num_silos`` are inert padding (no edges reference them, their
    losses are sliced away, and the pad batch rows replicate silo 0 so
    every gradient stays finite).
    """

    num_silos: int
    num_shards: int
    axis: str = FL_AXIS

    @property
    def per_shard(self) -> int:
        return -(-self.num_silos // self.num_shards)  # ceil div

    @property
    def rows_padded(self) -> int:
        return self.per_shard * self.num_shards

    def shard_of(self, rows) -> np.ndarray:
        """Owning shard of each global row index."""
        return np.asarray(rows, np.int64) // self.per_shard

    def local_of(self, rows) -> np.ndarray:
        """Row index within the owning shard's block."""
        return np.asarray(rows, np.int64) % self.per_shard


def silo_assignment(num_silos: int, shards, *,
                    axis: str = FL_AXIS) -> SiloAssignment:
    """Map a network's silos onto a shard axis (or a shard count)."""
    d = shards if isinstance(shards, int) else shards.size
    return SiloAssignment(num_silos=int(num_silos), num_shards=int(d),
                          axis=axis)


def _row_bytes(x: torch.Tensor) -> int:
    return (x.numel() // max(x.shape[0], 1)) * x.element_size()


class StackedShards:
    """All D shards in one process, on ``device`` (the tensors' own device
    when None)."""

    root = True

    def __init__(self, d: int, device=None):
        if d < 1:
            raise ValueError(f"StackedShards: d={d}")
        self.size = int(d)
        self.device = None if device is None else torch.device(device)
        self.bytes_moved = 0

    def local_shards(self) -> range:
        return range(self.size)

    def ppermute(self, blocks, perm, send_idx) -> list[torch.Tensor]:
        """Shard p receives ``blocks[q][send_idx[q]]`` from the q that
        ``perm`` pairs with p (zeros where none does); send_idx (D, H)."""
        perm = _check_perm(perm, self.size)
        idx = torch.as_tensor(send_idx, dtype=torch.long,
                              device=blocks[0].device)
        h = idx.shape[1]
        out = [None] * self.size
        for s, d in perm:
            out[d] = blocks[s][idx[s]]
            if s != d:
                self.bytes_moved += h * _row_bytes(blocks[s])
        return [o if o is not None else blocks[0].new_zeros(
            (h,) + tuple(blocks[0].shape[1:])) for o in out]

    def all_gather(self, blocks, *, count: bool = True) -> list[torch.Tensor]:
        """Every shard's view of the D blocks stacked (one tensor)."""
        full = torch.cat(list(blocks)) if len(blocks) > 1 else blocks[0]
        if count:
            self.bytes_moved += (self.size * (self.size - 1)
                                 * blocks[0].shape[0] * _row_bytes(full))
        return [full] * self.size


class GroupShards:
    """One shard per rank of a `torch.distributed` group (the default
    group if None), its tensors on ``device``."""

    def __init__(self, group=None, device=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.device = None if device is None else torch.device(device)
        self.bytes_moved = 0

    @property
    def root(self) -> bool:
        return self.index == 0

    def local_shards(self) -> list[int]:
        return [self.index]

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def ppermute(self, blocks, perm, send_idx) -> list[torch.Tensor]:
        """One `batch_isend_irecv`: this rank's rows ``send_idx[rank]`` to
        the shard it sends to, the rows of the shard it receives from."""
        perm = _check_perm(perm, self.size)
        (x,) = blocks
        me = self.index
        idx = torch.as_tensor(send_idx, dtype=torch.long,
                              device=x.device)[me]
        to = [d for s, d in perm if s == me]
        frm = [s for s, d in perm if d == me]
        got = x.new_zeros((idx.shape[0],) + tuple(x.shape[1:]))
        if frm and frm[0] == me:
            got = x[idx]
        ops = []
        if to and to[0] != me:
            ops.append(dist.P2POp(dist.isend, x[idx].contiguous(),
                                  self._peer(to[0]), self.group))
        if frm and frm[0] != me:
            ops.append(dist.P2POp(dist.irecv, got, self._peer(frm[0]),
                                  self.group))
            self.bytes_moved += idx.shape[0] * _row_bytes(x)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [got]

    def all_gather(self, blocks, *, count: bool = True) -> list[torch.Tensor]:
        (x,) = blocks
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        if count:
            self.bytes_moved += (self.size - 1) * x.shape[0] * _row_bytes(x)
        return [torch.cat(parts)]


def shard_axis(mesh, device=None):
    """The shard axis that ``mesh=`` names: an int D -> `StackedShards(D,
    device)`; "auto" (or None) -> `GroupShards` over the default group
    when `torch.distributed` is initialised, one stacked shard otherwise;
    a shard axis passes through."""
    if isinstance(mesh, (StackedShards, GroupShards)):
        return mesh
    if mesh is None or mesh == "auto":
        if dist.is_available() and dist.is_initialized():
            return GroupShards(None, device)
        return StackedShards(1, device)
    if isinstance(mesh, (int, np.integer)) and not isinstance(mesh, bool):
        return StackedShards(int(mesh), device)
    raise ValueError(f"mesh must be an int, 'auto' or a shard axis, got "
                     f"{mesh!r}")
