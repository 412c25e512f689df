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
"""

from __future__ import annotations

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
