"""Activation-sharding context (set by the launch layer, a no-op otherwise;
counterpart of `repro.models.shard_ctx`), and the few DTensor helpers the
model code needs where GSPMD would act on its own.

The reference anchors GSPMD with `with_sharding_constraint`; here an
anchor redistributes a DTensor activation to the spec's placements, so
the layout between ops is the reference's rather than whatever DTensor's
propagation picked. The launch layer sets three specs and the mesh:

  act      -- (B, S, D) block-boundary activations: P(dp, None, None)
  channels -- (B, S, C) wide interiors (mlp ffn, mamba z/x, dt):
              P(dp, None, "model")  (Megatron TP)
  heads    -- (B, S, H, hd) per-head tensors (q/k/v, ssd x):
              P(dp, None, "model", None)

Model code calls constrain_* unconditionally; with specs unset, or on a
plain tensor, they return their input object itself. An anchor acts on
the axes of its tensor's own mesh: inside the FL step a silo's sub-mesh
has no "pod".

The helpers below let the model code act where GSPMD would on its own:
`run_local` runs what DTensor has no rule for (the attention and SSD
kernels, the cache writes, the MoE dispatch) on each rank's own shard, as
`local_map` does, with uneven shards; `split_last` / `merge_last` split
and merge head dims that are sharded unevenly; `unshard` is the FSDP
gather of a weight before its use; `row_lookup`, `last_dim_gather` and
`last_dim_logsumexp` are the vocab-parallel embedding and cross entropy;
`row_slice` takes a micro batch of each rank's own rows.
"""

from __future__ import annotations

import sys

import torch

_SPECS = {"act": None, "channels": None, "heads": None}
_MESH = {"mesh": None}


def set_specs(act=None, channels=None, heads=None, mesh=None) -> None:
    _SPECS["act"] = act
    _SPECS["channels"] = channels
    _SPECS["heads"] = heads
    _MESH["mesh"] = mesh


def clear() -> None:
    set_specs(None, None, None, None)


def is_dtensor(x) -> bool:
    """Whether x is a DTensor (without importing torch.distributed.tensor:
    none exists until something has)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _on_axes(spec, names):
    """``spec`` with the axes that are not in ``names`` left out."""
    out = []
    for e in spec:
        axes = tuple(a for a in (e if isinstance(e, tuple) else (e,))
                     if a in names)
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return type(spec)(*out)


def _apply(kind, x):
    sp = _SPECS[kind]
    if sp is None or _MESH["mesh"] is None or not is_dtensor(x):
        return x
    from repro_torch.launch.sharding import placements

    mesh = x.device_mesh
    want = placements(mesh, _on_axes(sp, set(mesh.mesh_dim_names)), x.ndim)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def constrain_act(x):
    return _apply("act", x)


def constrain_channels(x):
    return _apply("channels", x)


def constrain_heads(x):
    return _apply("heads", x)


# ---------------------------------------------------------------------------
# DTensor helpers
# ---------------------------------------------------------------------------


def _unshard_unless_divides(x, dim: int, n: int):
    """x, first replicated on ``dim`` if its sharding there does not
    divide ``n`` (DTensor cannot split or merge an unevenly sharded dim,
    where GSPMD pads)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    on_dim = [isinstance(pl, Shard) and pl.dim % x.ndim == dim
              for pl in x.placements]
    ways = 1
    for i, hit in enumerate(on_dim):
        ways *= mesh.size(i) if hit else 1
    if n % ways == 0:
        return x
    return x.redistribute(mesh, [Replicate() if hit else pl
                                 for hit, pl in zip(on_dim, x.placements)])


def split_last(x, dims):
    """x.reshape(*x.shape[:-1], *dims); a DTensor whose last dim is split
    over more ranks than ``dims[0]`` divides (4 KV heads over a 16-way
    axis) is replicated on it first."""
    shape = tuple(x.shape[:-1]) + tuple(dims)
    if is_dtensor(x):
        x = _unshard_unless_divides(x, x.ndim - 1, dims[0])
    return x.reshape(shape)


def merge_last(x):
    """x with its last two dims merged; a DTensor whose second-to-last dim
    is sharded unevenly (28 heads over 16) is replicated on it first."""
    shape = tuple(x.shape[:-2]) + (x.shape[-2] * x.shape[-1],)
    if is_dtensor(x):
        x = _unshard_unless_divides(x, x.ndim - 2, x.shape[-2])
    return x.reshape(shape)


def batch_or_replicate(x, i: int):
    """The placement on mesh dim i that keeps x's batch (dim 0) sharded
    there if it is, and replicates otherwise."""
    from torch.distributed.tensor import Replicate, Shard

    return Shard(0) if x.placements[i] == Shard(0) else Replicate()


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous on its way back: a
    DTensor's backward views the gradient of its shard, which a local
    function may leave strided."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grad(x):
    if not (x.requires_grad and torch.is_grad_enabled()):
        return x
    return _ContiguousGrad.apply(x)


def run_local(fn, args, in_placements, out_placements, out_shape):
    """``fn`` on this rank's shards of ``args`` (the DTensors among them
    redistributed to ``in_placements`` first; None takes a DTensor's
    shard as it lies, so that ``fn`` may write into it, a cache), its
    output wrapped as the DTensor of ``out_shape`` under
    ``out_placements`` (`local_map`, with uneven shards allowed). A list
    of shapes, with a placements list each, stands for a tuple of
    outputs.

    For autograd, an argument replicated over a mesh dim on which an
    output is split gets a partial-sum gradient there: each rank's
    shard of the output used it for its own part."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    many = isinstance(out_shape, list)
    outs = list(out_placements) if many else [out_placements]
    split = [any(not isinstance(o[d], Replicate) for o in outs)
             for d in range(mesh.ndim)]

    def grad_pl(pl):
        return [Partial() if s and isinstance(p, Replicate) else p
                for s, p in zip(split, pl)]

    local = [a if not is_dtensor(a) else
             a.to_local() if pl is None else
             _contiguous_grad(a.redistribute(mesh, pl).to_local(
                 grad_placements=grad_pl(pl)))
             for a, pl in zip(args, in_placements)]
    got = fn(*local)
    if not many:
        return wrap(got.contiguous(), mesh, out_placements, out_shape)
    return tuple(wrap(g.contiguous(), mesh, pl, shape)
                 for g, pl, shape in zip(got, outs, out_shape))


def replicated(x):
    """x, replicated on every mesh dim if it is a DTensor (a scalar loss
    whose partial sums are reduced)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = [Replicate()] * x.device_mesh.ndim
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def unshard(x, axis: str = "data"):
    """x, replicated over the mesh axis ``axis`` if it is a DTensor split
    there: the FSDP all-gather of a weight before its use (its backward
    reduce-scatters the gradient back)."""
    if not is_dtensor(x) or axis not in x.device_mesh.mesh_dim_names:
        return x
    from torch.distributed.tensor import Replicate

    i = x.device_mesh.mesh_dim_names.index(axis)
    if x.placements[i] == Replicate():
        return x
    pl = list(x.placements)
    pl[i] = Replicate()
    return x.redistribute(x.device_mesh, pl)


def last_dim_logsumexp(x):
    """logsumexp over the last dim of a DTensor split there, without
    gathering it: the max and the sum of exponentials are reduced over
    the ranks that split it (the max is a constant for autograd, as the
    result does not depend on it)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, last = x.device_mesh, x.ndim - 1
    xpl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    on_last = [isinstance(p, Shard) and p.dim % x.ndim == last for p in xpl]
    if not any(on_last):
        return torch.logsumexp(x, dim=-1)
    opl = [Replicate() if hit else p for hit, p in zip(on_last, xpl)]
    shape = tuple(x.shape[:-1])

    def local_max(xl):
        if not xl.shape[-1]:
            return xl.new_full(xl.shape[:-1], float("-inf"))
        return xl.amax(-1)

    m = run_local(local_max, (x,), (xpl,),
                  [Partial("max") if hit else p
                   for hit, p in zip(on_last, opl)], shape)
    m = m.redistribute(mesh, opl).detach()
    s = run_local(lambda xl, ml: torch.exp(xl - ml[..., None]).sum(-1),
                  (x, m), (xpl, opl),
                  [Partial() if hit else p for hit, p in zip(on_last, opl)],
                  shape)
    return m + torch.log(s.redistribute(mesh, opl))


def last_dim_gather(x, index):
    """x[..., index] for a DTensor x (..., V) and an index (...): each rank
    gathers from its own slice of the last dim (zero where the index lies
    in another's), and the result is a partial sum over the ranks that
    split that dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, last = x.device_mesh, x.ndim - 1
    xpl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    on_last = [isinstance(p, Shard) and p.dim % x.ndim == last for p in xpl]
    ipl = [Replicate() if hit else p for hit, p in zip(on_last, xpl)]
    opl = [Partial() if hit else p for hit, p in zip(on_last, ipl)]
    _, off = local_box(tuple(x.shape), mesh, xpl)

    def local(xl, il):
        rel = il - off[last]
        inside = (rel >= 0) & (rel < xl.shape[-1])
        got = torch.gather(xl, -1, rel.clamp(0, max(xl.shape[-1] - 1, 0))
                           [..., None])[..., 0]
        return torch.where(inside, got, torch.zeros_like(got))

    if not is_dtensor(index):
        index = wrap(index, mesh, [Replicate()] * mesh.ndim,
                     tuple(index.shape))
    return run_local(local, (x, index), (xpl, ipl), opl, tuple(index.shape))


def row_lookup(table, index):
    """table[index] for a DTensor table (V, D) and an index (...): each rank
    looks up the rows it holds (zero for an index on another rank's rows)
    and the result is a partial sum over the ranks that split V (the
    vocab-parallel embedding); the index keeps its own split elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    tpl = [Replicate() if isinstance(p, Partial) else p
           for p in table.placements]
    on_rows = [isinstance(p, Shard) and p.dim == 0 for p in tpl]
    if not is_dtensor(index):
        index = wrap(index, mesh, [Replicate()] * mesh.ndim,
                     tuple(index.shape))
    ipl = [Replicate() if hit else (p if isinstance(p, Shard) else
                                    Replicate())
           for hit, p in zip(on_rows, index.placements)]
    opl = [Partial() if hit else p for hit, p in zip(on_rows, ipl)]
    _, off = local_box(tuple(table.shape), mesh, tpl)

    def local(tl, il):
        rel = il - off[0]
        inside = (rel >= 0) & (rel < tl.shape[0])
        rows = tl[rel.clamp(0, max(tl.shape[0] - 1, 0))]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    return run_local(local, (table, index), (tpl, ipl), opl,
                     tuple(index.shape) + (table.shape[1],))


def row_slice(x, i: int, n: int):
    """Slice i of n of x's leading (batch) dim. A DTensor takes slice i of
    each rank's own rows, so every micro batch stays split over the
    batch's mesh axes and no rows move (its rows are then not the plain
    tensor's rows i*B/n.. but the same B/n of them over all slices)."""
    if not is_dtensor(x):
        size = x.shape[0] // n
        return x[i * size:(i + 1) * size]
    local = x.to_local()
    size = local.shape[0] // n
    return wrap(local[i * size:(i + 1) * size], x.device_mesh, x.placements,
                (x.shape[0] // n,) + tuple(x.shape[1:]))


def _chunk(n: int, k: int, i: int) -> tuple[int, int]:
    """(size, offset) of chunk i of n split into k, `torch.chunk`'s way."""
    size = -(-n // k) if n else 0
    off = min(n, size * i)
    return max(0, min(size, n - off)), off


def local_box(shape, mesh, placements):
    """(sizes, offsets) of this rank's shard of a ``shape`` tensor under
    ``placements``; several mesh dims on one tensor dim split it in mesh
    order."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    size, off = list(shape), [0] * len(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d = pl.dim % len(shape)
            n, o = _chunk(size[d], mesh.size(i), coord[i])
            size[d], off[d] = n, off[d] + o
    return tuple(size), tuple(off)


def contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


def wrap(local, mesh, placements, shape):
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local`` (no collective, no check)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))
