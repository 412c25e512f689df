"""Flat-parameter packing for the FL runtime (counterpart of
`repro.fl.flat`).

N silo replicas live in one contiguous `(N, T)` fp32 matrix and the 2E
edge buffers in one `(2E, T)` matrix, so local SGD, the buffer refresh
and the edge aggregation each run over one array.

Leaves are ordered by sorted key, which is `jax.tree.flatten`'s order for
a dict, and keep the reference's shapes, so a row means the same thing
in both packages:

    spec = make_flat_spec(params)           # from one replica
    flat = ravel(spec, params)              # (T,)
    back = unravel(spec, flat)              # views into `flat`
    mat  = ravel_stacked(spec, stacked)     # leaves (N, ...) -> (N, T)

`unravel` and `unravel_stacked` return views (slices and reshapes, no
copy), so autograd through `loss(unravel(spec, row))` yields the flat
gradient with no extra arithmetic.
"""

from __future__ import annotations

import dataclasses
import math

import torch

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Layout of a flat dict of tensors inside one flat vector."""

    names: tuple[str, ...]                # sorted leaf keys
    shapes: tuple[tuple[int, ...], ...]
    offsets: tuple[int, ...]              # start of each leaf
    size: int                             # T — total number of elements


def make_flat_spec(params: Params) -> FlatSpec:
    names = tuple(sorted(params))
    shapes = tuple(tuple(params[k].shape) for k in names)
    sizes = [math.prod(s) for s in shapes]
    offsets, off = [], 0
    for n in sizes:
        offsets.append(off)
        off += n
    return FlatSpec(names=names, shapes=shapes, offsets=tuple(offsets),
                    size=off)


def ravel(spec: FlatSpec, params: Params) -> torch.Tensor:
    """Dict -> (T,) fp32 in spec order (a new tensor)."""
    return torch.cat([params[k].to(torch.float32).reshape(-1)
                      for k in spec.names])


def unravel(spec: FlatSpec, flat: torch.Tensor) -> Params:
    """(T,) -> dict of views into ``flat``."""
    return {k: flat[off:off + math.prod(shape)].view(shape)
            for k, shape, off in zip(spec.names, spec.shapes, spec.offsets)}


def ravel_stacked(spec: FlatSpec, params: Params) -> torch.Tensor:
    """Dict with a leading stack axis on every leaf -> (N, T)."""
    n = params[spec.names[0]].shape[0]
    return torch.cat([params[k].to(torch.float32).reshape(n, -1)
                      for k in spec.names], dim=1)


def unravel_stacked(spec: FlatSpec, flat: torch.Tensor) -> Params:
    """(N, T) -> dict of views with leading axis N on every leaf."""
    n = flat.shape[0]
    return {k: flat[:, off:off + math.prod(shape)].view((n,) + shape)
            for k, shape, off in zip(spec.names, spec.shapes, spec.offsets)}
