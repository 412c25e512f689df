"""Collective bytes of a step, counted as it runs (counterpart of
`repro.launch.hlo_analysis`).

The reference parses the compiled HLO and sums the operand sizes of
every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute, weighting a `while` body by its trip count. The port
has no HLO: a sharded step is eager DTensor code, and every collective it
issues passes the dispatcher as a `_c10d_functional` op (what DTensor's
redistributions and `torch.distributed._functional_collectives` issue) or
as a point-to-point `c10d.send` / `c10d.recv_`. `CollectiveCounter` is a
dispatch mode that sees them on each rank's local tensors (it steps aside
for DTensor ops, so DTensor turns them into local ops and collectives
first) and counts, per kind, the OPERAND bytes, as the reference's
`_collect_ops` does: an all-gather counts the local shard it sends, not
the gathered tensor; a point-to-point exchange counts the sent tensors
(a receive moves the same bytes, counted once at its send). It also keeps
the bytes by mesh axis, so the pod axis can be read alone.

Eager Python unrolls every loop, so each trip is counted where it runs:
`while_trip_counts` has nothing to report and returns {}.

Kind names are the reference's; a collective outside its five kinds
(a broadcast) is counted under its own op name.

On a host mesh (device type "cpu") DTensor turns a shard-to-shard move
into an all-gather of the same operand (gloo has no all-to-all), so
those bytes count as "all-gather" where the reference's HLO says
"all-to-all".
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: op name (without overload) -> kind; the `c10d` point-to-point receive is
#: left out (its bytes are counted at the send), and so are the waits
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d", "_dtensor")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _group_name(func, args) -> str | None:
    if func.namespace == "c10d":  # (tensors, process_group, peer, tag)
        from torch._C._distributed_c10d import ProcessGroup

        for a in args:
            if isinstance(a, torch.ScriptObject):
                return ProcessGroup.unbox(a).group_name
        return None
    for a in args[1:]:
        if isinstance(a, str) and a not in ("sum", "avg", "max", "min",
                                            "product"):
            return a
    return None


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict
    total_bytes: int
    details: list
    bytes_by_axis: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> dict:
        return {"total_bytes": self.total_bytes,
                "by_kind": dict(self.bytes_by_kind),
                "counts": dict(self.count_by_kind),
                "by_axis": dict(self.bytes_by_axis)}


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives run under it (see the module docstring).
    ``meshes``: the `DeviceMesh`es whose dim names label the groups in
    ``bytes_by_axis`` (a sub-mesh shares its parent's groups); a group of
    none of them is labelled by its group name. ``details`` keeps one
    record per collective."""

    def __init__(self, *meshes):
        super().__init__()
        self.axis_of = {}
        for mesh in meshes:
            for i, name in enumerate(mesh.mesh_dim_names):
                self.axis_of[mesh.get_group(i).group_name] = name
        self.bytes_by_kind = defaultdict(int)
        self.count_by_kind = defaultdict(int)
        self.bytes_by_axis = defaultdict(int)
        self.details = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor desugar it into local ops
        kind = (_KINDS.get(func._opname)
                if func.namespace in _NAMESPACES else None)
        if kind is not None:
            nbytes = sum(t.numel() * t.element_size()
                         for t in _tensors(args[0]))
            group = _group_name(func, args)
            axis = self.axis_of.get(group, group)
            self.bytes_by_kind[kind] += nbytes
            self.count_by_kind[kind] += 1
            self.bytes_by_axis[axis] += nbytes
            self.details.append({"kind": kind, "bytes": nbytes,
                                 "axis": axis, "op": str(func)})
        return func(*args, **kwargs)

    def stats(self) -> CollectiveStats:
        return CollectiveStats(
            bytes_by_kind=dict(self.bytes_by_kind),
            count_by_kind=dict(self.count_by_kind),
            total_bytes=sum(self.bytes_by_kind.values()),
            details=list(self.details),
            bytes_by_axis=dict(self.bytes_by_axis))


def while_trip_counts(_program=None) -> dict[str, int]:
    """{}: eager PyTorch unrolls its loops in Python, so there is no loop
    body to weight (each trip's collectives are counted as they run)."""
    return {}
