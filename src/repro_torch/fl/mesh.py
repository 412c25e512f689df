"""Mesh-sharded flat FL runtime (counterpart of `repro.fl.mesh`,
DESIGN.md §16).

The flat runtime (fl/runtime.py) packs all N silo replicas into one
(N, T) matrix and the 2E directed-edge buffers into one dst-sorted
(2E, T) matrix. This module runs the SAME cycle split over a shard axis
(`launch/mesh.StackedShards`: D shards in one process on one device;
`GroupShards`: one shard per rank of a process group) against the
single-device runtime, which stays the oracle: bit for bit equal to it
wherever the gradient batches match (below), so always on the CPU and on
the stacked binding:

  * silos shard in contiguous blocks -- shard p owns param rows
    ``[p*per, (p+1)*per)``, N padded at the top to ``Np = D*per``
    (`launch/mesh.silo_assignment`); pad rows retrain silo 0's batch and
    are never read;
  * edges are DST-sharded: because the flat runtime keeps edges sorted
    by destination, each shard's edges are one contiguous slice of the
    sorted order, padded per shard to ``e_per`` rows. Pad edges carry
    ``strong=False`` and coefficient 0, and sit past the end of the
    shard's row pointer, built from its real edges only, so the
    aggregation never reads or writes them: they do not touch the sums,
    not even as +0.0, which is what keeps the sharded and flat programs
    bit-identical (the reference's `segment_sum` drops them by giving
    them the out-of-range destination ``per``);
  * per round, local SGD runs on the process's own rows (one batched
    gradient call over all its local shards' silos, pad rows included:
    on a card cuDNN picks its grouped-convolution algorithm by the number
    of silos batched, and 2 or 3 of them get another than the flat
    runtime's 11, while 11, 12 and 16 get the same: NCCL ranks that hold
    a few silos each are expected to differ from the flat run in the
    last bits),
    the source rows of each shard's edges are fetched by one of two
    `fl/gossip.py` collectives -- `csr_gather_all` (all_gather baseline)
    or `csr_gather_halo` (a halo exchange moving only boundary-crossing
    rows, planned here once from the CSR structure) -- and the refresh
    and aggregation stay shard-local: one `refresh_aggregate` call a
    round over the process's local shards, one segment each (the fused
    CUDA kernel on a card: one launch a round for any D on the stacked
    binding, as for the one shard of a group rank);
  * the cycle function keeps the single-device signature ``cycle(state,
    batches, strong, coeffs, diag)`` with plan slices in the oracle's
    dst-sorted layout (the padding and permuting happen inside), so the
    trainer's loop and the controller's live schedule swaps run it
    unchanged.

`block_layout`, `_build_halo` and `HaloPlan` are the reference's numpy,
copied: the tables are the reference's, table for table.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.fl import flat as flatmod
from repro_torch.fl import gossip
from repro_torch.fl import runtime as flrt
from repro_torch.fl.runtime import FlatFLState, FlatRuntime
from repro_torch.kernels.gossip_combine import ops as gossip_ops
from repro_torch.kernels.gossip_combine.ref import (Segment,
                                                    refresh_aggregate_ref)
from repro_torch.launch import mesh as meshmod


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static halo exchange plan, derived once from the CSR edges.

    For each active shard offset o, every shard q sends the local rows
    ``send_idx[k][q]`` to shard ``(q+o) % D`` in one exchange; a shard's
    needed source rows are then picked out of the concat
    ``[own rows | halo(o1) | halo(o2) | ...]`` by ``gather_idx``. Offsets
    nobody needs issue no exchange at all.
    """

    offsets: tuple[int, ...]            # active offsets, ascending
    send_idx: tuple[np.ndarray, ...]    # per offset: (D, H_o) local rows
    perms: tuple[tuple[tuple[int, int], ...], ...]
    gather_idx: np.ndarray              # (D, e_per) into the concat

    @property
    def halo_rows(self) -> int:
        """Rows moved per shard per round (the exchange traffic)."""
        return int(sum(t.shape[1] for t in self.send_idx))


@dataclasses.dataclass(frozen=True)
class MeshRuntime:
    """Sharded twin of `FlatRuntime`: the flat runtime ``rt`` (its plan
    and spec; callers keep passing plan slices in its dst-sorted layout)
    laid out in blocks over the shard axis."""

    rt: FlatRuntime
    axis: object              # launch/mesh.StackedShards | GroupShards
    assign: meshmod.SiloAssignment
    mspec: flatmod.MeshFlatSpec
    edge_counts: np.ndarray   # (D,) real edges per shard
    edge_perm: np.ndarray     # (E_pad,) -> sorted edge idx, sentinel 2E = pad
    dst_local: np.ndarray     # (D, e_per) int32; pad -> per
    src_global: np.ndarray    # (D, e_per) int32 global src row; pad -> 0
    halo: HaloPlan

    # ---- mesh geometry ----------------------------------------------
    @property
    def num_shards(self) -> int:
        return self.assign.num_shards

    @property
    def per_rows(self) -> int:
        return self.assign.per_shard

    @property
    def edges_per_shard(self) -> int:
        return int(self.dst_local.shape[1])

    def shard_row_ptr(self, p: int) -> np.ndarray:
        """(per+1,) int32 CSR offsets of shard p's REAL edges: its pad
        edges lie past ``row_ptr[per]`` and are never read."""
        c = int(self.edge_counts[p])
        rp = np.zeros(self.per_rows + 1, np.int32)
        rp[1:] = np.cumsum(np.bincount(self.dst_local[p, :c],
                                       minlength=self.per_rows))
        return rp


def _build_halo(counts: np.ndarray, src_global: np.ndarray, d: int,
                per: int) -> HaloPlan:
    """Derive the exchange plan from each shard's edge source rows."""
    e_per = src_global.shape[1]
    # sends[o][q]: sorted unique local rows shard q ships to (q+o) % d
    sends: dict[int, list[np.ndarray]] = {}
    for o in range(1, d):
        per_sender = []
        for q in range(d):
            p = (q + o) % d
            srcs = src_global[p, :int(counts[p])]
            mine = np.unique(srcs[srcs // per == q]) % per
            per_sender.append(mine.astype(np.int32))
        if any(len(x) for x in per_sender):
            sends[o] = per_sender
    offsets = tuple(sorted(sends))
    send_idx = []
    for o in offsets:
        h = max(len(x) for x in sends[o])
        tbl = np.zeros((d, h), np.int32)  # short senders resend row 0
        for q, x in enumerate(sends[o]):
            tbl[q, :len(x)] = x
        send_idx.append(tbl)
    base = {}
    acc = per
    for o, tbl in zip(offsets, send_idx):
        base[o] = acc
        acc += tbl.shape[1]
    gather_idx = np.zeros((d, e_per), np.int32)
    for p in range(d):
        for k in range(int(counts[p])):
            s = int(src_global[p, k])
            q = s // per
            if q == p:
                gather_idx[p, k] = s % per
            else:
                o = (p - q) % d
                pos = int(np.searchsorted(sends[o][q], s % per))
                gather_idx[p, k] = base[o] + pos
    perms = tuple(tuple((q, (q + o) % d) for q in range(d)) for o in offsets)
    return HaloPlan(offsets=offsets, send_idx=tuple(send_idx), perms=perms,
                    gather_idx=gather_idx)


def block_layout(dst_sorted: np.ndarray, src_sorted: np.ndarray, d: int,
                 per: int) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
    """Per-shard edge tables for a contiguous block row layout.

    Returns (counts (D,), edge_perm (D*e_per,), dst_local (D, e_per),
    src_global (D, e_per)); pad edges get `edge_perm = 2E` (sentinel),
    local dst `per` and global src 0.
    """
    e2 = int(dst_sorted.shape[0])
    # dst-sorted => each shard's edges are one contiguous run
    bounds = np.searchsorted(dst_sorted, np.arange(d + 1) * per)
    counts = np.diff(bounds).astype(np.int64)
    e_per = int(counts.max()) if d > 0 and counts.size else 0
    edge_perm = np.full((d * e_per,), e2, np.int64)
    dst_local = np.full((d, e_per), per, np.int32)
    src_global = np.zeros((d, e_per), np.int32)
    for p in range(d):
        c, lo = int(counts[p]), int(bounds[p])
        edge_perm[p * e_per: p * e_per + c] = np.arange(lo, lo + c)
        dst_local[p, :c] = dst_sorted[lo:lo + c] - p * per
        src_global[p, :c] = src_sorted[lo:lo + c]
    return counts, edge_perm, dst_local, src_global


def make_mesh_runtime(rt: FlatRuntime, mesh=None, *,
                      device=None) -> MeshRuntime:
    """Lay the runtime's CSR plan out over a shard axis, host-side.

    ``mesh`` is what `launch/mesh.shard_axis` takes: an int D (D stacked
    shards on ``device``), "auto" or None (the default process group if
    one is initialised, else one stacked shard), or a shard axis. All
    index tables -- block bounds, pad edges, the halo exchange -- are
    derived here once; nothing about the layout depends on which
    schedule the cycle later runs.
    """
    axis = meshmod.shard_axis(mesh, device)
    assign = meshmod.silo_assignment(rt.num_silos, axis)
    d, per = assign.num_shards, assign.per_shard
    counts, edge_perm, dst_local, src_global = block_layout(
        rt.dst_sorted, rt.src_sorted, d, per)
    mspec = flatmod.MeshFlatSpec(spec=rt.spec, num_shards=d,
                                 rows_padded=assign.rows_padded,
                                 edges_padded=int(edge_perm.shape[0]),
                                 local=tuple(axis.local_shards()))
    return MeshRuntime(rt=rt, axis=axis, assign=assign, mspec=mspec,
                       edge_counts=counts, edge_perm=edge_perm,
                       dst_local=dst_local, src_global=src_global,
                       halo=_build_halo(counts, src_global, d, per))


def init_mesh_state(w0: torch.Tensor, opt, mrt: MeshRuntime) -> FlatFLState:
    """Mirror of `init_flat_state` in the padded block layout: every row,
    pad rows included, and every edge buffer starts as ``w0`` (T,), on
    the shard axis's device (``w0``'s if it names none)."""
    k = len(mrt.mspec.local)
    w0 = w0.to(device=mrt.axis.device or w0.device, dtype=torch.float32)
    w = w0.repeat(k * mrt.per_rows, 1)
    return FlatFLState(w, opt.init(w), w0.repeat(k * mrt.edges_per_shard, 1))


def gather_flat_state(mrt: MeshRuntime, state: FlatFLState) -> FlatFLState:
    """Mesh-layout state -> the oracle's single-device layout.

    Gathers every shard's blocks (a collective over a group: every rank
    calls it), drops pad rows and maps the block-padded edge buffers back
    to the dst-sorted order; the result compares bit for bit against a
    single-device `FlatFLState`.
    """
    n = mrt.rt.num_silos
    real = np.flatnonzero(mrt.edge_perm < mrt.rt.dst_sorted.shape[0])

    def full(x):
        return mrt.axis.all_gather(mrt.mspec.split(x), count=False)[0]

    def unpad(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and \
                mrt.mspec.local_rows(x.shape[0]) is not None:
            return full(x)[:n]
        return x

    buffers = full(state.buffers)
    return FlatFLState(
        full(state.w)[:n],
        {k: unpad(v) for k, v in state.opt_state.items()},
        buffers[torch.as_tensor(real, device=buffers.device)])


def make_mesh_cycle_fn(mrt: MeshRuntime, *, loss_fn: Callable, opt,
                       lr_scale: float = 1.0, gossip_backend: str = "halo",
                       aggregator: str = "kernel", metrics=None):
    """Sharded twin of `runtime.make_cycle_fn`, with its contract.

    Returns ``cycle(state, batches, strong, coeffs, diag)`` taking plan
    slices in the ORACLE's dst-sorted layout ((R, 2E) / (R, N)) and
    batches whose tensors lead with (R, u, N); each process passes the
    whole batches and plan slices, and its shards read their own rows.

    gossip_backend: "halo" (exchange of boundary-crossing rows, the
    optimized path) or "all_gather" (full-matrix baseline). Both are bit
    for bit equal to the oracle: they differ only in how the same source
    rows reach the shard. aggregator: "kernel" (`ops.refresh_aggregate`,
    the fused CUDA kernel on a card, one launch a round over the local
    shards) or "reference" (its plain version). A cycle call clones the
    buffers once and refreshes the clone in place.

    Losses are each round's mean over local steps and the REAL silos, at
    the flat runtime's (u, N) reduce shape. metrics: an `obs.MetricsSpec`,
    the flat runtime's contract with one more column, `fabric_bytes`
    (`fabric_rows_per_round` times the row size); the norms are summed
    shard by shard, so they may differ from the flat runtime's in the
    last bits, while the state stays bit-equal.
    """
    if gossip_backend not in ("halo", "all_gather"):
        raise ValueError(f"unknown gossip backend {gossip_backend!r}")
    if aggregator not in ("kernel", "reference"):
        raise ValueError("the mesh runtime aggregates per shard through "
                         f"refresh_aggregate; aggregator={aggregator!r} is "
                         "single-device only")
    aggregate = (gossip_ops.refresh_aggregate if aggregator == "kernel"
                 else refresh_aggregate_ref)
    rt, axis, mspec = mrt.rt, mrt.axis, mrt.mspec
    n, per, e_per = rt.num_silos, mrt.per_rows, mrt.edges_per_shard
    rows_padded = mspec.rows_padded
    local = mspec.local
    # the local shards are consecutive: their silo rows are one slice
    own = slice(local[0] * per, (local[-1] + 1) * per)
    # real rows of each local shard's block (pad rows sit at the end)
    real_rows = [min(per, max(0, n - p * per)) for p in local]
    ms = metrics
    if ms is not None:
        fabric_bytes = gossip.fabric_rows_per_round(
            gossip_backend, halo_rows=mrt.halo.halo_rows,
            num_shards=mrt.num_shards,
            rows_padded=rows_padded) * float(rt.spec.size * 4)
    on_device: dict[torch.device, dict] = {}

    def tables(dev):
        if dev not in on_device:
            long = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long,
                                             device=dev)
            on_device[dev] = dict(
                edge_perm=long(mrt.edge_perm),
                src=[long(mrt.src_global[p]) for p in local],
                gather=[long(mrt.halo.gather_idx[p]) for p in local],
                sends=[long(t) for t in mrt.halo.send_idx],
                row_ptr=[torch.as_tensor(mrt.shard_row_ptr(p), device=dev)
                         for p in local],
                edges=[slice(p * e_per, (p + 1) * e_per) for p in local],
                rows=[slice(p * per, (p + 1) * per) for p in local])
        return on_device[dev]

    silo_grads = flrt.silo_grad_fn(rt.spec, loss_fn)

    def real_sq(x):
        """Sum of squares over the real silo rows, added shard by shard
        in shard order."""
        parts = [torch.sum(torch.square(b[:m]))
                 for b, m in zip(mspec.split(x), real_rows)]
        return axis.all_gather([v.reshape(1) for v in parts],
                               count=False)[0].sum()

    def pad_batch(v):
        if rows_padded == n:
            return v
        # pad silos retrain silo 0's batch
        tile = v[:, :, :1].expand(
            (-1, -1, rows_padded - n) + tuple(v.shape[3:]))
        return torch.cat([v, tile], dim=2)

    @torch.no_grad()
    def cycle(state: FlatFLState, batches, strong, coeffs, diag):
        dev = state.w.device
        tb = tables(dev)
        rounds = strong.shape[0]
        # oracle layout -> block layout: the appended column is the pad
        # edges' strong=False / coefficient 0
        strong_p = torch.cat([strong, strong.new_zeros((rounds, 1))],
                             1)[:, tb["edge_perm"]]
        coeffs_p = torch.cat([coeffs, coeffs.new_zeros((rounds, 1))],
                             1)[:, tb["edge_perm"]]
        diag_p = diag.contiguous() if rows_padded == n else torch.cat(
            [diag, diag.new_ones((rounds, rows_padded - n))], 1)
        batches_p = {k: pad_batch(v) for k, v in batches.items()}
        local_updates = next(iter(batches.values())).shape[1]
        w, os_, buf = state.w, state.opt_state, state.buffers.clone()
        buf_blocks = mspec.split(buf)
        losses, rows = [], []
        if ms is not None:
            taps = flrt.round_taps(ms, rt, dev, sq=real_sq, extra={
                "fabric_bytes": torch.full((), fabric_bytes, device=dev)})
        for r in range(rounds):
            w0 = w
            w, os_, round_loss, gsq = flrt.local_sgd(
                silo_grads, opt, lr_scale, w, os_, local_updates,
                lambda u: {k: v[r, u, own] for k, v in batches_p.items()},
                grad_sq=real_sq if ms is not None and ms.grad_norm else None)
            w_blocks = mspec.split(w)
            if gossip_backend == "halo":
                src_rows = gossip.csr_gather_halo(
                    axis, w_blocks, tb["sends"], mrt.halo.perms, tb["gather"])
            else:
                src_rows = gossip.csr_gather_all(axis, w_blocks, tb["src"])
            w = torch.empty_like(w)
            aggregate([
                Segment(w_p, b_p, coeffs_p[r, es], rp, diag_p[r, rs],
                        fresh=fresh, strong=strong_p[r, es], out=o_p)
                for w_p, b_p, fresh, o_p, rp, es, rs in zip(
                    w_blocks, buf_blocks, src_rows, mspec.split(w),
                    tb["row_ptr"], tb["edges"], tb["rows"])])
            # every shard's (per, u) losses -> the real silos' (u, N)
            per_silo = axis.all_gather(mspec.split(round_loss.T),
                                       count=False)[0]
            round_loss = per_silo[:n].T.contiguous()
            losses.append(round_loss.mean())
            if ms is not None:
                rows.append(taps(strong[r], w0, w, gsq, round_loss))
        out = (FlatFLState(w, os_, buf), torch.stack(losses))
        if ms is None:
            return out
        return out + (torch.stack(rows),)

    if ms is not None:
        cycle.metric_columns = ms.columns(n, mesh=True)
    return cycle
