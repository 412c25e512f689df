"""Whole-cycle flat-parameter FL runtime (counterpart of
`repro.fl.runtime`).

All N silo replicas live in one `(N, T)` fp32 matrix and the 2E
directed-edge buffers in one `(2E, T)` matrix kept in dst-sorted CSR
order, so each round is three array steps:

  1. local SGD: per-silo gradients (`torch.func.vmap` over
     `grad_and_value` of the loss of the unpacked leaves, packed back
     into one (N, T) matrix), then `opt.update` on the whole matrix;
  2. refresh: the round's strong edges' buffers take their sources'
     fresh rows (``buf = where(strong, w[src], buf)``, in place), the
     weak ones keep their stale rows;
  3. aggregation: one CSR sum over the refreshed buffers.

Steps 2 and 3 are one `refresh_aggregate` call a round (the fused CUDA
kernel on a card, one launch; its plain version on the CPU).
`make_cycle_fn` runs the rounds of a cycle in a Python loop and syncs
with the host only when the caller reads the losses (and the in-cycle
metrics, when asked for). A cycle call clones the buffers once and
refreshes the clone in place: the state passed in is never written.
The legacy per-leaf runtime (`fl/dpasgd.fl_round_step`) computes the
same rounds bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.fl import flat as flatmod
from repro_torch.fl.dpasgd import RoundPlan
from repro_torch.kernels.gossip_combine import ops as gossip_ops
from repro_torch.kernels.gossip_combine.ref import (Segment,
                                                    dense_edge_aggregate,
                                                    refresh_aggregate_ref,
                                                    refresh_buffers)
from repro_torch.obs import metrics as obsmet


@dataclasses.dataclass
class FlatFLState:
    """w (N, T) flat silo params; opt_state: flat-optimizer state;
    buffers (2E, T) edge buffers in DST-SORTED order (buffers[e] = last
    weights of src(e) seen by dst(e), stale over weak edges)."""

    w: torch.Tensor
    opt_state: Any
    buffers: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FlatRuntime:
    """Host-side plan bundle: flat layout + CSR edge order."""

    spec: flatmod.FlatSpec
    num_silos: int
    order: np.ndarray        # (2E,) original-edge -> sorted position perm
    row_ptr: np.ndarray      # (N+1,) int32 CSR offsets
    src_sorted: np.ndarray   # (2E,) int32
    dst_sorted: np.ndarray   # (2E,) int32 (non-decreasing)
    strong: np.ndarray       # (R, 2E) bool, sorted edge order
    coeffs: np.ndarray       # (R, 2E) f32, sorted edge order
    diag: np.ndarray         # (R, N) f32

    @property
    def num_rounds_cycle(self) -> int:
        return self.strong.shape[0]

    def expand_pair_mask(self, pair_mask: np.ndarray) -> np.ndarray:
        """Per-PAIR (R, E) rounds mask -> this runtime's dst-sorted
        (R, 2E) directed layout (pair e owns directed edges 2e, 2e+1).
        This is how the fault layer feeds degraded strong sets to the
        cycle function: same CSR structure, another argument. A silo
        whose edges all go weak reads stale buffers, and an all-crashed
        destination row aggregates over an empty CSR row, which
        the aggregation handles by construction."""
        from repro_torch.faults.degrade import pair_rounds_to_directed
        return pair_rounds_to_directed(self.order, pair_mask)


def make_flat_runtime(plan: RoundPlan, template_params: flatmod.Params,
                      num_silos: int) -> FlatRuntime:
    """Sort the plan's directed edges by destination once, host-side.
    The per-round tables are C-contiguous, so a round's row is one
    contiguous slice (the kernel takes only contiguous inputs)."""
    spec = flatmod.make_flat_spec(template_params)
    order, row_ptr = gossip_ops.csr_sort(plan.dst, num_silos)
    return FlatRuntime(
        spec=spec, num_silos=num_silos, order=order, row_ptr=row_ptr,
        src_sorted=plan.src[order].astype(np.int32),
        dst_sorted=plan.dst[order].astype(np.int32),
        strong=np.ascontiguousarray(plan.strong[:, order]),
        coeffs=np.ascontiguousarray(plan.coeffs[:, order], np.float32),
        diag=np.ascontiguousarray(plan.diag, np.float32))


def init_flat_state(w0: torch.Tensor, opt, rt: FlatRuntime) -> FlatFLState:
    """Every silo starts from the same flat row ``w0`` (T,), the standard
    FL assumption; buffers start as the sources' rows."""
    w = w0.to(torch.float32).repeat(rt.num_silos, 1)
    src = torch.as_tensor(rt.src_sorted, dtype=torch.long, device=w.device)
    return FlatFLState(w, opt.init(w), w[src])


def silo_grad_fn(spec: flatmod.FlatSpec, loss_fn: Callable) -> Callable:
    """``silo_grads(w, batch) -> (grads (K, T), losses (K,))`` for K flat
    rows ``w`` and a batch dict whose leaves lead with K. Differentiates
    by leaf and packs once: the gradient of a flat row through `unravel`
    would add one zero-filled (T,) row per leaf."""
    tree_grads = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    def silo_grads(w, batch):
        grads, loss = tree_grads(flatmod.unravel_stacked(spec, w), batch)
        return flatmod.ravel_stacked(spec, grads), loss

    return silo_grads


def local_sgd(silo_grads: Callable, opt, lr_scale: float, w, opt_state,
              local_updates: int, batch_at: Callable, grad_sq=None):
    """One round's local steps on every row of ``w``: step u trains on
    ``batch_at(u)``. Returns ``(w, opt_state, losses (u, K), gsq)``, where
    gsq lists ``grad_sq(grads)`` of each step when ``grad_sq`` is given
    (the metric tap reads the gradients and changes nothing)."""
    losses, gsq = [], []
    for u in range(local_updates):
        grads, loss = silo_grads(w, batch_at(u))
        if grad_sq is not None:
            gsq.append(grad_sq(grads))
        w, opt_state = opt.update(w, grads, opt_state, lr_scale)
        losses.append(loss)
    return w, opt_state, torch.stack(losses), gsq


def round_taps(ms, rt: FlatRuntime, dev, *, sq: Callable, extra=None):
    """The in-cycle metric taps of one cycle call: returns
    ``row(strong_r, w0, w, gsq, round_loss) -> (K,)``, one round's row of
    ``ms``'s columns. ``sq`` is the sum of squares over the real silo
    rows; ``extra`` holds more 0-d traffic values (the mesh runtime's
    ``fabric_bytes``). The plan slices are global, so strong edges are
    counted over all 2E. Buffer age restarts with each call: "rounds
    since refresh, within this call"."""
    e2 = int(rt.dst_sorted.shape[0])
    row_bytes = float(rt.spec.size * 4)  # fp32 flat rows
    age = torch.zeros(e2, dtype=torch.float32, device=dev)
    # a divisor on the device: torch turns division by a host scalar (and
    # `mean`) on CUDA into a multiply by its reciprocal, and CPU and card
    # would round differently
    e2_t = torch.full((), float(e2), device=dev)

    def row(strong_r, w0, w, gsq, round_loss):
        nonlocal age
        vals = {}
        if ms.grad_norm:
            vals["gsq"] = torch.stack(gsq).sum()
        if ms.param_norm:
            vals["psq"] = sq(w)
        if ms.update_norm:
            vals["usq"] = sq(w - w0)
        if ms.silo_loss:
            vals["silo_loss"] = round_loss.mean(dim=0)
        n_strong = torch.sum(strong_r.to(torch.float32))
        age = torch.where(strong_r, 0.0, age + 1.0)
        if ms.staleness:
            vals["stale_frac"] = 1.0 - n_strong / e2_t
            vals["buf_age"] = torch.sum(age) / e2_t
        if ms.traffic:
            vals["gossip_bytes"] = n_strong * row_bytes
            vals.update(extra or {})
        return obsmet.assemble_row(ms, vals)

    return row


def make_cycle_fn(rt: FlatRuntime, *, loss_fn: Callable, opt,
                  lr_scale: float = 1.0, aggregator: str = "kernel",
                  gossip: str | None = None, metrics=None):
    """Build the whole-cycle step.

    Returns ``cycle(state, batches, strong, coeffs, diag) -> (state,
    losses)``: batches is a dict of tensors, each leading with (R, u, N)
    (FEMNIST's ``x`` (R, u, N, b, ...) and ``y`` (R, u, N, b), the LM's
    ``tokens``, ``labels`` and ``prefix_embeds``), and ``loss_fn(params,
    batch)`` takes one silo's slice of each; the plan slices are (R, 2E) /
    (R, N) tensors in the runtime's sorted edge order, on the state's
    device; losses (R,) is each round's mean loss over local steps and
    silos. R is whatever slice of the cycle the caller passes.

    Passing a `fl/mesh.py` MeshRuntime instead builds the SHARDED twin of
    this function (same external contract; ``gossip`` picks its
    cross-shard backend, default "halo"). ``gossip`` with a flat runtime
    raises, as in the reference.

    aggregator: "kernel" (`ops.refresh_aggregate`: the fused CUDA kernel
    for tensors on a card, one launch a round; the plain version on the
    CPU), "reference" (the plain version everywhere) or "dense" (the
    plain refresh, then `dense_edge_aggregate`, for overlays whose every
    silo has the same in-degree, e.g. any ring).

    metrics: an `obs.MetricsSpec` adds a third output, an (R, K) fp32
    tensor of per-round scalars on the state's device (column names on
    the returned function's ``metric_columns``). With ``metrics=None``
    the Python branches below add no op, so the state is bit for bit
    that of a run with metrics; the metric taps only read.
    """
    from repro_torch.fl import mesh as flmesh  # fl.mesh imports this module
    if isinstance(rt, flmesh.MeshRuntime):
        return flmesh.make_mesh_cycle_fn(
            rt, loss_fn=loss_fn, opt=opt, lr_scale=lr_scale,
            gossip_backend=gossip or "halo", aggregator=aggregator,
            metrics=metrics)
    if gossip is not None:
        raise ValueError("gossip= selects the MESH runtime's cross-shard "
                         "backend; pass a MeshRuntime to use it")
    if aggregator not in ("kernel", "reference", "dense"):
        raise ValueError(f"aggregator must be 'kernel', 'reference' or "
                         f"'dense', got {aggregator!r}")
    if aggregator == "dense":
        degrees = np.diff(rt.row_ptr)
        if degrees.size == 0 or (degrees != degrees[0]).any():
            raise ValueError("aggregator='dense' needs a uniform in-degree; "
                             f"got {degrees}")
        n, deg = rt.num_silos, int(degrees[0])

        def aggregate(segments):
            seg, = segments
            buf, _, _ = refresh_buffers(seg)
            return [dense_edge_aggregate(seg.w, buf,
                                         seg.coeffs.reshape(n, deg),
                                         seg.diag)]
    else:
        aggregate = (gossip_ops.refresh_aggregate if aggregator == "kernel"
                     else refresh_aggregate_ref)
    ms = metrics
    silo_grads = silo_grad_fn(rt.spec, loss_fn)
    sq = lambda x: torch.sum(torch.square(x))
    on_device: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def cycle(state: FlatFLState, batches, strong, coeffs, diag):
        dev = state.w.device
        if dev not in on_device:
            on_device[dev] = (
                torch.as_tensor(rt.src_sorted, dtype=torch.int32, device=dev),
                torch.as_tensor(rt.row_ptr, dtype=torch.int32, device=dev))
        src, row_ptr = on_device[dev]
        # the kernel takes contiguous rows (`expand_pair_mask` gives
        # column-major masks)
        strong, coeffs, diag = (x.contiguous() for x in (strong, coeffs,
                                                         diag))
        w, os_, buf = state.w, state.opt_state, state.buffers.clone()
        local_updates = next(iter(batches.values())).shape[1]
        losses, rows = [], []
        if ms is not None:
            taps = round_taps(ms, rt, dev, sq=sq)
        for r in range(strong.shape[0]):
            w0 = w
            w, os_, round_loss, gsq = local_sgd(
                silo_grads, opt, lr_scale, w, os_, local_updates,
                lambda u: {k: v[r, u] for k, v in batches.items()},
                grad_sq=sq if ms is not None and ms.grad_norm else None)
            w, = aggregate([Segment(w, buf, coeffs[r], row_ptr, diag[r],
                                    src=src, strong=strong[r])])
            losses.append(round_loss.mean())
            if ms is not None:
                rows.append(taps(strong[r], w0, w, gsq, round_loss))
        out = (FlatFLState(w, os_, buf), torch.stack(losses))
        if ms is None:
            return out
        return out + (torch.stack(rows),)

    if ms is not None:
        cycle.metric_columns = ms.columns(rt.num_silos)
    return cycle


def unpack_params(rt: FlatRuntime, state: FlatFLState) -> flatmod.Params:
    """(N, T) -> dict of views with a leading silo axis."""
    return flatmod.unravel_stacked(rt.spec, state.w)


def unpack_buffers(rt: FlatRuntime, state: FlatFLState) -> flatmod.Params:
    """Sorted (2E, T) -> dict of (2E, ...) leaves in ORIGINAL edge order
    (the legacy runtime's layout)."""
    inv = torch.as_tensor(np.argsort(rt.order), device=state.buffers.device)
    return flatmod.unravel_stacked(rt.spec, state.buffers[inv])
