"""Whole-cycle flat-parameter FL runtime (counterpart of
`repro.fl.runtime`).

All N silo replicas live in one `(N, T)` fp32 matrix and the 2E
directed-edge buffers in one `(2E, T)` matrix kept in dst-sorted CSR
order, so each round is three array steps:

  1. local SGD: per-silo gradients (`torch.func.vmap` over
     `grad_and_value` of the loss of the unpacked leaves, packed back
     into one (N, T) matrix), then `opt.update` on the whole matrix;
  2. refresh: ``buf = where(strong, w[src], buf)``, fresh weights on the
     round's strong edges and stale ones elsewhere;
  3. aggregation: one `edge_aggregate` over the CSR rows (the CUDA kernel
     on a card, its plain version on the CPU).

`make_cycle_fn` runs the rounds of a cycle in a Python loop and syncs
with the host only when the caller reads the losses (and the in-cycle
metrics, when asked for). The legacy per-leaf runtime
(`fl/dpasgd.fl_round_step`) computes the same rounds bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.fl import flat as flatmod
from repro_torch.fl.dpasgd import RoundPlan
from repro_torch.kernels.gossip_combine import ops as gossip_ops
from repro_torch.kernels.gossip_combine.ref import (dense_edge_aggregate,
                                                    edge_aggregate_ref)
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


def make_cycle_fn(rt: FlatRuntime, *, loss_fn: Callable, opt,
                  lr_scale: float = 1.0, aggregator: str = "kernel",
                  metrics=None):
    """Build the whole-cycle step.

    Returns ``cycle(state, batches, strong, coeffs, diag) -> (state,
    losses)``: batches has tensors ``x`` (R, u, N, b, ...) and ``y``
    (R, u, N, b); the plan slices are (R, 2E) / (R, N) tensors in the
    runtime's sorted edge order, on the state's device; losses (R,) is
    each round's mean loss over local steps and silos. R is whatever
    slice of the cycle the caller passes.

    aggregator: "kernel" (`ops.edge_aggregate`: the CUDA kernel for
    tensors on a card, the plain version on the CPU), "reference" (the
    plain version everywhere) or "dense" (`dense_edge_aggregate`, for
    overlays whose every silo has the same in-degree, e.g. any ring).

    metrics: an `obs.MetricsSpec` adds a third output, an (R, K) fp32
    tensor of per-round scalars on the state's device (column names on
    the returned function's ``metric_columns``). With ``metrics=None``
    the Python branches below add no op, so the state is bit for bit
    that of a run with metrics; the metric taps only read.
    """
    if aggregator not in ("kernel", "reference", "dense"):
        raise ValueError(f"aggregator must be 'kernel', 'reference' or "
                         f"'dense', got {aggregator!r}")
    if aggregator == "dense":
        degrees = np.diff(rt.row_ptr)
        if degrees.size == 0 or (degrees != degrees[0]).any():
            raise ValueError("aggregator='dense' needs a uniform in-degree; "
                             f"got {degrees}")
        n, deg = rt.num_silos, int(degrees[0])

        def aggregate(w, buf, coeffs_r, row_ptr, diag_r):
            return dense_edge_aggregate(w, buf, coeffs_r.reshape(n, deg),
                                        diag_r)
    else:
        aggregate = (gossip_ops.edge_aggregate if aggregator == "kernel"
                     else edge_aggregate_ref)
    spec = rt.spec
    ms = metrics
    if ms is not None:
        e2 = int(rt.dst_sorted.shape[0])
        row_bytes = float(spec.size * 4)  # fp32 flat rows
    on_device: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    tree_grads = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    def silo_grads(w, batch):
        # Differentiate by leaf and pack once: the gradient of a flat row
        # through `unravel` would add one zero-filled (T,) row per leaf.
        grads, loss = tree_grads(flatmod.unravel_stacked(spec, w), batch)
        return flatmod.ravel_stacked(spec, grads), loss

    @torch.no_grad()
    def cycle(state: FlatFLState, batches, strong, coeffs, diag):
        dev = state.w.device
        if dev not in on_device:
            on_device[dev] = (
                torch.as_tensor(rt.src_sorted, dtype=torch.long, device=dev),
                torch.as_tensor(rt.row_ptr, dtype=torch.int32, device=dev))
        src, row_ptr = on_device[dev]
        w, os_, buf = state.w, state.opt_state, state.buffers
        losses = []
        if ms is not None:
            # buffer age restarts each cycle call: "rounds since refresh,
            # within this call"
            age = torch.zeros(e2, dtype=torch.float32, device=dev)
            rows = []
            # a divisor on the device: torch turns division by a host
            # scalar (and `mean`) on CUDA into a multiply by its
            # reciprocal, and CPU and card would round differently
            e2_t = torch.full((), float(e2), device=dev)
        for r in range(strong.shape[0]):
            if ms is not None:
                w0, gsq = w, []
            round_loss = []
            for u in range(batches["x"].shape[1]):
                batch = {"x": batches["x"][r, u], "y": batches["y"][r, u]}
                grads, loss = silo_grads(w, batch)
                w, os_ = opt.update(w, grads, os_, lr_scale)
                round_loss.append(loss)
                if ms is not None and ms.grad_norm:
                    gsq.append(torch.sum(torch.square(grads)))
            buf = torch.where(strong[r][:, None], w[src], buf)
            w = aggregate(w, buf, coeffs[r], row_ptr, diag[r])
            round_loss = torch.stack(round_loss)
            losses.append(round_loss.mean())
            if ms is None:
                continue
            vals = {}
            if ms.grad_norm:
                vals["gsq"] = torch.stack(gsq).sum()
            if ms.param_norm:
                vals["psq"] = torch.sum(torch.square(w))
            if ms.update_norm:
                vals["usq"] = torch.sum(torch.square(w - w0))
            if ms.silo_loss:
                vals["silo_loss"] = round_loss.mean(dim=0)
            n_strong = torch.sum(strong[r].to(torch.float32))
            age = torch.where(strong[r], 0.0, age + 1.0)
            if ms.staleness:
                vals["stale_frac"] = 1.0 - n_strong / e2_t
                vals["buf_age"] = torch.sum(age) / e2_t
            if ms.traffic:
                vals["gossip_bytes"] = n_strong * row_bytes
            rows.append(obsmet.assemble_row(ms, vals))
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
