"""Round plans for DPASGD over multigraph states (counterpart of the
planning half of `repro.fl.dpasgd`).

Every communication round does three things on the N silo replicas:
local SGD, a refresh of the edge buffers on the round's STRONG pairs,
and the Eq. 6 aggregation w_i <- A[i,i] w_i + sum_j A[i,j] buf[j->i],
where A is the Metropolis-Hastings matrix of the OVERLAY and buf[j->i]
holds w_j fresh if the edge was strong this round and stale otherwise.
A `RoundPlan` is that schedule as host-side arrays. The static designs
(star, MST, dMBST, ring) and MATCHA's sampled matchings train through
the same round with their own per-round strong masks and coefficients.

`fl_round_step` is the per-round runtime over per-leaf stacked trees:
the legacy runtime of `run_fl`, which the flat whole-cycle runtime
(`fl/runtime.py`) is held against bit for bit, and the LLM trainer's
round (`launch/train.run_reduced_fl`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import timing
from repro_torch.core.consensus import metropolis_weights
from repro_torch.core.delay import Workload
from repro_torch.core.graph import MultigraphState, SimpleGraph
from repro_torch.design.catalog import build_topology, ring_topology
from repro_torch.fl.flat import Params
from repro_torch.kernels.gossip_combine.ops import (Segment, csr_sort,
                                                    refresh_aggregate)
from repro_torch.launch.mesh import tree_leaves, tree_map
from repro_torch.networks.zoo import NetworkSpec


@dataclasses.dataclass
class RoundPlan:
    """Static per-round aggregation plan over directed edges 0..2E-1."""

    src: np.ndarray          # (2E,) int32
    dst: np.ndarray          # (2E,) int32
    strong: np.ndarray       # (R, 2E) bool — refresh buffer this round?
    coeffs: np.ndarray       # (R, 2E) f32  — A[dst, src] this round
    diag: np.ndarray         # (R, N) f32   — A[i, i] this round
    aggregate: np.ndarray    # (R,) bool    — aggregation round at all?

    @property
    def num_rounds_cycle(self) -> int:
        return self.strong.shape[0]


def _directed_edges(graph: SimpleGraph):
    src, dst = [], []
    for i, j in graph.pairs:
        src += [i, j]
        dst += [j, i]
    return np.asarray(src, np.int32), np.asarray(dst, np.int32)


def multigraph_plan(net: NetworkSpec, tplan: timing.TimingPlan
                    ) -> tuple[RoundPlan, list[MultigraphState], SimpleGraph]:
    """Plan for the paper's multigraph: overlay MH weights and per-state
    strong masks (weak edges keep their coefficient but read stale
    buffers). States and overlay come from the TimingPlan that also
    drives the wall-clock axis."""
    overlay = tplan.overlay
    states = list(tplan.states)
    src, dst = _directed_edges(overlay)
    a = metropolis_weights(overlay)
    r = len(states)
    e2 = len(src)
    strong = np.zeros((r, e2), bool)
    coeffs = np.zeros((r, e2), np.float32)
    diag = np.zeros((r, net.num_silos), np.float32)
    for k, st in enumerate(states):
        et = st.edge_type
        for e in range(e2):
            i, j = int(src[e]), int(dst[e])
            p = (i, j) if i < j else (j, i)
            strong[k, e] = bool(et[p])
            coeffs[k, e] = a[j, i]  # weight of src model in dst's average
        diag[k] = np.diag(a)
    plan = RoundPlan(src=src, dst=dst, strong=strong, coeffs=coeffs,
                     diag=diag, aggregate=np.ones((r,), bool))
    return plan, states, overlay


def static_plan(graph: SimpleGraph) -> RoundPlan:
    """Every round: all edges strong, MH coefficients of the graph."""
    src, dst = _directed_edges(graph)
    a = metropolis_weights(graph)
    coeffs = np.asarray([a[int(d), int(s)] for s, d in zip(src, dst)],
                        np.float32)
    return RoundPlan(
        src=src, dst=dst,
        strong=np.ones((1, len(src)), bool),
        coeffs=coeffs[None],
        diag=np.diag(a)[None].astype(np.float32),
        aggregate=np.ones((1,), bool))


def matcha_plan(design, num_nodes: int, rounds: int) -> RoundPlan:
    """Per-round sampled matchings over the union of the matchings:
    coefficients are MH of the round's active graph, inactive edges get
    coefficient 0, and a round with no active pair keeps diag 1."""
    base_pairs = sorted({p for m in design.matchings for p in m})
    base = SimpleGraph(num_nodes=num_nodes, pairs=tuple(base_pairs))
    src, dst = _directed_edges(base)
    e2 = len(src)
    strong = np.zeros((rounds, e2), bool)
    coeffs = np.zeros((rounds, e2), np.float32)
    diag = np.ones((rounds, num_nodes), np.float32)
    pair_index = {p: ei for ei, p in enumerate(base.pairs)}
    for k in range(rounds):
        g = design.round_graph(k)
        if not g.pairs:
            continue
        a = metropolis_weights(g)
        for p in g.pairs:
            ei = pair_index[p]
            i, j = p
            strong[k, 2 * ei] = strong[k, 2 * ei + 1] = True
            coeffs[k, 2 * ei] = a[j, i]
            coeffs[k, 2 * ei + 1] = a[i, j]
        diag[k] = np.diag(a)
    return RoundPlan(src=src, dst=dst, strong=strong, coeffs=coeffs,
                     diag=diag, aggregate=np.ones((rounds,), bool))


def make_round_schedule(topology: str, net: NetworkSpec, wl: Workload, *,
                        t: int = 5, rounds: int = 1, seed: int = 0,
                        multiplicity=None,
                        ) -> tuple[RoundPlan, timing.TimingPlan]:
    """(RoundPlan, TimingPlan) for any topology of the paper's Table 1,
    built from one schedule.

    ``multiplicity`` (multigraph only) trains an explicit multiplicity
    vector aligned with the overlay's pairs in place of Algorithm 1's;
    Algorithm 1's own vector gives the default plan bit for bit.
    MATCHA's plan has ``rounds`` rows, one per round of the run; star,
    MST, dMBST and ring have one row, repeated every round.
    """
    if topology == "multigraph":
        if multiplicity is not None:
            tplan = timing.multiplicity_vector_plan(
                net, wl, ring_topology(net, wl).graph, multiplicity,
                name="multigraph(searched)")
        else:
            tplan = timing.multigraph_timing_plan(net, wl, t=t)
        plan, _, _ = multigraph_plan(net, tplan)
        return plan, tplan
    if multiplicity is not None:
        raise ValueError("multiplicity vectors only apply to the "
                         f"multigraph topology, not {topology!r}")
    if topology == "star":
        design = build_topology("star", net, wl)
        return (static_plan(design.round_graph(0)),
                timing.star_timing_plan(net, wl))
    matcha = topology.startswith("matcha")
    design = build_topology(topology, net, wl,
                            **({"seed": seed} if matcha else {}))
    if matcha:
        # One counter-based activation sequence feeds both plans: the
        # RoundPlan trains on round_graph(k) and the TimingPlan times
        # the same rows, every round sampled.
        tplan = timing.sampled_timing_plan(topology, net, wl, design,
                                           sample_rounds=max(rounds, 1))
        return matcha_plan(design, net.num_silos, rounds), tplan
    g = design.round_graph(0)
    if topology == "ring":
        return static_plan(g), timing.ring_timing_plan(net, wl, graph=g)
    return static_plan(g), timing.static_timing_plan(topology, net, wl, g)


# ---------------------------------------------------------------------------
# The legacy per-round runtime over per-leaf stacked trees
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FLSimState:
    """silo_params: leaves (N, ...); opt_state: the per-leaf optimizer's
    state; buffers: leaves (2E, ...) in the plan's ORIGINAL edge order
    (buffers[e] = last weights of src(e) seen by dst(e))."""

    silo_params: Params
    opt_state: Any
    buffers: Params


def init_fl_state(params0: Params, opt, num_silos: int,
                  src: np.ndarray) -> FLSimState:
    """Every silo starts from ``params0`` (the standard FL assumption);
    buffers start as the sources' leaves. The state lives on
    ``params0``'s device."""
    silo_params = tree_map(
        lambda x: x[None].expand(num_silos, *x.shape).clone(), params0)
    src = np.asarray(src)
    return FLSimState(silo_params, opt.init(silo_params), tree_map(
        lambda w: w[torch.as_tensor(src, dtype=torch.long, device=w.device)],
        silo_params))


class CsrTables(NamedTuple):
    """A plan's edges dst-sorted by `csr_sort`, as the flat runtime
    orders them, on one device: ``order`` (2E,) long, the same as int32
    (``edge_row``: the kernel reads the buffers in original edge order
    through it), ``src[order]`` int32 and ``row_ptr`` (N+1,) int32."""

    order: torch.Tensor
    edge_row: torch.Tensor
    src: torch.Tensor
    row_ptr: torch.Tensor


def csr_tables(plan_src, plan_dst, n: int, device) -> CsrTables:
    """`CsrTables` of a plan's (2E,) host arrays on ``device``. A run
    builds them once and hands them to every `fl_round_step`."""
    order, row_ptr = csr_sort(np.asarray(plan_dst), n)
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return CsrTables(on(order, torch.long), on(order, torch.int32),
                     on(np.asarray(plan_src)[order], torch.int32),
                     on(row_ptr, torch.int32))


def fl_round_step(state: FLSimState, batches, plan_src, plan_dst,
                  strong, coeffs, diag, *, loss_fn, opt, local_updates: int,
                  lr_scale: float = 1.0, csr: CsrTables | None = None
                  ) -> tuple[FLSimState, torch.Tensor]:
    """One communication round over per-leaf stacked trees.

    batches: a dict of tensors (u, N, b, ...), one micro batch per local
    update per silo, handed to ``loss_fn`` per silo as the dict of their
    [u, silo] slices (``x``/``y`` for the paper's models; ``tokens``,
    ``labels`` and ``prefix_embeds`` for the LLMs); plan_src / plan_dst:
    the plan's (2E,) host arrays; strong (2E,) bool, coeffs (2E,) and
    diag (N,): this round's tensors in the plan's original edge order,
    on the state's device. The local step is `torch.func.vmap` of
    ``loss_fn``'s gradient over the silos. Then every leaf (fp32, the
    kernel's type, reshaped to (N, -1)) refreshes and aggregates in ONE
    `refresh_aggregate` call, one segment a leaf, over the edges
    dst-sorted by a stable sort as the flat runtime orders them, its
    buffers read and written in their original order through
    ``edge_row``: the fused CUDA kernel on a card (one launch), its plain
    version on the CPU, bit-equal to each other; never `index_add_`,
    whose atomics on CUDA add in a varying order. ``csr``: the plan's
    `csr_tables` on the state's device (None: built from plan_src and
    plan_dst in this call; a run builds them once).

    The call consumes ``state``: its buffers are refreshed in place and
    become the returned state's (a run owns them: `init_fl_state` makes
    new ones), so a caller that keeps a state to compare or replay hands
    in a copy. Returns the state and the round's mean loss (a 0-d
    tensor).
    """
    w, os_ = state.silo_params, state.opt_state
    tree_grads = torch.func.vmap(torch.func.grad_and_value(loss_fn))
    losses = []
    with torch.no_grad():
        for u in range(local_updates):
            grads, loss = tree_grads(w, {k: v[u] for k, v in batches.items()})
            w, os_ = opt.update(w, grads, os_, lr_scale)
            losses.append(loss)
        n, e2 = diag.shape[0], len(plan_dst)
        if csr is None:
            csr = csr_tables(plan_src, plan_dst, n, strong.device)
        coeffs_sorted, strong_sorted = coeffs[csr.order], strong[csr.order]
        # reshape keeps a contiguous leaf's storage: the buffers written
        # are the state's own
        bufs = [b.reshape(e2, -1) for b in tree_leaves(state.buffers)]
        outs = iter(refresh_aggregate([
            Segment(x.reshape(n, -1), b, coeffs_sorted, csr.row_ptr,
                    diag.contiguous(), src=csr.src, strong=strong_sorted,
                    edge_row=csr.edge_row)
            for x, b in zip(tree_leaves(w), bufs)]))
        w = tree_map(lambda x: next(outs).view(x.shape), w)
        bufs = iter(bufs)
        buffers = tree_map(lambda b: next(bufs).view(b.shape),
                           state.buffers)
    return FLSimState(w, os_, buffers), torch.stack(losses).mean()
