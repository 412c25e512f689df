"""Round plans for DPASGD over multigraph states (counterpart of the
planning half of `repro.fl.dpasgd`).

Every communication round does three things on the N silo replicas:
local SGD, a refresh of the edge buffers on the round's STRONG pairs,
and the Eq. 6 aggregation w_i <- A[i,i] w_i + sum_j A[i,j] buf[j->i],
where A is the Metropolis-Hastings matrix of the OVERLAY and buf[j->i]
holds w_j fresh if the edge was strong this round and stale otherwise.
A `RoundPlan` is that schedule as host-side arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import timing
from repro_torch.core.consensus import metropolis_weights
from repro_torch.core.delay import Workload
from repro_torch.core.graph import MultigraphState, SimpleGraph
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


def make_round_schedule(topology: str, net: NetworkSpec, wl: Workload, *,
                        t: int = 5) -> tuple[RoundPlan, timing.TimingPlan]:
    """(RoundPlan, TimingPlan) built from one schedule. Only the
    multigraph with Algorithm 1's multiplicities is ported so far."""
    if topology != "multigraph":
        raise NotImplementedError(
            f"topology {topology!r}: only 'multigraph' is ported")
    tplan = timing.multigraph_timing_plan(net, wl, t=t)
    plan, _, _ = multigraph_plan(net, tplan)
    return plan, tplan
