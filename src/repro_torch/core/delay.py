"""Delay model, paper Eq. 3 (counterpart of `repro.core.delay`).

Eq. 3:  d(i,j) = u * T_c(i) + l(i,j) + M / O(i,j)
        O(i,j) = min( C_UP(i) / |N_i^out| , C_DN(j) / |N_j^in| )

At pair level the delay of an exchange between i and j is
max(d(i->j), d(j->i)): aggregation waits for both directions. The
vectorised Eq. 4/5 recurrence over rounds lives in `core/timing.py`;
`MultigraphDelayTracker` and `FaultedDelayTracker` are its scalar
twins, one round per call, kept as oracles.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.graph import (STRONG, WEAK, MultigraphState, Pair,
                                    SimpleGraph)
from repro_torch.networks.zoo import NetworkSpec


@dataclasses.dataclass(frozen=True)
class Workload:
    """Training workload parameters entering Eq. 3 (paper Table 2): model
    size M (Mbits), local updates u, and the per-silo compute time of one
    local update T_c (ms; scaled per silo by `NetworkSpec.compute_scale`).
    """

    name: str
    model_size_mbits: float
    local_updates: int
    base_compute_ms: float

    def compute_ms(self, net: NetworkSpec) -> np.ndarray:
        """u * T_c(i) for every silo."""
        return self.local_updates * self.base_compute_ms * net.compute_scale()


FEMNIST = Workload("femnist", model_size_mbits=4.62, local_updates=1, base_compute_ms=2.0)
SENTIMENT140 = Workload("sentiment140", model_size_mbits=18.38, local_updates=1, base_compute_ms=5.0)
INATURALIST = Workload("inaturalist", model_size_mbits=42.88, local_updates=1, base_compute_ms=15.0)

WORKLOADS = {w.name: w for w in (FEMNIST, SENTIMENT140, INATURALIST)}


def directed_delay_ms(net: NetworkSpec, wl: Workload, i: int, j: int,
                      out_deg_i: int, in_deg_j: int) -> float:
    """Eq. 3 for the directed transfer i -> j, given active degrees."""
    comp = wl.local_updates * wl.base_compute_ms * net.silos[i].compute_scale
    lat = float(net.latency_ms[i, j])
    # Access-link traffic capacity split over concurrent transfers (Gbps).
    cap = min(net.silos[i].upload_gbps / max(out_deg_i, 1),
              net.silos[j].download_gbps / max(in_deg_j, 1))
    transfer = wl.model_size_mbits / (cap * 1000.0) * 1000.0  # Mbits/Gbps -> ms
    return comp + lat + transfer


def pair_delay_ms(net: NetworkSpec, wl: Workload, i: int, j: int,
                  deg: np.ndarray) -> float:
    """Blocking exchange delay of pair (i,j) with per-node active degrees."""
    return max(
        directed_delay_ms(net, wl, i, j, int(deg[i]), int(deg[j])),
        directed_delay_ms(net, wl, j, i, int(deg[j]), int(deg[i])),
    )


def graph_pair_delays(net: NetworkSpec, wl: Workload,
                      graph: SimpleGraph) -> dict[Pair, float]:
    """Eq. 3 over all pairs of a static topology (degrees = graph degrees)."""
    deg = graph.degrees()
    return {p: pair_delay_ms(net, wl, p[0], p[1], deg) for p in graph.pairs}


def static_cycle_time_ms(net: NetworkSpec, wl: Workload, graph: SimpleGraph) -> float:
    """Cycle time of one round on a fixed topology: max pair delay (Eq. 5).

    Nodes with no active pair contribute local compute only.
    """
    delays = graph_pair_delays(net, wl, graph)
    comp = wl.compute_ms(net)
    deg = graph.degrees()
    lone = [float(comp[n]) for n in range(graph.num_nodes) if deg[n] == 0]
    vals = list(delays.values()) + lone
    return float(max(vals)) if vals else 0.0


@dataclasses.dataclass
class MultigraphDelayTracker:
    """Evolves per-pair delays across rounds per Eq. 4 and reports Eq. 5.

    State: d_prev (d_{k-1}) and d_cur (d_k) per pair, plus the last edge
    type per pair. Round 0 must be the overlay state (all strong), which
    matches Algorithm 2's parse order.
    """

    net: NetworkSpec
    wl: Workload
    overlay: SimpleGraph

    def __post_init__(self):
        base = graph_pair_delays(self.net, self.wl, self.overlay)
        self.d_cur: dict[Pair, float] = dict(base)    # d_k
        self.d_prev: dict[Pair, float] = dict(base)   # d_{k-1}
        self.last_type: dict[Pair, int] = {p: STRONG for p in self.overlay.pairs}
        self.prev_tau: float | None = None            # tau_{k-1}
        self.comp = self.wl.compute_ms(self.net)

    def round_cycle_time(self, state: MultigraphState) -> float:
        """Advance delays into this round (Eq. 4), return its tau (Eq. 5).

        Eq. 4 defines d_{k+1} from the edge-type transition e_k -> e_{k+1}
        and tau_k, so on every call we first advance the per-pair delays
        using the PREVIOUS round's tau, then take the max over this
        round's strong pairs.
        """
        if self.prev_tau is not None:
            nxt: dict[Pair, float] = {}
            for p, cur_t in state.edge_type.items():
                prev_t = self.last_type[p]
                d_k, d_km1 = self.d_cur[p], self.d_prev[p]
                u_tc = float(max(self.comp[p[0]], self.comp[p[1]]))
                if cur_t == STRONG and prev_t == STRONG:
                    d_next = d_k
                elif cur_t == STRONG and prev_t == WEAK:
                    d_next = max(u_tc, d_k - d_km1)
                elif cur_t == WEAK and prev_t == WEAK:
                    d_next = self.prev_tau + d_k
                else:  # strong -> weak
                    d_next = self.prev_tau
                nxt[p] = d_next
            self.d_prev = dict(self.d_cur)
            self.d_cur.update(nxt)

        strong = state.strong_pairs()
        vals = [self.d_cur[p] for p in strong]
        # Nodes not participating in any strong exchange (isolated nodes
        # and any node with only weak pairs) contribute local compute.
        in_strong = set()
        for i, j in strong:
            in_strong.add(i)
            in_strong.add(j)
        for n in range(state.num_nodes):
            if n not in in_strong:
                vals.append(float(self.comp[n]))
        tau = float(max(vals)) if vals else 0.0

        self.last_type = dict(state.edge_type)
        self.prev_tau = tau
        return tau


@dataclasses.dataclass
class FaultedDelayTracker:
    """Scalar twin of `faults.engine.FaultedSession` (Eq. 4 under
    observed conditions + timeout demotion + bounded staleness).

    Python floats and per-pair if/else instead of arrays — an
    independent implementation used as the test oracle for the
    vectorized engine, exactly as `MultigraphDelayTracker` is the
    oracle for the nominal recurrence. Inputs per round are plain
    observations (per-silo link/compute scales, down silos), so this
    module stays independent of `faults/`.
    """

    net: NetworkSpec
    wl: Workload
    overlay: SimpleGraph
    timeout_ms: float = float("inf")
    max_stale: int = 8
    adaptive: bool = False

    def __post_init__(self):
        base = graph_pair_delays(self.net, self.wl, self.overlay)
        self.d_cur: dict[Pair, float] = dict(base)
        self.d_prev: dict[Pair, float] = dict(base)
        self.prev_eff: set[Pair] = set()
        self.prev_tau: float | None = None
        self.streak: dict[Pair, int] = {p: 0 for p in self.overlay.pairs}
        self.silo_streak: dict[int, int] = {
            n: 0 for n in range(self.overlay.num_nodes)}
        self.comp = self.wl.compute_ms(self.net)

    def round_cycle_time(self, planned: set, link_scale, comp_scale,
                         crashed: set, flapped: set = frozenset()
                         ) -> tuple[float, set]:
        """Advance one round; returns (tau, effective strong pairs).

        ``planned`` — the plan's strong pairs this round; ``link_scale``
        / ``comp_scale`` — per-silo multipliers (sequences of length N);
        ``crashed``/``flapped`` — down silo indices.
        """
        down = set(crashed) | set(flapped)
        first = self.prev_tau is None
        nxt: dict[Pair, float] = {}
        eff: set[Pair] = set()
        tau = float("-inf")      # observed (wall clock)
        tau_lat = float("-inf")  # latent (nominal units, drives Eq. 4)
        paid = False
        for p in self.overlay.pairs:
            i, j = p
            u_tc = float(max(self.comp[i], self.comp[j]))
            if first:
                cand_s = cand_w = self.d_cur[p]
            elif p in self.prev_eff:
                cand_s = self.d_cur[p]
                cand_w = self.prev_tau
            else:
                v = self.d_cur[p] - self.d_prev[p]
                cand_s = u_tc if u_tc > v else v
                cand_w = self.prev_tau + self.d_cur[p]
            obs = (cand_s * max(link_scale[i], link_scale[j])
                   + (max(float(self.comp[i]) * comp_scale[i],
                          float(self.comp[j]) * comp_scale[j]) - u_tc))
            is_dead = i in down or j in down
            is_planned = p in planned
            want = is_planned and (is_dead or obs > self.timeout_ms)
            forced = (is_planned and not is_dead
                      and self.streak[p] >= self.max_stale)
            demoted = want and not forced
            if is_planned and not demoted:
                eff.add(p)
                if obs > tau:
                    tau = obs
                if cand_s > tau_lat:
                    tau_lat = cand_s
            if demoted and (not self.adaptive or self.streak[p] == 0):
                paid = True
            nxt[p] = cand_s if (is_planned and not demoted) else cand_w
            # Buffer age: grows on demotion, holds on planned-weak
            # rounds, resets only on an effective strong exchange.
            if demoted:
                self.streak[p] += 1
            elif is_planned:
                self.streak[p] = 0
        if paid and math.isfinite(self.timeout_ms) and self.timeout_ms > tau:
            tau = self.timeout_ms
        in_eff = {n for p in eff for n in p}
        finite_to = math.isfinite(self.timeout_ms)
        for n in range(self.overlay.num_nodes):
            cv = float(self.comp[n]) * comp_scale[n]
            lone_straggle = (n not in in_eff and n not in crashed
                             and cv > self.timeout_ms)
            if n in in_eff:
                self.silo_streak[n] = 0
                continue
            cn = float(self.comp[n])
            if cn > tau_lat:
                tau_lat = cn
            if n not in crashed:
                if not lone_straggle:
                    if cv > tau:
                        tau = cv
                elif finite_to:
                    if not self.adaptive or self.silo_streak[n] == 0:
                        if self.timeout_ms > tau:
                            tau = self.timeout_ms
            self.silo_streak[n] = (self.silo_streak[n] + 1
                                   if lone_straggle else 0)
        if not math.isfinite(tau_lat):
            tau_lat = 0.0
        if not math.isfinite(tau):
            tau = 0.0
        self.d_prev = dict(self.d_cur)
        self.d_cur = nxt
        self.prev_eff = eff
        self.prev_tau = tau_lat
        return tau, eff
