"""Timing engine, array-form Eq. 3/4/5 (counterpart of `repro.core.timing`).

One `TimingPlan` per (topology, network, workload[, t]) is the single
source of truth for the state schedule and the wall-clock axis. Two
kinds:

* ``recurrence`` (the multigraph): per-pair base delays ``d0`` (Eq. 3),
  per-state strong masks ``(S, E)`` and edge-type transition codes
  ``(S, E)`` (``code = 2*prev + cur`` with STRONG=1), so one Eq. 4 round
  is a handful of O(E) ops and Eq. 5 is a masked max plus a precomputed
  per-state lone-node compute term. Once a snapshot ``(phase, d_k,
  d_{k-1}, tau_k)`` repeats bit for bit the orbit is periodic and the
  remaining rounds are a tiled copy.
* ``cyclic`` (static, star, ring, sampled MATCHA): a ``(P,)`` per-round
  cycle-time period tiled over rounds (P = 1 for static designs; MATCHA
  samples the whole horizon).

Every operation is the reference's IEEE-754 double operation in the
same order, so cycle times agree bit for bit with `repro`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.delay import Workload
from repro_torch.core.graph import Multigraph, MultigraphState, SimpleGraph
from repro_torch.networks.zoo import NetworkSpec

#: State-schedule cap shared by the timing plan and the trainer.
CAP_STATES = 360

# Eq. 4 edge-type transition codes: code = 2*prev_type + cur_type.
T_WW = 0  # weak   -> weak   : d_{k+1} = tau_k + d_k
T_WS = 1  # weak   -> strong : d_{k+1} = max(u*T_c, d_k - d_{k-1})
T_SW = 2  # strong -> weak   : d_{k+1} = tau_k
T_SS = 3  # strong -> strong : d_{k+1} = d_k

#: At or below this many overlay pairs the Eq. 4 recurrence runs as a
#: scalar Python loop (same IEEE-754 double ops, so bit-identical):
#: numpy call dispatch dominates the work on arrays this small.
SMALL_E = 32

#: `sampled_cycle_times` evaluates rounds in chunks of at most this many
#: (round, pair) doubles.
_SAMPLE_CHUNK_ELEMS = 4_000_000


@dataclasses.dataclass(frozen=True)
class CycleTimeReport:
    topology: str
    network: str
    workload: str
    num_rounds: int
    mean_cycle_ms: float
    total_time_s: float
    # Multigraph statistics (paper Table 3).
    num_states: int = 1
    states_with_isolated: int = 0
    rounds_with_isolated: int = 0
    mean_isolated_per_round: float = 0.0

    def row(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Eq. 3 in array form
# ---------------------------------------------------------------------------


def directed_delay_matrix(net: NetworkSpec, wl: Workload,
                          out_deg: np.ndarray,
                          in_deg: np.ndarray) -> np.ndarray:
    """Eq. 3 for every directed transfer i -> j at once: ``(N, N)``."""
    comp = wl.local_updates * wl.base_compute_ms * net.compute_scale()
    cap = np.minimum(
        (net.upload_gbps() / np.maximum(out_deg, 1))[:, None],
        (net.download_gbps() / np.maximum(in_deg, 1))[None, :])
    transfer = wl.model_size_mbits / (cap * 1000.0) * 1000.0
    return comp[:, None] + net.latency_ms + transfer


def pair_delay_vector(net: NetworkSpec, wl: Workload, pair_i: np.ndarray,
                      pair_j: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """Blocking pair delays ``(E,)``: max of the two directed delays,
    with each node's links shared across its ``deg`` active neighbors."""
    d = directed_delay_matrix(net, wl, deg, deg)
    return np.maximum(d[pair_i, pair_j], d[pair_j, pair_i])


def static_cycle_time(net: NetworkSpec, wl: Workload,
                      graph: SimpleGraph) -> float:
    """Eq. 5 on a fixed topology: max pair delay; degree-0 nodes
    contribute local compute only."""
    comp = wl.compute_ms(net)
    deg = graph.degrees()
    best = -np.inf
    if graph.pairs:
        pi = np.fromiter((p[0] for p in graph.pairs), np.int64)
        pj = np.fromiter((p[1] for p in graph.pairs), np.int64)
        best = float(pair_delay_vector(net, wl, pi, pj, deg).max())
    lone = deg == 0
    if lone.any():
        best = max(best, float(comp[lone].max()))
    return best if np.isfinite(best) else 0.0


# ---------------------------------------------------------------------------
# TimingPlan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TimingPlan:
    """Host-side timing plan: one schedule, one wall clock.

    ``kind="recurrence"`` (the multigraph) carries the Eq. 4 arrays and
    the multigraph they came from, so the training RoundPlan
    (`fl/dpasgd.multigraph_plan`) is built from the same parsed states.
    ``kind="cyclic"`` (static, star, ring, sampled) carries a per-round
    cycle-time period tiled over rounds, or a ``sampler`` that makes it
    on first use (MATCHA samples the whole horizon, so nothing is tiled).
    """

    topology: str
    network: str
    workload: str
    num_nodes: int
    comp: np.ndarray                    # (N,) f64 — u*T_c per silo
    kind: str                           # "recurrence" | "cyclic"
    # recurrence kind (multigraph):
    pair_i: np.ndarray | None = None    # (E,) int64
    pair_j: np.ndarray | None = None    # (E,) int64
    d0: np.ndarray | None = None        # (E,) f64 — Eq. 3 overlay delays
    pair_comp: np.ndarray | None = None  # (E,) f64 — max(comp_i, comp_j)
    strong: np.ndarray | None = None    # (S, E) bool
    trans: np.ndarray | None = None     # (S, E) int8 transition codes
    lone_comp: np.ndarray | None = None  # (S,) f64 — max comp of strong-less nodes
    iso_count: np.ndarray | None = None  # (S,) int64 — isolated nodes per state
    mg: Multigraph | None = None
    cap_states: int | None = None
    overlay: SimpleGraph | None = None
    # cyclic kind:
    period_times: np.ndarray | None = None  # (P,) f64 ms, tiled over rounds
    #: Zero-argument callable making the (P,) period on first use, in
    #: place of ``period_times`` (sampled plans).
    sampler: object = dataclasses.field(default=None, compare=False)
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def period(self) -> np.ndarray:
        """The (P,) cyclic period (runs `sampler` on first use)."""
        if self.period_times is not None:
            return self.period_times
        if "period" not in self._cache:
            self._cache["period"] = np.asarray(self.sampler(), np.float64)
        return self._cache["period"]

    @property
    def num_states(self) -> int:
        if self.kind == "recurrence":
            return int(self.strong.shape[0])
        return 1

    @property
    def states(self) -> tuple[MultigraphState, ...]:
        """Algorithm 2 states, materialized on first access (pair p is
        STRONG in state m iff ``m % L[p] == 0``, as `strong` says)."""
        if self.mg is None:
            return ()
        if "states" not in self._cache:
            from repro_torch.core import parsing
            self._cache["states"] = tuple(
                parsing.parse_multigraph(self.mg, cap_states=self.cap_states))
        return self._cache["states"]

    def cycle_times(self, num_rounds: int) -> np.ndarray:
        """Per-round cycle times ``(num_rounds,)`` in ms (Eq. 4/5)."""
        if self.kind == "cyclic":
            return _tile_to(self.period(), num_rounds)
        if len(self.d0) <= SMALL_E:
            if "scratch_py" not in self._cache:
                self._cache["scratch_py"] = _recurrence_scratch_py(
                    self.trans, self.pair_comp)
            return _recurrence_taus_py(self.d0, self.lone_comp, num_rounds,
                                       *self._cache["scratch_py"])
        if "scratch" not in self._cache:
            self._cache["scratch"] = _recurrence_scratch(
                self.strong, self.trans, self.pair_comp)
        return _recurrence_taus(self.d0, self.lone_comp, num_rounds,
                                *self._cache["scratch"])

    def isolated_per_round(self, num_rounds: int) -> np.ndarray:
        """Isolated-node count per round (paper Table 3 statistics)."""
        if self.kind == "cyclic":
            return np.zeros(num_rounds, np.int64)
        return _tile_to(self.iso_count, num_rounds)

    def delay_history(self, num_rounds: int) -> tuple[np.ndarray,
                                                      np.ndarray,
                                                      np.ndarray]:
        """Eq. 4 replay keeping the per-pair delay vector every round.

        Returns ``(taus (R,), d (R, E), strong (R, E))``: ``d[k]`` is the
        round's post-transition pair-delay vector (what a strong pair
        blocks on) and ``taus`` is bit-identical to
        `cycle_times(num_rounds)` (the same IEEE ops per branch, without
        the orbit short-circuit). `obs.trace` turns it into per-silo
        compute/transfer/wait spans.
        """
        if self.kind != "recurrence":
            raise ValueError("delay_history needs a recurrence-kind plan; "
                             f"kind={self.kind!r} has no per-pair state")
        ww_idx, sw_idx, ws_idx, ws_pc, strong_idx = _recurrence_scratch(
            self.strong, self.trans, self.pair_comp)
        e = len(self.d0)
        num_states = len(strong_idx)
        taus = np.empty(num_rounds, np.float64)
        d_hist = np.empty((num_rounds, e), np.float64)
        d_cur = self.d0.copy()
        d_prev = self.d0.copy()
        prev_tau = 0.0
        for k in range(num_rounds):
            s = k % num_states
            if k > 0:
                i = ws_idx[s]
                ws_val = (np.maximum(ws_pc[s], d_cur[i] - d_prev[i])
                          if i.size else None)
                np.copyto(d_prev, d_cur)
                w = ww_idx[s]
                if w.size:
                    d_prev[w] += prev_tau
                v = sw_idx[s]
                if v.size:
                    d_prev[v] = prev_tau
                if ws_val is not None:
                    d_prev[i] = ws_val
                d_prev, d_cur = d_cur, d_prev
            j = strong_idx[s]
            tau = float(d_cur[j].max()) if j.size else -np.inf
            if self.lone_comp[s] > tau:
                tau = float(self.lone_comp[s])
            taus[k] = tau
            d_hist[k] = d_cur
            prev_tau = tau
        phases = np.arange(num_rounds) % num_states
        return taus, d_hist, self.strong[phases]

    def report(self, num_rounds: int) -> CycleTimeReport:
        if self.kind == "cyclic":
            period_times = self.period()
            if len(period_times) == num_rounds:
                # Every round sampled: total = sum and mean = sum/n, the
                # reduction the trainer runs over `cycle_times`.
                return CycleTimeReport(
                    topology=self.topology, network=self.network,
                    workload=self.workload, num_rounds=num_rounds,
                    mean_cycle_ms=float(period_times.mean()),
                    total_time_s=float(period_times.sum()) / 1000.0)
            # Equal-weight the period: a truncated tiling would bias the
            # mean toward the period's first rounds.
            mean = (float(period_times.mean())
                    if len(period_times) else 0.0)
            return CycleTimeReport(
                topology=self.topology, network=self.network,
                workload=self.workload, num_rounds=num_rounds,
                mean_cycle_ms=mean,
                total_time_s=mean * num_rounds / 1000.0)
        return self._report_from_taus(self.cycle_times(num_rounds),
                                      num_rounds)

    def _report_from_taus(self, taus: np.ndarray,
                          num_rounds: int) -> CycleTimeReport:
        """Recurrence-cell report from a tau series (the per-cell one, or
        the `TimingGrid` row of this cell): one reduction for both."""
        iso = self.isolated_per_round(num_rounds)
        return CycleTimeReport(
            topology=self.topology, network=self.network,
            workload=self.workload, num_rounds=num_rounds,
            mean_cycle_ms=float(taus.mean()),
            total_time_s=float(taus.sum()) / 1000.0,
            num_states=self.num_states,
            states_with_isolated=int((self.iso_count > 0).sum()),
            rounds_with_isolated=int((iso > 0).sum()),
            mean_isolated_per_round=float(iso.mean()))


def _tile_to(period: np.ndarray, num_rounds: int) -> np.ndarray:
    p = len(period)
    if p == 0:
        return np.zeros(num_rounds, period.dtype)
    reps = -(-num_rounds // p)
    return np.tile(period, reps)[:num_rounds]


def _split_rows(mask: np.ndarray) -> list[np.ndarray]:
    """Per-row column-index lists of a boolean ``(S, E)`` matrix."""
    rows, cols = np.nonzero(mask)
    return np.split(cols, np.searchsorted(rows, np.arange(1, mask.shape[0])))


def _recurrence_scratch(strong, trans, pair_comp):
    """Per-state index lists for the Eq. 4 inner loop: WW adds tau, SW
    resets to tau, SS keeps d, WS (the only nonlinear branch) carries
    its pre-gathered pair compute; plus the strong pairs for Eq. 5."""
    ww_idx = _split_rows(trans == T_WW)
    sw_idx = _split_rows(trans == T_SW)
    ws_idx = _split_rows(trans == T_WS)
    ws_pc = [pair_comp[i] for i in ws_idx]
    strong_idx = _split_rows(strong)
    return ww_idx, sw_idx, ws_idx, ws_pc, strong_idx


def _recurrence_taus(d0, lone_comp, num_rounds: int,
                     ww_idx, sw_idx, ws_idx, ws_pc,
                     strong_idx) -> np.ndarray:
    """Vectorized Eq. 4 recurrence + Eq. 5 masked max, with exact
    periodic-orbit short-circuiting (the snapshot is keyed every round).
    """
    num_states = len(strong_idx)
    taus = np.empty(num_rounds, np.float64)
    d_cur = d0.copy()
    d_prev = d0.copy()
    prev_tau = 0.0
    seen: dict[tuple, int] = {}
    prev_b = d0.tobytes()
    k = 0
    while k < num_rounds:
        s = k % num_states
        if k == 0:
            si = strong_idx[0]
            tau = float(d_cur[si].max()) if si.size else -np.inf
        else:
            i = ws_idx[s]
            ws_val = (np.maximum(ws_pc[s], d_cur[i] - d_prev[i])
                      if i.size else None)
            # d_next over the retiring d_prev buffer: start from d_cur
            # (the SS case), then patch WW / SW / WS.
            np.copyto(d_prev, d_cur)
            w = ww_idx[s]
            if w.size:
                d_prev[w] += prev_tau
            v = sw_idx[s]
            if v.size:
                d_prev[v] = prev_tau
            if ws_val is not None:
                d_prev[i] = ws_val
            d_prev, d_cur = d_cur, d_prev
            j = strong_idx[s]
            tau = float(d_cur[j].max()) if j.size else -np.inf
        if lone_comp[s] > tau:
            tau = lone_comp[s]
        taus[k] = tau
        prev_tau = tau
        k += 1
        if k < num_rounds:
            cur_b = d_cur.tobytes()
            key = (s, cur_b, prev_b, tau)
            prev_b = cur_b
            k0 = seen.get(key)
            if k0 is not None:
                period = k - k0
                taus[k:] = _tile_to(taus[k - period:k], num_rounds - k)
                break
            seen[key] = k
    return taus


def _recurrence_scratch_py(trans, pair_comp):
    """Scalar-path scratch: per-state WW / SW index lists, WS as
    ``(e, u*T_c)`` pairs, and the strong indices for the Eq. 5 max."""
    pc = pair_comp.tolist()
    ww_rows, sw_rows, ws_rows, strong_rows = [], [], [], []
    for row in trans.tolist():
        ww, sw, ws, st = [], [], [], []
        for e, c in enumerate(row):
            if c == T_WW:
                ww.append(e)
            elif c == T_SW:
                sw.append(e)
            elif c == T_WS:
                ws.append((e, pc[e]))
                st.append(e)
            else:
                st.append(e)
        ww_rows.append(ww)
        sw_rows.append(sw)
        ws_rows.append(ws)
        strong_rows.append(st)
    return ww_rows, sw_rows, ws_rows, strong_rows


def _recurrence_taus_py(d0, lone_comp, num_rounds: int,
                        ww_rows, sw_rows, ws_rows,
                        strong_rows) -> np.ndarray:
    """Scalar twin of `_recurrence_taus` for tiny edge lists.

    Python floats are IEEE-754 doubles and every branch applies the same
    operation, so the taus are bit for bit the array path's. Only the
    pairs that go weak->strong next round need one-round history, kept
    in a small `stash` captured before each round's writes.
    """
    num_states = len(strong_rows)
    lone = lone_comp.tolist()
    taus = np.empty(num_rounds, np.float64)
    d = d0.tolist()
    stash = d0.tolist()
    prev_tau = 0.0
    seen: dict[tuple, int] = {}
    k = 0
    neg_inf = float("-inf")
    while k < num_rounds:
        s = k % num_states
        nxt = ws_rows[(s + 1) % num_states]
        for e, _ in nxt:
            stash[e] = d[e]
        if k > 0:
            for e in ww_rows[s]:
                d[e] = d[e] + prev_tau
            for e in sw_rows[s]:
                d[e] = prev_tau
            for e, pc in ws_rows[s]:
                v = d[e] - stash[e]
                d[e] = pc if pc > v else v
        js = strong_rows[s]
        tau = max(map(d.__getitem__, js)) if js else neg_inf
        if lone[s] > tau:
            tau = lone[s]
        taus[k] = tau
        prev_tau = tau
        k += 1
        if k < num_rounds:
            key = (s, tuple(d), tuple(stash[e] for e, _ in nxt))
            k0 = seen.get(key)
            if k0 is not None:
                period = k - k0
                taus[k:] = _tile_to(taus[k - period:k], num_rounds - k)
                break
            seen[key] = k
    return taus


# ---------------------------------------------------------------------------
# plan constructors
# ---------------------------------------------------------------------------


def multiplicity_timing_plan(net: NetworkSpec, wl: Workload,
                             overlay: SimpleGraph,
                             multiplicity: dict, *,
                             name: str = "multigraph",
                             cap_states: int | None = CAP_STATES,
                             mg: Multigraph | None = None,
                             d0_override: np.ndarray | None = None,
                             comp_override: np.ndarray | None = None
                             ) -> TimingPlan:
    """Recurrence plan for an explicit multiplicity assignment over the
    overlay pairs (Algorithm 1 is one way to pick it).

    ``d0_override``/``comp_override`` replace the NOMINAL Eq. 3 pair
    delays / per-silo compute with OBSERVED estimates (`faults`: scenario
    planning and the self-healing controller re-plan from the measured
    window). ``None`` keeps the nominal path bit for bit."""
    from repro_torch.core import parsing

    if mg is None:
        mg = Multigraph(num_nodes=overlay.num_nodes,
                        multiplicity=dict(multiplicity))
    pairs = overlay.pairs
    num_pairs = len(pairs)
    pair_i = np.fromiter((p[0] for p in pairs), np.int64, num_pairs)
    pair_j = np.fromiter((p[1] for p in pairs), np.int64, num_pairs)
    comp = (wl.compute_ms(net).astype(np.float64) if comp_override is None
            else np.asarray(comp_override, np.float64))
    if comp.shape != (net.num_silos,):
        raise ValueError(f"comp_override shape {comp.shape} != "
                         f"({net.num_silos},)")
    d0 = (pair_delay_vector(net, wl, pair_i, pair_j, overlay.degrees())
          if d0_override is None else np.asarray(d0_override, np.float64))
    if d0.shape != (num_pairs,):
        raise ValueError(f"d0_override shape {d0.shape} != ({num_pairs},)")
    pair_comp = np.maximum(comp[pair_i], comp[pair_j])

    # Algorithm 2 in closed form: pair p is STRONG in state m iff
    # m % L[p] == 0, so state 0 is the all-strong overlay.
    L = parsing.capped_multiplicities(multiplicity, cap_states)
    num_states = 1
    for n in L.values():
        num_states = math.lcm(num_states, n)
    mults = np.fromiter((L[p] for p in pairs), np.int64, num_pairs)
    strong = (np.arange(num_states)[:, None] % mults[None, :]) == 0
    prev = np.roll(strong, 1, axis=0)
    trans = (2 * prev.astype(np.int8) + strong.astype(np.int8))

    # Eq. 5 constants per state: nodes in no strong pair contribute
    # local compute; isolated = has an overlay edge but none strong.
    incidence = np.zeros((num_pairs, net.num_silos), np.float64)
    incidence[np.arange(num_pairs), pair_i] = 1.0
    incidence[np.arange(num_pairs), pair_j] = 1.0
    in_strong = (strong.astype(np.float64) @ incidence) > 0  # (S, N)
    lone_comp = np.max(np.where(in_strong, -np.inf, comp[None, :]), axis=1)
    has_edge = incidence.any(axis=0)
    iso_count = (has_edge[None, :] & ~in_strong).sum(axis=1)

    return TimingPlan(
        topology=name, network=net.name, workload=wl.name,
        num_nodes=net.num_silos, comp=comp, kind="recurrence",
        pair_i=pair_i, pair_j=pair_j, d0=d0, pair_comp=pair_comp,
        strong=strong, trans=trans, lone_comp=lone_comp,
        iso_count=iso_count, mg=mg, cap_states=cap_states,
        overlay=overlay)


def multiplicity_vector_plan(net: NetworkSpec, wl: Workload,
                             overlay: SimpleGraph, mults, *,
                             name: str = "search",
                             cap_states: int | None = CAP_STATES,
                             d0_override: np.ndarray | None = None,
                             comp_override: np.ndarray | None = None
                             ) -> TimingPlan:
    """`multiplicity_timing_plan` for a flat vector aligned with
    ``overlay.pairs``, the design search's exchange format. Algorithm
    1's own vector gives the default plan bit for bit."""
    mults = tuple(int(m) for m in mults)
    if len(mults) != len(overlay.pairs):
        raise ValueError(f"multiplicity vector has {len(mults)} entries "
                         f"for {len(overlay.pairs)} overlay pairs")
    if any(m < 1 for m in mults):
        raise ValueError(f"multiplicities must be >= 1, got {mults}")
    L = {p: m for p, m in zip(overlay.pairs, mults)}
    return multiplicity_timing_plan(net, wl, overlay, L, name=name,
                                    cap_states=cap_states,
                                    d0_override=d0_override,
                                    comp_override=comp_override)


def multigraph_timing_plan(net: NetworkSpec, wl: Workload, *, t: int = 5,
                           overlay: SimpleGraph | None = None,
                           cap_states: int | None = CAP_STATES) -> TimingPlan:
    """Full multigraph pipeline: overlay (Christofides unless given) ->
    Algorithm 1 -> Algorithm 2 -> Eq. 4 arrays."""
    from repro_torch.core.multigraph import build_multigraph
    from repro_torch.design.catalog import ring_topology

    if overlay is None:
        overlay = ring_topology(net, wl).graph
    mg = build_multigraph(net, wl, overlay, t=t)
    return multiplicity_timing_plan(
        net, wl, overlay, mg.multiplicity, name=f"multigraph(t={t})",
        cap_states=cap_states, mg=mg)


def _cyclic_plan(topology: str, net: NetworkSpec, wl: Workload,
                 period_times: np.ndarray | None,
                 sampler=None) -> TimingPlan:
    return TimingPlan(
        topology=topology, network=net.name, workload=wl.name,
        num_nodes=net.num_silos, comp=wl.compute_ms(net).astype(np.float64),
        kind="cyclic",
        period_times=(None if period_times is None
                      else np.asarray(period_times, np.float64)),
        sampler=sampler)


def static_timing_plan(name: str, net: NetworkSpec, wl: Workload,
                       graph: SimpleGraph) -> TimingPlan:
    """Every round costs the same Eq. 5 max-delay of the fixed graph."""
    return _cyclic_plan(name, net, wl,
                        np.array([static_cycle_time(net, wl, graph)]))


def star_timing_plan(net: NetworkSpec, wl: Workload) -> TimingPlan:
    """STAR is client-server FedAvg: a round is gather THEN broadcast.
    The hub's access link is shared across all N-1 concurrent transfers
    of each phase, and the phases are sequential. Vectorized over hubs."""
    n = net.num_silos
    if n == 1:  # no transfers: local compute only
        return _cyclic_plan("star", net, wl,
                            np.array([float(np.max(wl.compute_ms(net)))]))
    ones = np.ones(n, np.int64)
    fan = np.full(n, n - 1, np.int64)
    off_diag = ~np.eye(n, dtype=bool)
    # gather: i -> hub with out_deg 1, in_deg N-1; entry [i, hub]
    d_up = directed_delay_matrix(net, wl, ones, fan)
    up = np.max(d_up, axis=0, initial=-np.inf, where=off_diag)
    # broadcast: hub -> i with out_deg N-1, in_deg 1; entry [hub, i]
    d_dn = directed_delay_matrix(net, wl, fan, ones)
    down = np.max(d_dn, axis=1, initial=-np.inf, where=off_diag)
    best = float(np.min(up + down))
    return _cyclic_plan("star", net, wl, np.array([best]))


def ring_tour(graph: SimpleGraph) -> list[int]:
    """Orient the ring into a closed tour ``[0, ..., 0]``, checking that
    the walk is one Hamiltonian cycle that closes onto node 0."""
    n = graph.num_nodes
    if n == 1:
        return [0, 0]
    if n == 2:
        if graph.num_pairs != 1:
            raise ValueError("2-node ring must be the single pair (0,1)")
        return [0, 1, 0]
    adj = {v: graph.neighbors(v) for v in range(n)}
    tour = [0]
    prev = None
    while len(tour) < n:
        nxts = [v for v in adj[tour[-1]] if v != prev]
        if not nxts:
            raise ValueError(
                f"ring tour stuck at node {tour[-1]}: graph is not a "
                "single Hamiltonian cycle")
        prev = tour[-1]
        tour.append(nxts[0])
    if len(set(tour)) != n:
        raise ValueError("ring tour revisits a node: graph is not a "
                         "single Hamiltonian cycle")
    if 0 not in adj[tour[-1]]:
        raise ValueError(f"ring tour does not close: node {tour[-1]} is "
                         "not adjacent to node 0")
    return tour + [0]


def ring_timing_plan(net: NetworkSpec, wl: Workload,
                     graph: SimpleGraph | None = None) -> TimingPlan:
    """RING with its max-plus throughput: the maximum cycle mean over
    each node's compute self-loop, the full ring circuit (sum of
    directed delays / N) and each pair's 2-circuit (d_pair / 2)."""
    from repro_torch.design.catalog import ring_topology

    if graph is None:
        graph = ring_topology(net, wl).graph
    comp = wl.compute_ms(net)
    if not graph.pairs:  # 1-silo "ring": local compute only
        return _cyclic_plan("ring", net, wl, np.array([float(np.max(comp))]))
    tour = ring_tour(graph)
    a = np.asarray(tour[:-1], np.int64)
    b = np.asarray(tour[1:], np.int64)
    ones = np.ones(net.num_silos, np.int64)
    total = float(directed_delay_matrix(net, wl, ones, ones)[a, b].sum())
    pair_i = np.fromiter((p[0] for p in graph.pairs), np.int64)
    pair_j = np.fromiter((p[1] for p in graph.pairs), np.int64)
    two_circuit = float(
        pair_delay_vector(net, wl, pair_i, pair_j, graph.degrees()).max()
        / 2.0)
    lam = max(total / graph.num_nodes, two_circuit, float(np.max(comp)))
    return _cyclic_plan("ring", net, wl, np.array([lam]))


def sampled_cycle_times(design, net: NetworkSpec, wl: Workload,
                        num_rounds: int) -> np.ndarray:
    """Eq. 5 cycle times of a sampled matching design for every round,
    vectorized: ``(num_rounds,)`` f64 ms, equal to ``static_cycle_time(
    net, wl, design.round_graph(k))`` round by round. Work is chunked
    over rounds so the ``(rounds, E)`` intermediates stay within
    ``_SAMPLE_CHUNK_ELEMS`` doubles."""
    matchings = design.matchings
    base_pairs = sorted({p for m in matchings for p in m})
    num_pairs = len(base_pairs)
    comp = wl.compute_ms(net).astype(np.float64)
    n = net.num_silos
    act = design.activation_matrix(num_rounds)
    if num_rounds == 0:
        return np.zeros(0, np.float64)
    if num_pairs == 0:
        return np.full(num_rounds, float(comp.max()) if n else 0.0)
    pair_of = {p: e for e, p in enumerate(base_pairs)}
    m_of_pair = np.empty(num_pairs, np.int64)
    node_in = np.zeros((len(matchings), n), np.int64)
    for mi, m in enumerate(matchings):
        for a, b in m:
            m_of_pair[pair_of[(a, b)]] = mi
            node_in[mi, a] = node_in[mi, b] = 1
    pi = np.fromiter((p[0] for p in base_pairs), np.int64, num_pairs)
    pj = np.fromiter((p[1] for p in base_pairs), np.int64, num_pairs)
    lat = net.latency_ms
    up = net.upload_gbps()
    dn = net.download_gbps()
    # (comp_i + lat_ij) rounds first in directed_delay_matrix, so the
    # per-direction bases are per-pair constants across rounds.
    base_ij = comp[pi] + lat[pi, pj]
    base_ji = comp[pj] + lat[pj, pi]
    # One access capacity for every silo: min(c/s_i, c/s_j) is
    # c/max(s_i, s_j), so the transfer term is a table over the larger
    # share, and max(base_ij + t, base_ji + t) == max(base_ij, base_ji) + t.
    uniform_cap = bool((up == up[0]).all() and (dn == up[0]).all())
    if uniform_cap:
        shares = np.arange(1, len(matchings) + 1, dtype=np.int64)
        tr_table = wl.model_size_mbits / ((up[0] / shares) * 1000.0) * 1000.0
        base_max = np.maximum(base_ij, base_ji)
    out = np.empty(num_rounds, np.float64)
    rows = max(1, _SAMPLE_CHUNK_ELEMS // num_pairs)
    for lo in range(0, num_rounds, rows):
        a = act[lo:lo + rows]
        deg = a.astype(np.int64) @ node_in              # (Rc, N)
        share = np.maximum(deg, 1)
        if uniform_cap:
            smax = np.maximum(share[:, pi], share[:, pj])
            pd = base_max[None, :] + tr_table[smax - 1]
        else:
            a_up = up / share                           # (Rc, N)
            a_dn = dn / share
            tr = wl.model_size_mbits / (
                np.minimum(a_up[:, pi], a_dn[:, pj]) * 1000.0) * 1000.0
            d_ij = base_ij[None, :] + tr
            tr = wl.model_size_mbits / (
                np.minimum(a_up[:, pj], a_dn[:, pi]) * 1000.0) * 1000.0
            d_ji = base_ji[None, :] + tr
            pd = np.maximum(d_ij, d_ji)
        live = a[:, m_of_pair]
        tau = np.max(np.where(live, pd, -np.inf), axis=1)
        lone = np.max(np.where(deg == 0, comp[None, :], -np.inf), axis=1)
        tau = np.maximum(tau, lone)
        out[lo:lo + rows] = np.where(np.isfinite(tau), tau, 0.0)
    return out


def sampled_timing_plan(name: str, net: NetworkSpec, wl: Workload, design,
                        sample_rounds: int, sampler=None) -> TimingPlan:
    """Per-round random topologies (MATCHA): per-round Eq. 5 cycle
    times for ``sample_rounds`` rounds, made on first use. ``sampler``
    replaces `sampled_cycle_times` with a shared computation of the same
    bits (`design.batched.DesignContext.sampler`)."""
    if sampler is None:
        def sampler(design=design, net=net, wl=wl, rounds=sample_rounds):
            return sampled_cycle_times(design, net, wl, rounds)
    return _cyclic_plan(name, net, wl, None, sampler=sampler)


# ---------------------------------------------------------------------------
# batched timing grid: all recurrence cells in one array program
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TimingGrid:
    """Many TimingPlans on one stacked cell axis: every recurrence cell
    advances together as ``(C, E_max)`` array ops over padded edge lists,
    each with its own periodic-orbit short-circuit (a vectorized snapshot
    hash, verified exactly before it fires). Cyclic cells keep their
    periods. Every row is bit for bit ``plan.cycle_times(num_rounds)``.
    """

    plans: tuple[TimingPlan, ...]
    rec_rows: tuple[int, ...]           # indices of recurrence cells
    # stacked recurrence arrays, padded to (C, S_max, E_max):
    d0: np.ndarray | None               # (C, E_max) f64, pad 0
    pair_comp: np.ndarray | None        # (C, E_max) f64, pad 0
    strong: np.ndarray | None           # (C, S_max, E_max) bool, pad False
    trans: np.ndarray | None            # (C, S_max, E_max) int8, pad T_SS
    lone_comp: np.ndarray | None        # (C, S_max) f64, pad -inf
    num_states: np.ndarray | None       # (C,) int64

    @property
    def num_cells(self) -> int:
        return len(self.plans)

    def _rec_taus(self, num_rounds: int, retire: bool, backend: str,
                  device=None) -> np.ndarray:
        """(len(rec_rows), num_rounds) recurrence taus on ``backend``.

        ``"numpy"`` is the host engine with exact-verified orbit
        short-circuits (the oracle); ``"torch"`` runs the device grid
        (`core/timing_torch.py`, on ``device``: the card unless told
        otherwise), bit for bit the same, stepping the full horizon
        (``retire`` is moot there: a locked cell's further stepping is
        its tiled replay). Any other ``backend`` raises.
        """
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown timing backend {backend!r} "
                             "(expected 'numpy' or 'torch')")
        if not self.rec_rows:
            return np.empty((0, num_rounds), np.float64)
        if backend == "torch":
            from repro_torch.core import timing_torch
            return timing_torch.grid_recurrence_taus(
                self.d0, self.pair_comp, self.strong, self.trans,
                self.lone_comp, self.num_states, num_rounds, device=device)
        return _grid_recurrence_taus(
            self.d0, self.pair_comp, self.strong, self.trans,
            self.lone_comp, self.num_states, num_rounds, retire=retire)

    def cycle_time_matrix(self, num_rounds: int, retire: bool = True,
                          backend: str = "numpy",
                          device=None) -> np.ndarray:
        """(num_cells, num_rounds) f64 ms: every cell's tau series."""
        out = np.empty((len(self.plans), num_rounds), np.float64)
        rec = self._rec_taus(num_rounds, retire, backend, device)
        for row, c in enumerate(self.rec_rows):
            out[c] = rec[row]
        for c, plan in enumerate(self.plans):
            if plan.kind != "recurrence":
                out[c] = plan.cycle_times(num_rounds)
        return out

    def reports(self, num_rounds: int, retire: bool = True,
                backend: str = "numpy",
                device=None) -> list[CycleTimeReport]:
        """One CycleTimeReport per plan, recurrence rows batched."""
        rec_taus = self._rec_taus(num_rounds, retire, backend, device)
        row_of = {c: row for row, c in enumerate(self.rec_rows)}
        out = []
        for c, plan in enumerate(self.plans):
            if plan.kind == "recurrence":
                out.append(plan._report_from_taus(rec_taus[row_of[c]],
                                                  num_rounds))
            else:
                out.append(plan.report(num_rounds))
        return out


def build_timing_grid(plans: list[TimingPlan]) -> TimingGrid:
    """Stack the recurrence cells of ``plans`` into one padded program.
    Padding is inert: phantom edges have ``d0 = 0``, code ``T_SS`` in
    every state and a False strong mask; phantom states are never indexed
    because each cell's phase is ``k % S_c``."""
    rec_rows = tuple(c for c, p in enumerate(plans)
                     if p.kind == "recurrence")
    if not rec_rows:
        return TimingGrid(plans=tuple(plans), rec_rows=(), d0=None,
                          pair_comp=None, strong=None, trans=None,
                          lone_comp=None, num_states=None)
    cells = [plans[c] for c in rec_rows]
    num_cells = len(cells)
    # >= 1 so a zero-pair cell reduces over a phantom edge, not an empty
    # axis.
    e_max = max(max((len(p.d0) for p in cells), default=0), 1)
    s_max = max(p.num_states for p in cells)
    d0 = np.zeros((num_cells, e_max), np.float64)
    pair_comp = np.zeros((num_cells, e_max), np.float64)
    strong = np.zeros((num_cells, s_max, e_max), bool)
    trans = np.full((num_cells, s_max, e_max), T_SS, np.int8)
    lone = np.full((num_cells, s_max), -np.inf, np.float64)
    num_states = np.empty(num_cells, np.int64)
    for row, p in enumerate(cells):
        e, s = len(p.d0), p.num_states
        d0[row, :e] = p.d0
        pair_comp[row, :e] = p.pair_comp
        strong[row, :s, :e] = p.strong
        trans[row, :s, :e] = p.trans
        lone[row, :s] = p.lone_comp
        num_states[row] = s
    return TimingGrid(plans=tuple(plans), rec_rows=rec_rows, d0=d0,
                      pair_comp=pair_comp, strong=strong, trans=trans,
                      lone_comp=lone, num_states=num_states)


#: splitmix64's odd 64-bit mixing constants: the grid's snapshot hash
#: and MATCHA's counter-based activation draws
#: (`design.catalog._counter_uniform`).
SPLITMIX64_CONSTANTS = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
                        0x94D049BB133111EB)


def _snapshot_hashes(d_cur: np.ndarray, d_prev: np.ndarray,
                     tau: np.ndarray, phase: np.ndarray,
                     weights: np.ndarray) -> np.ndarray:
    """(C,) uint64: one mixed hash per cell of this round's ``(phase,
    d_k, d_{k-1}, tau_k)`` snapshot."""
    a, b, c = (np.uint64(x) for x in SPLITMIX64_CONSTANTS)
    h1 = (d_cur.view(np.uint64) * weights).sum(axis=1)
    h2 = (d_prev.view(np.uint64) * weights).sum(axis=1)
    h = h1 * a ^ h2 * b ^ np.ascontiguousarray(tau).view(np.uint64) * c
    return h ^ phase.astype(np.uint64) * a


def _grid_recurrence_taus(d0, pair_comp, strong, trans, lone_comp,
                          num_states, num_rounds: int,
                          retire: bool = True) -> np.ndarray:
    """Eq. 4/5 for all cells at once, bit for bit the per-cell
    `_recurrence_taus`: each branch applies the per-cell formula and
    `np.where` only selects; a cell's orbit short-circuit fires only on a
    snapshot recurrence verified exactly.

    ``retire=True`` drops a row from the stacked buffers the round its
    orbit locks and tiles its tail at once, so the live loop narrows to
    the cells still in transient. ``retire=False`` steps every row until
    the slowest locks. Both give the same bits: a locked cell's further
    stepping is the tiled replay.
    """
    num_cells, e_max = d0.shape
    rng = np.random.default_rng(0x5EED)
    weights = rng.integers(0, 2**63, e_max, np.uint64) * np.uint64(2) \
        + np.uint64(1)
    taus = np.empty((num_cells, num_rounds), np.float64)
    act = np.arange(num_cells)           # original ids of the live rows
    d_cur = d0.copy()
    d_prev = d0.copy()
    prev_tau = np.zeros(num_cells)
    # hist[c][k] = cell c's d_cur after round k (appended while live)
    hist: list[list[np.ndarray]] = [[] for _ in range(num_cells)]
    seen: list[dict[int, list[int]]] = [dict() for _ in range(num_cells)]
    done = np.zeros(num_cells, bool)
    period = np.zeros(num_cells, np.int64)
    locked_at = np.full(num_cells, -1, np.int64)
    k = 0
    while k < num_rounds and act.size:
        s = k % num_states[act]                       # live-row phases
        st = strong[act, s]
        if k == 0:
            tau = np.max(np.where(st, d_cur, -np.inf), axis=1)
        else:
            code = trans[act, s]
            ws = np.maximum(pair_comp[act], d_cur - d_prev)
            d_next = np.where(
                code == T_SS, d_cur, np.where(
                    code == T_WW, prev_tau[:, None] + d_cur, np.where(
                        code == T_SW, prev_tau[:, None], ws)))
            d_prev, d_cur = d_cur, d_next
            tau = np.max(np.where(st, d_cur, -np.inf), axis=1)
        tau = np.maximum(tau, lone_comp[act, s])
        taus[act, k] = tau
        prev_tau = tau
        h = _snapshot_hashes(d_cur, d_prev, tau, s, weights)
        newly: list[int] = []
        for row, c in enumerate(act):
            if done[c]:
                continue
            hist[c].append(d_cur[row].copy())
            cands = seen[c].setdefault(int(h[row]), [])
            for k0 in cands:
                if (k - k0) % num_states[c]:
                    continue               # phase mismatch (hash lied)
                prev0 = hist[c][k0 - 1] if k0 else d0[c]
                if (taus[c, k] == taus[c, k0]
                        and np.array_equal(hist[c][k], hist[c][k0])
                        and np.array_equal(hist[c][k - 1] if k
                                           else d0[c], prev0)):
                    done[c] = True
                    period[c] = k - k0
                    locked_at[c] = k
                    newly.append(row)
                    break
            else:
                cands.append(k)
        k += 1
        if retire:
            if newly:
                keep = np.ones(act.size, bool)
                keep[newly] = False
                act = act[keep]
                d_cur = d_cur[keep]
                d_prev = d_prev[keep]
                prev_tau = prev_tau[keep]
        elif done.all():
            break
    # Locked rows replay their orbit: retired rows from their own lock
    # round, non-retired ones from the common exit round k.
    for c in np.flatnonzero(locked_at >= 0):
        start = int(locked_at[c]) + 1 if retire else k
        if start < num_rounds:
            p = int(period[c])
            taus[c, start:] = _tile_to(taus[c, start - p:start],
                                       num_rounds - start)
    return taus


def make_timing_plan(topology: str, net: NetworkSpec, wl: Workload, *,
                     t: int = 5, cap_states: int | None = CAP_STATES,
                     seed: int = 0, sample_rounds: int = 512,
                     overlay: SimpleGraph | None = None,
                     ctx=None) -> TimingPlan:
    """Timing plan of any Table-1 topology through its design family
    (`design.catalog.get_family`). ``ctx`` (a
    `design.batched.DesignContext`) shares construction artifacts across
    cells; ``overlay`` gives the ring and multigraph families their
    overlay. Either way the plan's bits are the same."""
    from repro_torch.design import catalog

    fam = catalog.get_family(topology, t=t, cap_states=cap_states,
                             seed=seed, sample_rounds=sample_rounds)
    if topology in ("ring", "multigraph"):
        return fam.timing_plan(net, wl, ctx=ctx, overlay=overlay)
    return fam.timing_plan(net, wl, ctx=ctx)
