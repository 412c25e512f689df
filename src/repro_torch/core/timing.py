"""Timing engine, array-form Eq. 3/4/5 (counterpart of `repro.core.timing`
without the batched `TimingGrid`).

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
        taus = self.cycle_times(num_rounds)
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
                             mg: Multigraph | None = None) -> TimingPlan:
    """Recurrence plan for an explicit multiplicity assignment over the
    overlay pairs (Algorithm 1 is one way to pick it)."""
    from repro_torch.core import parsing

    if mg is None:
        mg = Multigraph(num_nodes=overlay.num_nodes,
                        multiplicity=dict(multiplicity))
    pairs = overlay.pairs
    num_pairs = len(pairs)
    pair_i = np.fromiter((p[0] for p in pairs), np.int64, num_pairs)
    pair_j = np.fromiter((p[1] for p in pairs), np.int64, num_pairs)
    comp = wl.compute_ms(net).astype(np.float64)
    d0 = pair_delay_vector(net, wl, pair_i, pair_j, overlay.degrees())
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
                             name: str) -> TimingPlan:
    """`multiplicity_timing_plan` for a flat vector aligned with
    ``overlay.pairs``. Algorithm 1's own vector gives the default plan
    bit for bit."""
    mults = tuple(int(m) for m in mults)
    if len(mults) != len(overlay.pairs):
        raise ValueError(f"multiplicity vector has {len(mults)} entries "
                         f"for {len(overlay.pairs)} overlay pairs")
    if any(m < 1 for m in mults):
        raise ValueError(f"multiplicities must be >= 1, got {mults}")
    L = {p: m for p, m in zip(overlay.pairs, mults)}
    return multiplicity_timing_plan(net, wl, overlay, L, name=name)


def multigraph_timing_plan(net: NetworkSpec, wl: Workload, *, t: int = 5,
                           cap_states: int | None = CAP_STATES) -> TimingPlan:
    """Full multigraph pipeline: Christofides overlay -> Algorithm 1 ->
    Algorithm 2 -> Eq. 4 arrays."""
    from repro_torch.core.multigraph import build_multigraph
    from repro_torch.design.catalog import ring_topology

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
                        sample_rounds: int) -> TimingPlan:
    """Per-round random topologies (MATCHA): per-round Eq. 5 cycle
    times for ``sample_rounds`` rounds, made on first use."""

    def sampler(design=design, net=net, wl=wl, rounds=sample_rounds):
        return sampled_cycle_times(design, net, wl, rounds)
    return _cyclic_plan(name, net, wl, None, sampler=sampler)


#: splitmix64's odd 64-bit mixing constants (MATCHA's counter-based
#: activation draws, `design.catalog._counter_uniform`).
SPLITMIX64_CONSTANTS = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
                        0x94D049BB133111EB)
