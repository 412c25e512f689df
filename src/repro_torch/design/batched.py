"""Batched topology construction (counterpart of `repro.design.batched`,
DESIGN.md §12; its ``"jax"`` scorer is the ``"torch"`` one here).

A sweep grid shares its construction artifacts instead of rebuilding
them per cell: the nominal delay matrix per (network, workload), the
physical underlay and matching decompositions per network, and the
MATCHA per-round horizon, which is made at evaluation time, not at plan
construction:

* :func:`christofides_tours` / :func:`min_weight_matchings` — batched
  graph-algorithm entry points that dedup *bit-identical* inputs; each
  unique input runs the package's networkx-free algorithms
  (`catalog.christofides_cycle`, `blossom.min_weight_matching`), which
  follow networkx's order of operations, ties included.
  Note the limit of safe sharing: the paper networks have per-silo
  compute scales and link capacities, so the nominal delay matrices of
  two workloads are NOT monotone transforms of each other and their
  tours genuinely differ (verified empirically) — dedup keys on the
  exact weight bytes, never on the network alone.
* :class:`DesignContext` — per-network memo of construction artifacts:
  nominal matrices and Christofides ring graphs per workload (shared by
  RING and every multigraph t), and the provably workload-INdependent
  artifacts (physical underlay, matching decompositions, MATCHA
  activation tables) computed once per network.
* :func:`batched_sampled_cycle_times` — the MATCHA horizon via a
  factorized fast path: for near-1-factorization bases (every complete
  graph — the expensive cells) the per-round degree of node i is
  ``A_r - act[idler(i)]``, so the Eq. 3 delay of every pair takes one
  of four per-round values tabulated once per (share-count, class) and
  the whole horizon becomes a table gather + masked max. Every
  elementwise operation replays `timing.sampled_cycle_times`'s exact
  fp sequence, so the result is bit-for-bit identical (tested).
* :class:`SweepConstructor` — the sweep's construction front end: one
  `DesignContext` per network, lazy sampled plans whose samplers hit
  the shared activation caches, so plan construction is the discrete
  design work only and the horizon materializes in the EVAL phase.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import timing, timing_torch
from repro_torch.core.delay import Workload
from repro_torch.core.graph import Pair, SimpleGraph, canon
from repro_torch.design import blossom, catalog
from repro_torch.device import resolve_device
from repro_torch.networks.zoo import NetworkSpec

__all__ = [
    "christofides_tours", "min_weight_matchings", "DesignContext",
    "SweepConstructor", "batched_sampled_cycle_times",
    "CandidateBatch", "CandidateScorer", "stack_multiplicity_candidates",
]


# ---------------------------------------------------------------------------
# batched graph algorithms (exact dedup)
# ---------------------------------------------------------------------------


def _weight_key(d: np.ndarray) -> tuple:
    d = np.ascontiguousarray(np.asarray(d, np.float64))
    return (d.shape, d.tobytes())


def christofides_tours(weights) -> list[list[int]]:
    """Christofides cycles for a batch of (N, N) weight matrices.

    Bit-identical inputs are solved once (the dedup key is the exact
    f64 byte pattern, so two cells share a tour only when ANY correct
    per-cell run would have received the same matrix). Each unique
    matrix runs `catalog.christofides_cycle` — the per-cell oracle.
    """
    cache: dict[tuple, list[int]] = {}
    out = []
    for d in weights:
        key = _weight_key(d)
        if key not in cache:
            cache[key] = catalog.christofides_cycle(np.asarray(d, np.float64))
        out.append(list(cache[key]))
    return out


def min_weight_matchings(weights, node_sets=None) -> list[set[Pair]]:
    """Min-weight perfect matchings for a batch of weight matrices.

    ``node_sets[b]`` restricts matrix ``b`` to a node subset (the
    odd-degree vertices inside Christofides); default is all nodes.
    Dedup is on exact (weights, nodes) bytes; each unique instance runs
    `blossom.min_weight_matching` on the induced complete subgraph,
    built in the order networkx's ``Graph.add_edge`` loop builds it.
    """
    cache: dict[tuple, set] = {}
    out = []
    for b, d in enumerate(weights):
        d = np.asarray(d, np.float64)
        nodes = (tuple(range(d.shape[0])) if node_sets is None
                 else tuple(int(v) for v in node_sets[b]))
        key = (_weight_key(d), nodes)
        if key not in cache:
            adj: dict[int, dict[int, float]] = {}
            for x, i in enumerate(nodes):
                for j in nodes[x + 1:]:
                    adj.setdefault(i, {})
                    adj.setdefault(j, {})
                    adj[i][j] = adj[j][i] = float(d[i, j])
            m = blossom.min_weight_matching(adj)
            cache[key] = {canon(int(i), int(j)) for i, j in m}
        out.append(set(cache[key]))
    return out


# ---------------------------------------------------------------------------
# factorized MATCHA sampling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Factorization:
    """A near-1-factorization: each matching misses at most one node and
    each node is missed by at most one matching, so the active degree of
    node i is ``A_r - act[r, idler[i]]`` — the structure that collapses
    the per-round Eq. 3 delays to four table rows per active count."""

    idler: np.ndarray    # (N,) matching index idling node i, M if none
    idle_of: np.ndarray  # (M,) node idled by matching m, -1 if perfect


def _detect_factorization(matchings, n: int) -> _Factorization | None:
    num_m = len(matchings)
    if not num_m or n == 0:
        return None
    node_in = np.zeros((num_m, n), bool)
    for mi, m in enumerate(matchings):
        for a, b in m:
            node_in[mi, a] = node_in[mi, b] = True
    missed = ~node_in
    if (missed.sum(axis=1) > 1).any() or (missed.sum(axis=0) > 1).any():
        return None
    idler = np.full(n, num_m, np.int64)
    idle_of = np.full(num_m, -1, np.int64)
    mi, ni = np.nonzero(missed)
    idler[ni] = mi
    idle_of[mi] = ni
    return _Factorization(idler=idler, idle_of=idle_of)


def _factorized_sampled_cycle_times(design, fact: _Factorization,
                                    net: NetworkSpec, wl: Workload,
                                    num_rounds: int,
                                    act: np.ndarray) -> np.ndarray:
    """`timing.sampled_cycle_times` for a near-1-factorized base.

    Per round, node i's share is ``max(A_r - a_i, 1)`` with
    ``a_i = act[r, idler[i]] ∈ {0, 1}``, so a pair's Eq. 3 delay takes
    one of 4 values per active count A — tabulated once as
    ``T[A, a_i, a_j, e]`` with the EXACT op sequence of the general
    path (same divisions in the same order), then gathered per round.
    The masked max over live pairs and the lone-node terms follow the
    general path literally, so the output is bit-for-bit identical.
    """
    matchings = design.matchings
    base_pairs = sorted({p for m in matchings for p in m})
    num_pairs = len(base_pairs)
    comp = wl.compute_ms(net).astype(np.float64)
    n = net.num_silos
    if num_rounds == 0:
        return np.zeros(0, np.float64)
    if num_pairs == 0:
        return np.full(num_rounds, float(comp.max()) if n else 0.0)
    pair_of = {p: e for e, p in enumerate(base_pairs)}
    m_of_pair = np.empty(num_pairs, np.int64)
    for mi, m in enumerate(matchings):
        for p in m:
            m_of_pair[pair_of[p]] = mi
    pi = np.fromiter((p[0] for p in base_pairs), np.int64, num_pairs)
    pj = np.fromiter((p[1] for p in base_pairs), np.int64, num_pairs)
    lat = net.latency_ms
    up = net.upload_gbps()
    dn = net.download_gbps()
    base_ij = comp[pi] + lat[pi, pj]
    base_ji = comp[pj] + lat[pj, pi]
    num_m = len(matchings)

    # Delay table T[A, a_i, a_j, e]: shares si = max(A - a_i, 1) etc.
    # The same scalar divisions the general path performs (up_i/share_i
    # before the min, the min times 1000 under M, times 1000) — only
    # tabulated over the <= (M+1)*4 distinct (A, class) rows instead of
    # recomputed for every (round, pair).
    A_ax = np.arange(num_m + 1, dtype=np.int64)
    s_tab = np.maximum(A_ax[:, None] - np.array([0, 1]), 1)  # (M+1, 2)
    s_tab = s_tab.astype(np.float64)
    up_i = up[pi][None, None, :] / s_tab[:, :, None]   # (M+1, 2, E) a_up[:, pi]
    dn_j = dn[pj][None, None, :] / s_tab[:, :, None]   # (M+1, 2, E) a_dn[:, pj]
    up_j = up[pj][None, None, :] / s_tab[:, :, None]
    dn_i = dn[pi][None, None, :] / s_tab[:, :, None]
    mbits = wl.model_size_mbits
    tr = mbits / (np.minimum(up_i[:, :, None, :], dn_j[:, None, :, :])
                  * 1000.0) * 1000.0
    d_ij = base_ij[None, None, None, :] + tr
    tr = mbits / (np.minimum(up_j[:, None, :, :], dn_i[:, :, None, :])
                  * 1000.0) * 1000.0
    d_ji = base_ji[None, None, None, :] + tr
    table = np.maximum(d_ij, d_ji).reshape((num_m + 1) * 4, num_pairs)

    # act with a phantom always-False column: idler == M means "never
    # idled", so a_i gathers to False.
    act_pad = np.zeros((num_rounds, num_m + 1), bool)
    act_pad[:, :num_m] = act
    a_cnt = act.astype(np.int64).sum(axis=1)               # (R,) == A_r
    # Lone nodes: A == 0 -> every node idle; A == 1 -> exactly the node
    # idled by the single active matching (if it idles one).
    lone_of_m = np.where(fact.idle_of >= 0,
                         comp[np.maximum(fact.idle_of, 0)], -np.inf)
    single = np.argmax(act, axis=1)                        # valid if A == 1
    lone = np.where(a_cnt == 0, comp.max() if n else -np.inf,
                    np.where(a_cnt == 1, lone_of_m[single], -np.inf))

    idler_i = fact.idler[pi]
    idler_j = fact.idler[pj]
    a4 = (a_cnt * 4).astype(np.int32)          # idx = A*4 + 2*a_i + a_j
    out = np.empty(num_rounds, np.float64)
    rows = max(1, timing._SAMPLE_CHUNK_ELEMS // max(num_pairs, 1))
    for lo in range(0, num_rounds, rows):
        ap = act_pad[lo:lo + rows]
        ai = ap[:, idler_i]                                # (Rc, E) bool
        aj = ap[:, idler_j]
        idx = a4[lo:lo + rows, None] + (2 * ai + aj).astype(np.int32)
        val = np.take_along_axis(table, idx, axis=0)
        live = ap[:, m_of_pair]
        tau = np.max(np.where(live, val, -np.inf), axis=1)
        tau = np.maximum(tau, lone[lo:lo + rows])
        out[lo:lo + rows] = np.where(np.isfinite(tau), tau, 0.0)
    return out


def batched_sampled_cycle_times(design, net: NetworkSpec, wl: Workload,
                                num_rounds: int,
                                act: np.ndarray | None = None) -> np.ndarray:
    """Drop-in, bit-exact replacement for `timing.sampled_cycle_times`.

    Near-1-factorized bases (every complete graph — MATCHA's
    connectivity base, the expensive sweep cells) take the factorized
    table path; anything else falls back to the general engine.
    """
    fact = _detect_factorization(design.matchings, net.num_silos)
    if fact is None:
        return timing.sampled_cycle_times(design, net, wl, num_rounds)
    if act is None:
        act = design.activation_matrix(num_rounds)
    return _factorized_sampled_cycle_times(design, fact, net, wl,
                                           num_rounds, act)


# ---------------------------------------------------------------------------
# per-network construction context
# ---------------------------------------------------------------------------


class DesignContext:
    """Construction-artifact memo for one network (duck-typed ``ctx``
    consumed by the `design.catalog` families).

    Per (network, workload): the nominal delay matrix (previously built
    3x per cell group — MST, dMBST, RING each rebuilt it) and the
    Christofides ring graph (shared by RING and every multigraph t).
    Per network: the physical underlay, the MATCHA(+) matching
    decompositions, and the MATCHA activation tables + sampled horizons
    keyed by (matchings, budget, seed, rounds, workload) — which also
    dedups MATCHA vs MATCHA(+) on fully-meshed cloud networks, where
    the two designs are the same object under different names.
    """

    def __init__(self, net: NetworkSpec):
        self.net = net
        self._nominal: dict[str, np.ndarray] = {}
        self._ring: dict[str, SimpleGraph] = {}
        self._per_net: dict[str, object] = {}
        self._act: dict[tuple, np.ndarray] = {}
        self._sampled: dict[tuple, np.ndarray] = {}

    # -- per-(network, workload) artifacts --------------------------------

    def nominal(self, wl: Workload) -> np.ndarray:
        if wl.name not in self._nominal:
            self._nominal[wl.name] = catalog.nominal_delay_matrix(self.net, wl)
        return self._nominal[wl.name]

    def ring_graph(self, wl: Workload) -> SimpleGraph:
        if wl.name not in self._ring:
            self._ring[wl.name] = catalog.ring_topology(
                self.net, wl, d=self.nominal(wl)).graph
        return self._ring[wl.name]

    # -- per-network (provably workload-independent) artifacts ------------

    def physical(self) -> SimpleGraph:
        if "physical" not in self._per_net:
            self._per_net["physical"] = catalog.physical_graph(self.net)
        return self._per_net["physical"]

    def matcha_matchings(self) -> tuple:
        if "matcha" not in self._per_net:
            base = catalog.connectivity_graph(self.net)
            self._per_net["matcha"] = tuple(
                catalog._matching_decomposition(base))
        return self._per_net["matcha"]

    def matcha_plus_matchings(self) -> tuple:
        if "matcha_plus" not in self._per_net:
            # on a cloud network the base is MATCHA's, so the matchings
            # are equal and the sampled horizon dedups
            self._per_net["matcha_plus"] = tuple(
                catalog._matching_decomposition(
                    catalog.matcha_plus_base(self.net)))
        return self._per_net["matcha_plus"]

    def activation(self, design, num_rounds: int) -> np.ndarray:
        key = (design.matchings, design.budget, design.seed, num_rounds)
        if key not in self._act:
            self._act[key] = design.activation_matrix(num_rounds)
        return self._act[key]

    # -- evaluation-phase sampling ----------------------------------------

    def sampler(self, design, wl: Workload, sample_rounds: int):
        """Zero-arg closure for a lazy sampled `TimingPlan`: computes
        (once) and returns the per-round horizon through the shared
        caches. Runs at evaluation time, not construction time."""
        key = (design.matchings, design.budget, design.seed,
               sample_rounds, wl.name)

        def run():
            if key not in self._sampled:
                self._sampled[key] = batched_sampled_cycle_times(
                    design, self.net, wl, sample_rounds,
                    act=self.activation(design, sample_rounds))
            return self._sampled[key]

        return run


# ---------------------------------------------------------------------------
# batched candidate scoring (population search's evaluation engine)
# ---------------------------------------------------------------------------


def _capped_rows(mults: np.ndarray, cap_states: int | None) -> np.ndarray:
    """Row-wise `parsing.capped_multiplicities`: the largest uniform
    clamp per candidate with ``lcm(min(m, clamp)) <= cap_states``.
    Identical semantics to the dict path (property-tested); kept as a
    small host loop because the clamp rarely iterates at paper t."""
    if cap_states is None:
        return mults.copy()
    if cap_states < 1:
        raise ValueError(f"cap_states must be >= 1, got {cap_states}")
    out = mults.copy()
    for row in out:
        if not row.size:
            continue
        m_max = int(row.max())
        while m_max > 1 and \
                int(np.lcm.reduce(np.minimum(row, m_max))) > cap_states:
            m_max -= 1
        np.minimum(row, m_max, out=row)
    return out


@dataclasses.dataclass(frozen=True)
class CandidateBatch:
    """Stacked Eq. 4 arrays for C multiplicity vectors over ONE overlay.

    Same padding contract as `timing.build_timing_grid` (phantom states
    carry strong=False / trans=T_SS / lone=-inf and are never indexed,
    since each cell's phase is ``k % num_states[c]``), so the arrays
    feed `timing._grid_recurrence_taus` directly. Bit-for-bit equal to
    stacking the per-candidate `timing.multiplicity_vector_plan` arrays.
    """

    capped: np.ndarray      # (C, E) int64 capped multiplicities
    num_states: np.ndarray  # (C,) int64 per-candidate schedule length
    strong: np.ndarray      # (C, S_max, E) bool
    trans: np.ndarray       # (C, S_max, E) int8 transition codes
    lone_comp: np.ndarray   # (C, S_max) f64


def stack_multiplicity_candidates(overlay: SimpleGraph, comp: np.ndarray,
                                  cands, *,
                                  cap_states: int | None = timing.CAP_STATES
                                  ) -> CandidateBatch:
    """Vectorized construction of a whole candidate population.

    The per-candidate constructor builds each plan's arrays one at a
    time (Algorithm 2 closed form, ~1 ms each — which dominates
    population scoring at thousands of candidates per generation).
    Here the closed form broadcasts over the candidate axis instead:
    ``strong[c, m, e] = (m % capped[c, e] == 0)`` and the previous
    state's mask is the same formula at ``m - 1`` (Python modulo makes
    the m=0 wraparound exact: ``(-1) % L == L - 1``, zero iff L == 1 —
    exactly `np.roll`'s state ``S_c - 1``, since S_c = lcm is 0 mod L).
    """
    pairs = overlay.pairs
    num_pairs = len(pairs)
    if not num_pairs:
        raise ValueError("cannot stack candidates over a zero-pair overlay")
    comp = np.asarray(comp, np.float64)
    mm = np.array([tuple(int(m) for m in c) for c in cands], np.int64)
    mm = mm.reshape(len(mm), num_pairs)
    if (mm < 1).any():
        raise ValueError("multiplicities must be >= 1")
    capped = _capped_rows(mm, cap_states)
    num_states = np.lcm.reduce(capped, axis=1)
    num_cells = len(capped)
    s_max = int(num_states.max()) if num_cells else 1
    m = np.arange(s_max, dtype=np.int64)
    strong = (m[None, :, None] % capped[:, None, :]) == 0
    prev = ((m - 1)[None, :, None] % capped[:, None, :]) == 0
    trans = (2 * prev.astype(np.int8) + strong.astype(np.int8))

    pi = np.fromiter((p[0] for p in pairs), np.int64, num_pairs)
    pj = np.fromiter((p[1] for p in pairs), np.int64, num_pairs)
    n = comp.shape[0]
    incidence = np.zeros((num_pairs, n), np.float64)
    incidence[np.arange(num_pairs), pi] = 1.0
    incidence[np.arange(num_pairs), pj] = 1.0
    lone = np.empty((num_cells, s_max), np.float64)
    # (C, S, N) intermediates are chunked over candidates (ebone at
    # C=1024 would be ~2.5 GB otherwise); per-chunk ops replay the
    # per-plan constructor's exact sequence (0/1 matmul counts are
    # integer-exact, so the > 0 mask and masked max match bitwise).
    step = max(1, 32_000_000 // max(s_max * max(n, 1) * 8, 1))
    for lo in range(0, num_cells, step):
        in_strong = (strong[lo:lo + step].astype(np.float64)
                     @ incidence) > 0
        lone[lo:lo + step] = np.max(
            np.where(in_strong, -np.inf, comp[None, None, :]), axis=2)

    # Apply the grid padding contract to states past each cell's own
    # schedule (the modulo formulas above tile the schedule instead).
    valid = m[None, :] < num_states[:, None]
    strong &= valid[:, :, None]
    trans = np.where(valid[:, :, None], trans,
                     np.int8(timing.T_SS))
    lone = np.where(valid, lone, -np.inf)
    return CandidateBatch(capped=capped, num_states=num_states,
                          strong=strong, trans=trans, lone_comp=lone)


class CandidateScorer:
    """Mean-cycle-time scorer for multiplicity vectors over one overlay
    — the population engine's evaluation core.

    Construction artifacts that are shared by every candidate (Eq. 3
    pair delays ``d0``, per-pair compute, with optional observed-delay
    overrides) are computed once; each `score` call stacks its
    candidate set with `stack_multiplicity_candidates` and evaluates
    all of them in ONE grid program. ``backend="torch"`` uploads the
    shared ``(E,)`` rows to ``device`` (the card unless told otherwise)
    once per scorer and runs the `core/timing_torch.py` grid;
    ``backend="numpy"`` feeds the same stacked arrays to
    `timing._grid_recurrence_taus`, the bit-exact oracle. Any other
    ``backend`` raises. Scores are bit for bit `search.score_candidates`
    on either backend.
    """

    def __init__(self, net: NetworkSpec, wl: Workload,
                 overlay: SimpleGraph, *, rounds: int,
                 cap_states: int | None = timing.CAP_STATES,
                 d0_override: np.ndarray | None = None,
                 comp_override: np.ndarray | None = None,
                 backend: str = "torch", device=None):
        if backend not in ("torch", "numpy"):
            raise ValueError(f"unknown scorer backend {backend!r} "
                             "(expected 'torch' or 'numpy')")
        pairs = overlay.pairs
        num_pairs = len(pairs)
        if not num_pairs:
            raise ValueError("scorer needs an overlay with >= 1 pair")
        self.net, self.wl, self.overlay = net, wl, overlay
        self.rounds = int(rounds)
        self.cap_states = cap_states
        self.backend = backend
        pi = np.fromiter((p[0] for p in pairs), np.int64, num_pairs)
        pj = np.fromiter((p[1] for p in pairs), np.int64, num_pairs)
        comp = (wl.compute_ms(net).astype(np.float64)
                if comp_override is None
                else np.asarray(comp_override, np.float64))
        if comp.shape != (net.num_silos,):
            raise ValueError(f"comp_override shape {comp.shape} != "
                             f"({net.num_silos},)")
        d0 = (timing.pair_delay_vector(net, wl, pi, pj, overlay.degrees())
              if d0_override is None
              else np.asarray(d0_override, np.float64))
        if d0.shape != (num_pairs,):
            raise ValueError(f"d0_override shape {d0.shape} != "
                             f"({num_pairs},)")
        self.comp = comp
        self.d0 = d0
        self.pair_comp = np.maximum(comp[pi], comp[pj])
        if backend == "torch":
            dev = resolve_device(device)
            self._dev = tuple(torch.as_tensor(x, dtype=torch.float64,
                                              device=dev)
                              for x in (d0, self.pair_comp))

    def score(self, cands) -> np.ndarray:
        """(len(cands),) f64 mean cycle time (ms) over the horizon."""
        cands = list(cands)
        if not cands:
            return np.zeros(0, np.float64)
        batch = stack_multiplicity_candidates(
            self.overlay, self.comp, cands, cap_states=self.cap_states)
        if self.backend == "torch":
            d0, pair_comp = self._dev
            taus = timing_torch.grid_recurrence_taus(
                d0, pair_comp, batch.strong, batch.trans, batch.lone_comp,
                batch.num_states, self.rounds, device=d0.device)
        else:
            num_pairs = len(self.d0)
            taus = timing._grid_recurrence_taus(
                np.broadcast_to(self.d0, (len(cands), num_pairs)),
                np.broadcast_to(self.pair_comp, (len(cands), num_pairs)),
                batch.strong, batch.trans, batch.lone_comp,
                batch.num_states, self.rounds)
        # Per-row float(mean) on the host: the reduction `CycleTimeReport`
        # applies (a device mean sums in another order).
        return np.array([float(t.mean()) for t in taus])


class SweepConstructor:
    """Construction front end for sweep grids: one `DesignContext` per
    network, every plan built through the shared caches. Outputs are
    bit-identical to per-cell construction (`core/sweep.py --check`)."""

    def __init__(self):
        self._ctx: dict[str, DesignContext] = {}

    def context(self, net: NetworkSpec) -> DesignContext:
        if net.name not in self._ctx:
            self._ctx[net.name] = DesignContext(net)
        return self._ctx[net.name]

    def make_plan(self, topology: str, net: NetworkSpec, wl: Workload, *,
                  t: int = 5, seed: int = 0,
                  sample_rounds: int = 512) -> timing.TimingPlan:
        return timing.make_timing_plan(
            topology, net, wl, t=t, seed=seed, sample_rounds=sample_rounds,
            ctx=self.context(net))
