"""Design catalog: the Table-1 topologies and their design families
(counterpart of `repro.design.catalog`). Each `DesignFamily` owns both
the construction of a design and its timing semantics (`timing_plan`);
`get_family` is the one dispatch table. Construction functions take
optional precomputed inputs (the nominal delay matrix, a matching
decomposition), which `design.batched` shares across a sweep grid
without changing a bit.

networkx is not a dependency of this package, so the designs that call
it in the reference follow its order of operations here instead, ties
included, which keeps every graph the reference's:

* `christofides_cycle` follows `approximation.christofides` step by step:
  1. Kruskal's minimum spanning tree over the complete graph, edges taken
     in ascending weight with ties in ``(i, j)`` order;
  2. a minimum-weight maximum-cardinality matching of the tree's
     odd-degree nodes (`design.blossom`, networkx's blossom algorithm);
  3. networkx's Eulerian circuit of tree + matching: its multigraph
     keeps neighbours in insertion order, is copied once (which reorders
     each node's neighbours: earlier nodes first), and the walk always
     leaves by the first remaining neighbour, starting from node 0;
  4. shortcutting: drop every node already visited.
* `mst_topology` is networkx's Prim, its heap ties broken by push order.
* `physical_graph` unions a k-nearest graph with Kruskal over latency.

Edge weights used while constructing a topology are the congestion-free
pair delays (degree 1); cycle times are then evaluated with the degrees
the topology induces (`core/timing.py`).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Protocol

import numpy as np

from repro_torch.core import timing
from repro_torch.core.delay import Workload
from repro_torch.core.graph import (Multigraph, Pair, SimpleGraph, canon,
                                    make_graph)
from repro_torch.design import blossom
from repro_torch.networks.zoo import NetworkSpec

_K_NEAREST = 4          # neighbours per silo in the physical underlay
_DMBST_DELTA = 3        # degree cap of the delta-MBST
_MATCHA_BUDGET = 0.5    # probability that a MATCHA matching is live


def nominal_delay_matrix(net: NetworkSpec, wl: Workload) -> np.ndarray:
    """Congestion-free (degree-1) pair delay between every silo pair."""
    n = net.num_silos
    ones = np.ones(n, dtype=np.int64)
    d = timing.directed_delay_matrix(net, wl, ones, ones)
    d = np.maximum(d, d.T)
    np.fill_diagonal(d, 0.0)
    return d


def connectivity_graph(net: NetworkSpec) -> SimpleGraph:
    """G_c: possible direct communications, the complete graph."""
    n = net.num_silos
    return make_graph(n, [(i, j) for i in range(n) for j in range(i + 1, n)])


def physical_graph(net: NetworkSpec) -> SimpleGraph:
    """Approximate physical underlay of an ISP network: a symmetric
    k-nearest-neighbour graph over latency, united with the latency
    minimum spanning tree (networkx's Kruskal) so it is connected."""
    n = net.num_silos
    lat = net.latency_ms
    pairs: set[Pair] = set()
    for i in range(n):
        order = np.argsort(lat[i])
        picked = [int(j) for j in order if j != i][:_K_NEAREST]
        for j in picked:
            pairs.add(canon(i, j))
    for i, j in _edges_in_view_order(_kruskal_tree_adjacency(lat)):
        pairs.add(canon(i, j))
    return make_graph(n, pairs)


class TopologyDesign(Protocol):
    name: str

    def round_graph(self, k: int) -> SimpleGraph:
        """Active (blocking) exchanges of communication round k."""
        ...


@dataclasses.dataclass
class StaticTopology:
    name: str
    graph: SimpleGraph

    def round_graph(self, k: int) -> SimpleGraph:
        return self.graph


def star_topology(net: NetworkSpec, wl: Workload) -> StaticTopology:
    """STAR: the hub that minimizes the round's cycle time, vectorized
    over candidate hubs (leaves have degree 1, the hub N-1); the first
    minimum wins a tie."""
    n = net.num_silos
    if n == 1:
        return StaticTopology("star", make_graph(1, []))
    ones = np.ones(n, np.int64)
    fan = np.full(n, n - 1, np.int64)
    off_diag = ~np.eye(n, dtype=bool)
    d_up = timing.directed_delay_matrix(net, wl, ones, fan)  # [leaf, hub]
    d_dn = timing.directed_delay_matrix(net, wl, fan, ones)  # [hub, leaf]
    pair = np.maximum(d_up, d_dn.T)                          # [leaf, hub]
    ct = np.max(pair, axis=0, initial=-np.inf, where=off_diag)
    best_hub = int(np.argmin(ct))
    return StaticTopology(
        "star",
        make_graph(n, [(best_hub, i) for i in range(n) if i != best_hub]))


def _prim_edges(d: np.ndarray) -> list[tuple[int, int]]:
    """networkx's `prim_mst_edges` on the complete graph built by ``i < j``
    loops: start at node 0, push each newly reached node's edges to
    unvisited neighbours in ascending order, pop the lightest with ties
    broken by push order."""
    n = d.shape[0]
    nodes = set(range(n))
    push = 0
    out: list[tuple[int, int]] = []
    while nodes:
        u = min(nodes)          # set.pop() of small ints: the smallest
        nodes.discard(u)
        visited = {u}
        frontier: list = []
        for v in range(n):
            if v != u:
                heapq.heappush(frontier, (float(d[min(u, v), max(u, v)]),
                                          push, u, v))
                push += 1
        while nodes and frontier:
            _, _, a, b = heapq.heappop(frontier)
            if b in visited or b not in nodes:
                continue
            out.append((a, b))
            visited.add(b)
            nodes.discard(b)
            for w in range(n):
                if w != b and w not in visited:
                    heapq.heappush(frontier, (float(d[min(b, w), max(b, w)]),
                                              push, b, w))
                    push += 1
    return out


def mst_topology(net: NetworkSpec, wl: Workload,
                 d: np.ndarray | None = None) -> StaticTopology:
    """MST: Prim's minimum spanning tree over nominal pair delays."""
    if d is None:
        d = nominal_delay_matrix(net, wl)
    return StaticTopology("mst", make_graph(
        net.num_silos, [canon(i, j) for i, j in _prim_edges(d)]))


def dmbst_topology(net: NetworkSpec, wl: Workload,
                   d: np.ndarray | None = None) -> StaticTopology:
    """delta-MBST: greedy Kruskal over nominal delays with a degree cap;
    if the cap leaves a component unjoinable, the smallest-delay
    violating edges are admitted."""
    if d is None:
        d = nominal_delay_matrix(net, wl)
    n = net.num_silos
    edges = sorted(
        ((float(d[i, j]), i, j) for i in range(n) for j in range(i + 1, n)))
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    deg = np.zeros(n, dtype=np.int64)
    chosen: list[Pair] = []
    for _, i, j in edges:          # pass 1: respect the degree bound
        if len(chosen) == n - 1:
            break
        if find(i) != find(j) and deg[i] < _DMBST_DELTA and deg[j] < _DMBST_DELTA:
            parent[find(i)] = find(j)
            deg[i] += 1
            deg[j] += 1
            chosen.append(canon(i, j))
    for _, i, j in edges:          # pass 2: relax it where still needed
        if len(chosen) == n - 1:
            break
        if find(i) != find(j):
            parent[find(i)] = find(j)
            deg[i] += 1
            deg[j] += 1
            chosen.append(canon(i, j))
    return StaticTopology("dmbst", make_graph(n, chosen))


def _kruskal_tree_adjacency(d: np.ndarray) -> dict[int, dict[int, None]]:
    """Kruskal's MST as networkx builds it: nodes 0..n-1, then each
    accepted edge appended to both endpoints' neighbour dicts."""
    n = d.shape[0]
    edges = sorted(((float(d[i, j]), i, j) for i in range(n)
                    for j in range(i + 1, n)), key=lambda e: e[0])
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    adj: dict[int, dict[int, None]] = {i: {} for i in range(n)}
    for _, i, j in edges:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
            adj[i][j] = None
            adj[j][i] = None
    return adj


def _edges_in_view_order(adj) -> list[tuple[int, int]]:
    """networkx's `Graph.edges` order: node order, then neighbour order,
    each edge once (from its earlier-visited endpoint)."""
    seen, out = set(), []
    for u, nbrs in adj.items():
        for v in nbrs:
            if v not in seen:
                out.append((u, v))
        seen.add(u)
    return out


def christofides_cycle(d: np.ndarray) -> list[int]:
    """Christofides TSP cycle over a symmetric (N, N) weight matrix, the
    tour networkx's `approximation.christofides` returns (see the module
    docstring). N <= 3 short-circuits to the trivial cycle."""
    n = d.shape[0]
    if n <= 3:
        return list(range(n)) + [0]
    tree = _kruskal_tree_adjacency(d)
    tree_edges = _edges_in_view_order(tree)
    odd = [u for u in tree if len(tree[u]) % 2]
    # networkx matches on G minus the even nodes: the odd nodes in order,
    # each with the others in order, weighted by the i < j entries.
    sub = {u: {v: float(d[min(u, v), max(u, v)]) for v in odd if v != u}
           for u in odd}
    matching = blossom.min_weight_matching(sub)

    # The multigraph tree + matching: per node, neighbour -> [edge count],
    # one shared box per pair. Every node enters with the tree edges; a
    # matching edge only appends (or bumps a count), so the order in
    # which the matching's edges are added does not matter.
    mg: dict[int, dict[int, list[int]]] = {}
    for u, v in tree_edges + matching:
        mg.setdefault(u, {})
        mg.setdefault(v, {})
        if v in mg[u]:
            mg[u][v][0] += 1
        else:
            mg[u][v] = mg[v][u] = [1]
    # eulerian_circuit walks a copy; copying re-inserts edges node by node.
    adj: dict[int, dict[int, list[int]]] = {u: {} for u in mg}
    for u, nbrs in mg.items():
        for v, box in nbrs.items():
            if v not in adj[u]:
                adj[u][v] = adj[v][u] = [box[0]]
    stack = [next(iter(adj))]
    last = None
    circuit: list[tuple[int, int]] = []
    while stack:
        cur = stack[-1]
        if not adj[cur]:
            if last is not None:
                circuit.append((last, cur))
            last = cur
            stack.pop()
        else:
            nxt = next(iter(adj[cur]))
            stack.append(nxt)
            box = adj[cur][nxt]
            box[0] -= 1
            if box[0] == 0:
                del adj[cur][nxt]
                del adj[nxt][cur]
    tour: list[int] = []
    for u, v in circuit:
        if v in tour:
            continue
        if not tour:
            tour.append(u)
        tour.append(v)
    tour.append(tour[0])
    return tour


def ring_topology(net: NetworkSpec, wl: Workload,
                  d: np.ndarray | None = None) -> StaticTopology:
    """RING: Christofides TSP cycle over nominal pair delays, also the
    overlay the paper's multigraph is built from (paper §4.1)."""
    if d is None:
        d = nominal_delay_matrix(net, wl)
    cycle = christofides_cycle(d)
    pairs = {canon(int(cycle[i]), int(cycle[i + 1]))
             for i in range(len(cycle) - 1)}
    return StaticTopology("ring", make_graph(net.num_silos, pairs))


@dataclasses.dataclass(frozen=True)
class MatchaTopology:
    """MATCHA: a matching decomposition of the base graph, each matching
    live in a round independently with probability `budget`. The coin
    for (round k, matching m) is a splitmix64 hash of ``(seed, k, m)``
    (`_counter_uniform`), so ``round_graph(k)`` is a pure function of
    ``(seed, k)``. MATCHA runs over the connectivity graph, MATCHA+ over
    the physical underlay; the two coincide on the cloud networks."""

    name: str
    num_nodes: int
    matchings: tuple[tuple[Pair, ...], ...]
    budget: float
    seed: int = 0

    @property
    def num_matchings(self) -> int:
        return len(self.matchings)

    def activation(self, k: int) -> np.ndarray:
        """(M,) bool: which matchings are live in round k."""
        return self.activation_rows(np.asarray([k]))[0]

    def activation_rows(self, rounds_idx: np.ndarray) -> np.ndarray:
        """(len(rounds_idx), M) bool activation for arbitrary rounds."""
        u = _counter_uniform(self.seed, rounds_idx, len(self.matchings))
        return u < self.budget

    def activation_matrix(self, rounds: int) -> np.ndarray:
        """(rounds, M) bool: the whole sampled horizon at once."""
        return self.activation_rows(np.arange(rounds))

    def round_graph(self, k: int) -> SimpleGraph:
        act = self.activation(k)
        pairs: list[Pair] = []
        for live, m in zip(act, self.matchings):
            if live:
                pairs.extend(m)
        return make_graph(self.num_nodes, pairs)


def _counter_uniform(seed: int, rounds_idx: np.ndarray,
                     num_streams: int) -> np.ndarray:
    """Counter-based uniforms in [0, 1), ``(len(rounds_idx), M)``: the
    splitmix64 finalizer over a linear mix of (seed, round, stream), in
    uint64 arithmetic that wraps, then the top 53 bits as a float64."""
    p1, p2, p3 = (np.uint64(x) for x in timing.SPLITMIX64_CONSTANTS)
    k = np.asarray(rounds_idx, np.uint64)[:, None]
    m = np.arange(num_streams, dtype=np.uint64)[None, :]
    seed_mix = np.uint64((seed * timing.SPLITMIX64_CONSTANTS[2]) % 2**64)
    x = (seed_mix + k) * p1 + m * p2
    x ^= x >> np.uint64(30)
    x *= p2
    x ^= x >> np.uint64(27)
    x *= p3
    x ^= x >> np.uint64(31)
    return (x >> np.uint64(11)).astype(np.float64) * float(2.0 ** -53)


def _round_robin_matchings(n: int) -> list[list[Pair]]:
    """Circle-method 1-factorization of K_n: n-1 perfect matchings for
    even n, n near-perfect ones (one idle node each) for odd n."""
    odd = n % 2 == 1
    m = n + 1 if odd else n          # pad odd n with a phantom node
    out: list[list[Pair]] = []
    ring = list(range(1, m))         # node 0 fixed, the rest rotate
    for r in range(m - 1):
        rot = ring[r:] + ring[:r]
        stack = [0] + rot
        pairs = []
        for a, b in zip(stack[:m // 2], reversed(stack[m // 2:])):
            if odd and (a == m - 1 or b == m - 1):
                continue             # drop the phantom node's pair
            pairs.append(canon(a, b))
        out.append(sorted(pairs))
    return out


def _matching_decomposition(graph: SimpleGraph) -> list[tuple[Pair, ...]]:
    """Edge-colour the graph; each colour class is a matching. Complete
    graphs take the circle method; others a greedy pass, densest
    endpoints first, each edge the smallest colour free at both ends."""
    n = graph.num_nodes
    num_pairs = graph.num_pairs
    if num_pairs == n * (n - 1) // 2 and n >= 2:
        return [tuple(m) for m in _round_robin_matchings(n)]
    if not num_pairs:
        return []
    deg = graph.degrees()
    max_colors = 2 * int(deg.max()) - 1 if deg.max() else 1
    pi = np.fromiter((p[0] for p in graph.pairs), np.int64, num_pairs)
    pj = np.fromiter((p[1] for p in graph.pairs), np.int64, num_pairs)
    order = np.argsort(-(deg[pi] + deg[pj]), kind="stable")
    used = np.zeros((n, max_colors), dtype=bool)
    color = np.empty(num_pairs, dtype=np.int64)
    for e in order:
        i, j = pi[e], pj[e]
        c = int(np.argmax(~(used[i] | used[j])))
        color[e] = c
        used[i, c] = used[j, c] = True
    classes: dict[int, list[Pair]] = {}
    for e, c in enumerate(color):
        classes.setdefault(int(c), []).append(graph.pairs[e])
    return [tuple(sorted(v)) for _, v in sorted(classes.items())]


def matcha_topology(net: NetworkSpec, wl: Workload, seed: int = 0,
                    matchings: tuple | None = None) -> MatchaTopology:
    if matchings is None:
        matchings = tuple(_matching_decomposition(connectivity_graph(net)))
    return MatchaTopology("matcha", net.num_silos, matchings, _MATCHA_BUDGET,
                          seed)


#: Cloud networks, whose regions are fully meshed: MATCHA+ decomposes
#: their connectivity graph, as MATCHA does, and not a physical underlay.
_FULLY_MESHED = ("gaia", "amazon")


def matcha_plus_base(net: NetworkSpec) -> SimpleGraph:
    """The graph MATCHA+ decomposes into matchings: the connectivity
    graph of a cloud network, else the approximate physical underlay."""
    if net.name in _FULLY_MESHED:
        return connectivity_graph(net)
    return physical_graph(net)


def matcha_plus_topology(net: NetworkSpec, wl: Workload, seed: int = 0,
                         matchings: tuple | None = None) -> MatchaTopology:
    if matchings is None:
        matchings = tuple(_matching_decomposition(matcha_plus_base(net)))
    return MatchaTopology("matcha_plus", net.num_silos, matchings,
                          _MATCHA_BUDGET, seed)


TOPOLOGIES = {
    "star": star_topology,
    "matcha": matcha_topology,
    "matcha_plus": matcha_plus_topology,
    "mst": mst_topology,
    "dmbst": dmbst_topology,
    "ring": ring_topology,
}


def build_topology(name: str, net: NetworkSpec, wl: Workload,
                   **kw) -> TopologyDesign:
    try:
        return TOPOLOGIES[name](net, wl, **kw)
    except KeyError:
        raise KeyError(f"unknown topology {name!r}; have {sorted(TOPOLOGIES)} "
                       "(+ 'multigraph' via fl.dpasgd)") from None


# ---------------------------------------------------------------------------
# Design families: construction + timing semantics in one object
# ---------------------------------------------------------------------------


class DesignFamily(Protocol):
    """One named topology family: ``build`` constructs the design (a
    `TopologyDesign` or a `Multigraph`), ``timing_plan`` the
    `timing.TimingPlan` with the family's timing semantics (STAR's
    sequential gather and broadcast, RING's max-plus throughput, MATCHA's
    per-round sampling, the multigraph's Eq. 4 recurrence). ``ctx`` (a
    `design.batched.DesignContext`, or None) supplies shared construction
    artifacts; the outputs are the same bits either way."""

    name: str

    def build(self, net: NetworkSpec, wl: Workload, ctx=None): ...

    def timing_plan(self, net: NetworkSpec, wl: Workload, *,
                    ctx=None) -> timing.TimingPlan: ...


@dataclasses.dataclass(frozen=True)
class StarFamily:
    name: str = "star"

    def build(self, net, wl, ctx=None):
        return star_topology(net, wl)

    def timing_plan(self, net, wl, *, ctx=None):
        return timing.star_timing_plan(net, wl)


@dataclasses.dataclass(frozen=True)
class RingFamily:
    name: str = "ring"

    def build(self, net, wl, ctx=None):
        if ctx is not None:
            return StaticTopology("ring", ctx.ring_graph(wl))
        return ring_topology(net, wl)

    def timing_plan(self, net, wl, *, ctx=None,
                    overlay: SimpleGraph | None = None):
        if overlay is None:
            overlay = self.build(net, wl, ctx).graph
        return timing.ring_timing_plan(net, wl, graph=overlay)


@dataclasses.dataclass(frozen=True)
class MstFamily:
    name: str = "mst"

    def build(self, net, wl, ctx=None):
        return mst_topology(net, wl,
                            d=ctx.nominal(wl) if ctx is not None else None)

    def timing_plan(self, net, wl, *, ctx=None):
        return timing.static_timing_plan(
            self.name, net, wl, self.build(net, wl, ctx).round_graph(0))


@dataclasses.dataclass(frozen=True)
class DmbstFamily:
    name: str = "dmbst"

    def build(self, net, wl, ctx=None):
        return dmbst_topology(net, wl,
                              d=ctx.nominal(wl) if ctx is not None else None)

    def timing_plan(self, net, wl, *, ctx=None):
        return timing.static_timing_plan(
            self.name, net, wl, self.build(net, wl, ctx).round_graph(0))


@dataclasses.dataclass(frozen=True)
class MatchaFamily:
    name: str = "matcha"
    plus: bool = False
    seed: int = 0
    sample_rounds: int = 512

    def build(self, net, wl, ctx=None):
        builder = matcha_plus_topology if self.plus else matcha_topology
        matchings = None
        if ctx is not None:
            matchings = (ctx.matcha_plus_matchings() if self.plus
                         else ctx.matcha_matchings())
        return builder(net, wl, seed=self.seed, matchings=matchings)

    def timing_plan(self, net, wl, *, ctx=None):
        design = self.build(net, wl, ctx)
        sampler = None
        if ctx is not None:
            sampler = ctx.sampler(design, wl, self.sample_rounds)
        return timing.sampled_timing_plan(
            self.name, net, wl, design, sample_rounds=self.sample_rounds,
            sampler=sampler)


@dataclasses.dataclass(frozen=True)
class MultigraphFamily:
    name: str = "multigraph"
    t: int = 5
    cap_states: int | None = timing.CAP_STATES

    def build(self, net, wl, ctx=None,
              overlay: SimpleGraph | None = None) -> Multigraph:
        from repro_torch.core.multigraph import build_multigraph

        if overlay is None:
            overlay = (ctx.ring_graph(wl) if ctx is not None
                       else ring_topology(net, wl).graph)
        return build_multigraph(net, wl, overlay, t=self.t)

    def timing_plan(self, net, wl, *, ctx=None,
                    overlay: SimpleGraph | None = None):
        if overlay is None and ctx is not None:
            overlay = ctx.ring_graph(wl)
        return timing.multigraph_timing_plan(
            net, wl, t=self.t, overlay=overlay, cap_states=self.cap_states)


#: The Table-1 catalog, as zero-config instances; `get_family` sets the
#: knobs each one takes (`_FAMILY_KNOBS`).
DESIGN_FAMILIES = {
    "star": StarFamily(),
    "matcha": MatchaFamily(),
    "matcha_plus": MatchaFamily(name="matcha_plus", plus=True),
    "mst": MstFamily(),
    "dmbst": DmbstFamily(),
    "ring": RingFamily(),
    "multigraph": MultigraphFamily(),
}

_FAMILY_KNOBS = {
    "matcha": ("seed", "sample_rounds"),
    "matcha_plus": ("seed", "sample_rounds"),
    "multigraph": ("t", "cap_states"),
}


def get_family(name: str, *, t: int = 5,
               cap_states: int | None = timing.CAP_STATES,
               seed: int = 0, sample_rounds: int = 512) -> DesignFamily:
    """The design family ``name`` with its knobs set."""
    try:
        base = DESIGN_FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown topology {name!r}; have "
                       f"{sorted(DESIGN_FAMILIES)}") from None
    knobs = dict(t=t, cap_states=cap_states, seed=seed,
                 sample_rounds=sample_rounds)
    kw = {k: knobs[k] for k in _FAMILY_KNOBS.get(name, ())}
    return dataclasses.replace(base, **kw) if kw else base
