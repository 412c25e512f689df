"""Design catalog, the part the multigraph needs (counterpart of
`repro.design.catalog`): the nominal delay matrix, a Christofides tour
and the ring overlay built from it.

`christofides_cycle` follows networkx's `approximation.christofides`
step by step without importing networkx, so the tour (and therefore the
overlay the multigraph is built on) is the reference's:

1. Kruskal's minimum spanning tree over the complete graph, edges taken
   in ascending weight with ties in ``(i, j)`` order;
2. an exact minimum-weight perfect matching of the tree's odd-degree
   nodes (a bitmask dynamic program, so at most `MAX_ODD_NODES` of them);
3. networkx's Eulerian circuit of tree + matching: its multigraph keeps
   neighbours in insertion order, is copied once (which reorders each
   node's neighbours: earlier nodes first), and the walk always leaves
   by the first remaining neighbour, starting from node 0;
4. shortcutting: drop every node already visited.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core import timing
from repro_torch.core.delay import Workload
from repro_torch.core.graph import SimpleGraph, canon, make_graph
from repro_torch.networks.zoo import NetworkSpec

#: Largest odd-node count the exact matching takes (2**16 DP states).
#: gaia has 6 and amazon 8-10; geant, exodus and ebone have more.
MAX_ODD_NODES = 16


def nominal_delay_matrix(net: NetworkSpec, wl: Workload) -> np.ndarray:
    """Congestion-free (degree-1) pair delay between every silo pair."""
    n = net.num_silos
    ones = np.ones(n, dtype=np.int64)
    d = timing.directed_delay_matrix(net, wl, ones, ones)
    d = np.maximum(d, d.T)
    np.fill_diagonal(d, 0.0)
    return d


@dataclasses.dataclass
class StaticTopology:
    name: str
    graph: SimpleGraph


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


def _min_weight_perfect_matching(nodes: list[int],
                                 d: np.ndarray) -> list[tuple[int, int]]:
    """Exact minimum-weight perfect matching of an even node list."""
    k = len(nodes)
    if k > MAX_ODD_NODES:
        raise NotImplementedError(
            f"christofides_cycle: the spanning tree has {k} odd-degree "
            f"nodes; the exact matching handles at most {MAX_ODD_NODES} "
            "(gaia and amazon). geant, exodus and ebone need a blossom "
            "matching, which this package does not have yet")
    full = (1 << k) - 1

    @functools.lru_cache(maxsize=None)
    def best(mask: int) -> tuple[float, tuple]:
        if mask == full:
            return 0.0, ()
        a = (~mask & -~mask).bit_length() - 1        # lowest unmatched
        top = (float("inf"), ())
        for b in range(a + 1, k):
            if mask >> b & 1:
                continue
            cost, rest = best(mask | 1 << a | 1 << b)
            cost += float(d[nodes[a], nodes[b]])
            if cost < top[0]:
                top = (cost, ((nodes[a], nodes[b]),) + rest)
        return top

    return list(best(0)[1])


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
    matching = _min_weight_perfect_matching(odd, d)

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
    """RING: Christofides TSP cycle over nominal pair delays, the overlay
    the paper's multigraph is built from (paper §4.1)."""
    if d is None:
        d = nominal_delay_matrix(net, wl)
    cycle = christofides_cycle(d)
    pairs = {canon(int(cycle[i]), int(cycle[i + 1]))
             for i in range(len(cycle) - 1)}
    return StaticTopology("ring", make_graph(net.num_silos, pairs))
