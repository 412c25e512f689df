"""The paper's network model and overlay, worked out again in numpy: a
frozen copy of the float operations that `run_fl` runs to build them.

* Eq. 3 delays over a network's silos (site tables under
  `bench/networks/`);
* the overlay: the Christofides ring over congestion-free pair delays,
  as networkx's `approximation.christofides` builds it (Kruskal, a
  minimum-weight matching by `blossom`, the Eulerian walk, shortcuts).

Each topology's round plan and simulated clock is a module of its own,
`topology_<name>.py`, found by the traffic's ``topology``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

from bench.reference import blossom

NETWORKS = Path(__file__).resolve().parents[1] / "networks"
_EARTH_RADIUS_KM = 6371.0
_KM_PER_MS = 200.0
_PATH_STRETCH = 1.5
_PER_HOP_MS = 0.5


@dataclasses.dataclass(frozen=True)
class Network:
    name: str
    latency_ms: np.ndarray      # (N, N)
    upload_gbps: np.ndarray     # (N,)
    download_gbps: np.ndarray   # (N,)
    compute_scale: np.ndarray   # (N,)

    @property
    def num_silos(self) -> int:
        return len(self.compute_scale)


def _haversine_km(lat1, lon1, lat2, lon2) -> float:
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lon2 - lon1)
    a = (math.sin(dp / 2) ** 2
         + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2)
    return 2 * _EARTH_RADIUS_KM * math.asin(math.sqrt(a))


def _expand_metros(metros, count: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    sites = []
    k = 0
    while len(sites) < count:
        name, la, lo = metros[k % len(metros)]
        rep = k // len(metros)
        if rep == 0:
            sites.append((name, la, lo))
        else:
            dla = float(rng.uniform(-0.3, 0.3))
            dlo = float(rng.uniform(-0.3, 0.3))
            sites.append((f"{name}_{rep}", la + dla, lo + dlo))
        k += 1
    return sites


def load_network(name: str) -> Network:
    """The network of ``bench/networks/<name>.json``: its sites (or the
    metros they are spread over), access links and compute speeds."""
    spec = json.loads((NETWORKS / f"{name}.json").read_text())
    sites = spec["sites"] or _expand_metros(spec["metros"], spec["count"],
                                            spec["expand_seed"])
    n = len(sites)
    rng = np.random.default_rng(spec["hetero_seed"])
    cap, cj, pj = (spec["capacity_gbps"], spec["capacity_jitter"],
                   spec["compute_jitter"])
    up = cap * np.exp(rng.uniform(-cj, cj, n))
    dn = cap * np.exp(rng.uniform(-cj, cj, n))
    comp = np.exp(rng.uniform(-pj, pj, n))
    lat = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            km = _haversine_km(sites[i][1], sites[i][2], sites[j][1],
                               sites[j][2])
            lat[i, j] = lat[j, i] = km * _PATH_STRETCH / _KM_PER_MS \
                + _PER_HOP_MS
    # the program keeps each silo's numbers as Python floats and reads
    # them back into float64 arrays: the same values
    return Network(name, lat, np.array([float(x) for x in up]),
                   np.array([float(x) for x in dn]),
                   np.array([float(x) for x in comp]))


def compute_ms(net: Network, wl: dict) -> np.ndarray:
    """u * T_c(i) of every silo."""
    return wl["local_updates"] * wl["base_compute_ms"] * net.compute_scale


def directed_delay_matrix(net: Network, wl: dict, out_deg, in_deg):
    """Eq. 3 for every directed transfer i -> j: (N, N) ms."""
    comp = compute_ms(net, wl)
    cap = np.minimum((net.upload_gbps / np.maximum(out_deg, 1))[:, None],
                     (net.download_gbps / np.maximum(in_deg, 1))[None, :])
    transfer = wl["model_size_mbits"] / (cap * 1000.0) * 1000.0
    return comp[:, None] + net.latency_ms + transfer


def pair_delays(net: Network, wl: dict, pair_i, pair_j, deg) -> np.ndarray:
    d = directed_delay_matrix(net, wl, deg, deg)
    return np.maximum(d[pair_i, pair_j], d[pair_j, pair_i])


def _kruskal_tree(d: np.ndarray) -> dict:
    n = d.shape[0]
    edges = sorted(((float(d[i, j]), i, j) for i in range(n)
                    for j in range(i + 1, n)), key=lambda e: e[0])
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    adj = {i: {} for i in range(n)}
    for _, i, j in edges:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
            adj[i][j] = None
            adj[j][i] = None
    return adj


def _edges_in_view_order(adj) -> list:
    seen, out = set(), []
    for u, nbrs in adj.items():
        for v in nbrs:
            if v not in seen:
                out.append((u, v))
        seen.add(u)
    return out


def christofides_cycle(d: np.ndarray) -> list:
    """networkx's Christofides tour over a symmetric weight matrix."""
    n = d.shape[0]
    if n <= 3:
        return list(range(n)) + [0]
    tree = _kruskal_tree(d)
    tree_edges = _edges_in_view_order(tree)
    odd = [u for u in tree if len(tree[u]) % 2]
    sub = {u: {v: float(d[min(u, v), max(u, v)]) for v in odd if v != u}
           for u in odd}
    matching = blossom.min_weight_matching(sub)
    mg: dict = {}
    for u, v in tree_edges + matching:
        mg.setdefault(u, {})
        mg.setdefault(v, {})
        if v in mg[u]:
            mg[u][v][0] += 1
        else:
            mg[u][v] = mg[v][u] = [1]
    adj: dict = {u: {} for u in mg}
    for u, nbrs in mg.items():
        for v, box in nbrs.items():
            if v not in adj[u]:
                adj[u][v] = adj[v][u] = [box[0]]
    stack = [next(iter(adj))]
    last = None
    circuit = []
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
    tour = []
    for u, v in circuit:
        if v in tour:
            continue
        if not tour:
            tour.append(u)
        tour.append(v)
    tour.append(tour[0])
    return tour


def ring_pairs(net: Network, wl: dict) -> list:
    """The overlay: the Christofides ring over congestion-free delays,
    as sorted (i < j) pairs."""
    ones = np.ones(net.num_silos, dtype=np.int64)
    d = directed_delay_matrix(net, wl, ones, ones)
    d = np.maximum(d, d.T)
    np.fill_diagonal(d, 0.0)
    cyc = christofides_cycle(d)
    return sorted({(min(cyc[k], cyc[k + 1]), max(cyc[k], cyc[k + 1]))
                   for k in range(len(cyc) - 1)})
