"""Graph datatypes for topology design (counterpart of `repro.core.graph`).

* Nodes are integers ``0..N-1`` indexing `NetworkSpec` silos.
* Topology graphs are at **pair level** (undirected): an active pair
  ``(i, j)`` is a bidirectional model exchange. The pair delay is the
  max of the two directed delays.
* A multigraph state labels each pair STRONG (blocking exchange this
  round) or WEAK (consume the stale buffer).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

STRONG = 1
WEAK = 0

Pair = tuple[int, int]


def canon(i: int, j: int) -> Pair:
    """Canonical (sorted) form of an undirected pair."""
    if i == j:
        raise ValueError(f"self-pair ({i},{j}) is not an edge")
    return (i, j) if i < j else (j, i)


@dataclasses.dataclass(frozen=True)
class SimpleGraph:
    """Undirected simple graph over N nodes."""

    num_nodes: int
    pairs: tuple[Pair, ...]

    def __post_init__(self):
        seen = set()
        for p in self.pairs:
            c = canon(*p)
            if c != p:
                raise ValueError(f"pair {p} not canonical")
            if c in seen:
                raise ValueError(f"duplicate pair {p}")
            if not (0 <= p[0] < self.num_nodes and 0 <= p[1] < self.num_nodes):
                raise ValueError(f"pair {p} out of range")
            seen.add(c)

    @property
    def num_pairs(self) -> int:
        return len(self.pairs)

    def degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, dtype=np.int64)
        for i, j in self.pairs:
            deg[i] += 1
            deg[j] += 1
        return deg

    def neighbors(self, node: int) -> list[int]:
        """Neighbours of ``node`` in pair order."""
        out = []
        for i, j in self.pairs:
            if i == node:
                out.append(j)
            elif j == node:
                out.append(i)
        return out


def make_graph(num_nodes: int, pairs: Iterable[Pair]) -> SimpleGraph:
    cpairs = sorted({canon(*p) for p in pairs})
    return SimpleGraph(num_nodes=num_nodes, pairs=tuple(cpairs))


@dataclasses.dataclass(frozen=True)
class Multigraph:
    """Multigraph G_m: every overlay pair with an edge multiplicity n(i,j)
    from Algorithm 1 (one strong edge plus n-1 weak edges)."""

    num_nodes: int
    multiplicity: dict[Pair, int]

    @property
    def pairs(self) -> tuple[Pair, ...]:
        return tuple(sorted(self.multiplicity))


@dataclasses.dataclass(frozen=True)
class MultigraphState:
    """One parsed state G_m^s: each overlay pair labelled STRONG or WEAK."""

    num_nodes: int
    edge_type: dict[Pair, int]  # pair -> STRONG | WEAK
