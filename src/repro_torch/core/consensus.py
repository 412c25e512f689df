"""Consensus matrices for DPASGD (counterpart of `repro.core.consensus`).

Metropolis-Hastings weights over an undirected exchange graph:

    A[i,j] = 1 / (1 + max(deg_i, deg_j))       if (i,j) active
    A[i,i] = 1 - sum_j A[i,j]
    A[i,j] = 0                                  otherwise
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import MultigraphState, SimpleGraph


def metropolis_weights(graph: SimpleGraph) -> np.ndarray:
    n = graph.num_nodes
    deg = graph.degrees()
    a = np.zeros((n, n))
    for i, j in graph.pairs:
        w = 1.0 / (1.0 + max(deg[i], deg[j]))
        a[i, j] = a[j, i] = w
    a[np.diag_indices(n)] = 1.0 - a.sum(axis=1)
    return a


def state_consensus(state: MultigraphState) -> np.ndarray:
    """Consensus matrix of a multigraph state: MH over its strong graph.

    Isolated nodes get an identity row (they skip aggregation).
    """
    return metropolis_weights(state.strong_graph())


def uniform_star_weights(num_nodes: int, hub: int) -> np.ndarray:
    """FedAvg-style star aggregation: everyone averages through the hub."""
    a = np.full((num_nodes, num_nodes), 1.0 / num_nodes)
    del hub  # the hub only matters for timing, not for the average
    return a
