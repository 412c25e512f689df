"""Consensus matrices for DPASGD (counterpart of `repro.core.consensus`).

Metropolis-Hastings weights over an undirected exchange graph:

    A[i,j] = 1 / (1 + max(deg_i, deg_j))       if (i,j) active
    A[i,i] = 1 - sum_j A[i,j]
    A[i,j] = 0                                  otherwise
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import SimpleGraph


def metropolis_weights(graph: SimpleGraph) -> np.ndarray:
    n = graph.num_nodes
    deg = graph.degrees()
    a = np.zeros((n, n))
    for i, j in graph.pairs:
        w = 1.0 / (1.0 + max(deg[i], deg[j]))
        a[i, j] = a[j, i] = w
    a[np.diag_indices(n)] = 1.0 - a.sum(axis=1)
    return a
