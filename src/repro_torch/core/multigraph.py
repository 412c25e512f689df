"""Algorithm 1 — Multigraph Construction (counterpart of
`repro.core.multigraph`).

For each overlay pair, the number of parallel edges is
    n(i,j) = max(1, min(t, round(d(i,j) / d_min)))
where d_min is the smallest overlay pair delay. One edge per pair is
strong; the other n-1 are weak, so slow pairs block less often.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.delay import Workload
from repro_torch.core.graph import Multigraph, Pair, SimpleGraph
from repro_torch.core.timing import pair_delay_vector
from repro_torch.networks.zoo import NetworkSpec


def build_multigraph(net: NetworkSpec, wl: Workload, overlay: SimpleGraph,
                     t: int = 5) -> Multigraph:
    """Algorithm 1. ``t`` is the paper's max-edges-per-pair knob."""
    if t < 1:
        raise ValueError(f"t must be >= 1, got {t}")
    if not overlay.pairs:
        raise ValueError("overlay has no edges")
    pair_i = np.fromiter((p[0] for p in overlay.pairs), np.int64)
    pair_j = np.fromiter((p[1] for p in overlay.pairs), np.int64)
    d = pair_delay_vector(net, wl, pair_i, pair_j, overlay.degrees())
    d_min = d.min()
    mult: dict[Pair, int] = {}
    for p, dp in zip(overlay.pairs, d):
        n = int(min(t, int(np.round(dp / d_min))))
        mult[p] = max(1, n)
    return Multigraph(num_nodes=overlay.num_nodes, multiplicity=mult)
