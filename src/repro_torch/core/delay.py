"""Delay model, paper Eq. 3 (counterpart of `repro.core.delay`).

Eq. 3:  d(i,j) = u * T_c(i) + l(i,j) + M / O(i,j)
        O(i,j) = min( C_UP(i) / |N_i^out| , C_DN(j) / |N_j^in| )

At pair level the delay of an exchange between i and j is
max(d(i->j), d(j->i)): aggregation waits for both directions. The
Eq. 4/5 recurrence over rounds lives in `core/timing.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Pair, SimpleGraph
from repro_torch.networks.zoo import NetworkSpec


@dataclasses.dataclass(frozen=True)
class Workload:
    """Training workload parameters entering Eq. 3 (paper Table 2): model
    size M (Mbits), local updates u, and the per-silo compute time of one
    local update T_c (ms; scaled per silo by `NetworkSpec.compute_scale`).
    """

    name: str
    model_size_mbits: float
    local_updates: int
    base_compute_ms: float

    def compute_ms(self, net: NetworkSpec) -> np.ndarray:
        """u * T_c(i) for every silo."""
        return self.local_updates * self.base_compute_ms * net.compute_scale()


FEMNIST = Workload("femnist", model_size_mbits=4.62, local_updates=1, base_compute_ms=2.0)
SENTIMENT140 = Workload("sentiment140", model_size_mbits=18.38, local_updates=1, base_compute_ms=5.0)
INATURALIST = Workload("inaturalist", model_size_mbits=42.88, local_updates=1, base_compute_ms=15.0)

WORKLOADS = {w.name: w for w in (FEMNIST, SENTIMENT140, INATURALIST)}


def directed_delay_ms(net: NetworkSpec, wl: Workload, i: int, j: int,
                      out_deg_i: int, in_deg_j: int) -> float:
    """Eq. 3 for the directed transfer i -> j, given active degrees."""
    comp = wl.local_updates * wl.base_compute_ms * net.silos[i].compute_scale
    lat = float(net.latency_ms[i, j])
    # Access-link traffic capacity split over concurrent transfers (Gbps).
    cap = min(net.silos[i].upload_gbps / max(out_deg_i, 1),
              net.silos[j].download_gbps / max(in_deg_j, 1))
    transfer = wl.model_size_mbits / (cap * 1000.0) * 1000.0  # Mbits/Gbps -> ms
    return comp + lat + transfer


def pair_delay_ms(net: NetworkSpec, wl: Workload, i: int, j: int,
                  deg: np.ndarray) -> float:
    """Blocking exchange delay of pair (i,j) with per-node active degrees."""
    return max(
        directed_delay_ms(net, wl, i, j, int(deg[i]), int(deg[j])),
        directed_delay_ms(net, wl, j, i, int(deg[j]), int(deg[i])),
    )


def graph_pair_delays(net: NetworkSpec, wl: Workload,
                      graph: SimpleGraph) -> dict[Pair, float]:
    """Eq. 3 over all pairs of a static topology (degrees = graph degrees)."""
    deg = graph.degrees()
    return {p: pair_delay_ms(net, wl, p[0], p[1], deg) for p in graph.pairs}

