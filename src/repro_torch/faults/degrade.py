"""Silo removal (counterpart of `repro.faults.degrade.removed_network`),
the Table 4 ablation of `run_fl`'s ``remove_silos``."""

from __future__ import annotations

import numpy as np

from repro_torch.core.delay import Workload, graph_pair_delays
from repro_torch.design.catalog import ring_topology
from repro_torch.networks.zoo import NetworkSpec


def removed_network(net: NetworkSpec, wl: Workload, *,
                    k: int = 0, strategy: str = "random",
                    seed: int = 0) -> tuple[NetworkSpec, np.ndarray]:
    """Drop ``k`` silos from a network; returns (reduced spec, kept
    indices). ``strategy`` picks them: ``"random"`` (seeded) or
    ``"inefficient"`` (the longest total delay to their ring neighbours
    under ``wl``). The reference's explicit ``drop=`` set, which
    its fault engine uses, is not ported."""
    n = net.num_silos
    if strategy == "random":
        rng = np.random.default_rng(seed)
        drop = set(rng.choice(n, size=k, replace=False).tolist())
    elif strategy == "inefficient":
        overlay = ring_topology(net, wl).graph
        delays = graph_pair_delays(net, wl, overlay)
        score = np.zeros(n)
        for (i, j), d in delays.items():
            score[i] += d
            score[j] += d
        drop = set(np.argsort(-score)[:k].tolist())
    else:
        raise ValueError(strategy)
    keep = np.asarray([i for i in range(n) if i not in drop], np.int64)
    return net.subset(keep, name=f"{net.name}-minus{k}"), keep
