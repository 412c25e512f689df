"""Degradation policy and silo-removal helpers (counterpart of
`repro.faults.degrade`).

The policy knobs control how `engine.FaultedSession` converts observed
conditions into effective strong masks and wall-clock charges; the
mask helpers translate per-round PAIR masks into the directed, CSR-
sorted layout `fl/runtime.py` trains with, so a degraded round is
nothing but different arguments to the cycle function built once
(`edge_aggregate` handles empty aggregation rows by construction).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.delay import Workload, graph_pair_delays
from repro_torch.design.catalog import ring_topology
from repro_torch.networks.zoo import NetworkSpec


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """How a fleet reacts to degraded pairs.

    ``timeout_ms`` — a planned-strong pair whose observed delay exceeds
    this is demoted to weak for the round (``inf`` disables demotion);
    ``max_stale`` — an alive pair demoted this many consecutive rounds
    is forced strong again (bounded staleness, the Eq. 4 weak->strong
    branch); ``adaptive`` — if False the clock waits out the timeout on
    EVERY demoted round (a fleet that rediscovers the fault each
    round); if True the timeout is paid once per demotion streak and
    subsequent rounds route around the pair proactively. The effective
    masks — hence the trained params — are identical either way.
    """

    timeout_ms: float = math.inf
    max_stale: int = 8
    adaptive: bool = False


def removed_network(net: NetworkSpec, wl: Workload, *,
                    k: int = 0, strategy: str = "random",
                    seed: int = 0) -> tuple[NetworkSpec, np.ndarray]:
    """Drop ``k`` silos from a network; returns (reduced spec, kept
    indices). ``strategy`` picks them: ``"random"`` (seeded) or
    ``"inefficient"`` (the longest total delay to their ring neighbours
    under ``wl``). The reference's explicit ``drop=`` set has no caller
    in either package and is not ported."""
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


def crashed_pair_mask(pair_i: np.ndarray, pair_j: np.ndarray,
                      down: np.ndarray) -> np.ndarray:
    """Pairs with a down endpoint. ``down`` is (N,) or (R, N) bool;
    result is (E,) or (R, E)."""
    down = np.asarray(down, bool)
    return down[..., pair_i] | down[..., pair_j]


def pair_rounds_to_directed(order: np.ndarray,
                            pair_mask: np.ndarray) -> np.ndarray:
    """Expand a per-PAIR mask to the flat runtime's dst-sorted directed
    layout.

    ``pair_mask`` is (R, E) over overlay pairs in RoundPlan order (pair
    e owns directed edges 2e, 2e+1); ``order`` is the runtime's CSR
    sort permutation (`FlatRuntime.order`). Returns (R, 2E) bool ready
    to pass as the cycle function's ``strong`` argument.
    """
    pair_mask = np.asarray(pair_mask, bool)
    return np.repeat(pair_mask, 2, axis=-1)[..., order]
