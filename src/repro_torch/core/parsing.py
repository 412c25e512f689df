"""Algorithm 2 — Multigraph Parsing (counterpart of `repro.core.parsing`).

Parses the multigraph into s_max = LCM({n(i,j)}) simple-graph states.
State 0 is the overlay (every pair strong). A pair with multiplicity n
is strong once every n states, tracked by the countdown list L-bar:

    if Lbar[i,j] == L[i,j]: edge is STRONG else WEAK
    then: if Lbar[i,j] == 1: Lbar[i,j] = L[i,j]  (reset)
          else:              Lbar[i,j] -= 1

Round k uses state (k mod s_max).
"""

from __future__ import annotations

import math

from repro_torch.core.graph import STRONG, WEAK, Multigraph, MultigraphState, Pair


def capped_multiplicities(mult: dict[Pair, int],
                          cap_states: int | None) -> dict[Pair, int]:
    """Clamp multiplicities so their LCM stays within ``cap_states``.

    The largest clamp ``m_max`` with ``lcm(min(n, m_max)) <= cap_states``
    is applied uniformly, which keeps the materialized schedule one
    whole period (cycling it is exact).
    """
    if cap_states is None:
        return dict(mult)
    if cap_states < 1:
        raise ValueError(f"cap_states must be >= 1, got {cap_states}")
    m_max = max(mult.values(), default=1)

    def lcm_clamped(clamp: int) -> int:
        s = 1
        for n in mult.values():
            s = math.lcm(s, min(n, clamp))
        return s

    while m_max > 1 and lcm_clamped(m_max) > cap_states:
        m_max -= 1
    return {p: min(n, m_max) for p, n in mult.items()}


def parse_multigraph(mg: Multigraph, cap_states: int | None = None) -> list[MultigraphState]:
    """Algorithm 2: unroll the multigraph into its cyclic list of states."""
    L = capped_multiplicities(mg.multiplicity, cap_states)
    s_max = 1
    for n in L.values():
        s_max = math.lcm(s_max, n)
    Lbar: dict[Pair, int] = dict(L)
    states: list[MultigraphState] = []
    for _ in range(s_max):
        edge_type: dict[Pair, int] = {}
        for p in mg.pairs:
            edge_type[p] = STRONG if Lbar[p] == L[p] else WEAK
            if Lbar[p] == 1:
                Lbar[p] = L[p]
            else:
                Lbar[p] -= 1
        states.append(MultigraphState(num_nodes=mg.num_nodes, edge_type=edge_type))
    return states
