"""Baseline topology designs: a thin re-export shim (counterpart of
`repro.core.topology`).

Construction lives in `repro_torch.design.catalog`, where each design
family owns both its construction and its timing semantics. Every name
the reference's shim re-exports is re-exported here, so imports such as
`from repro_torch.core.topology import ring_topology` keep working.
"""

from __future__ import annotations

from repro_torch.design.catalog import (  # noqa: F401
    DESIGN_FAMILIES,
    MatchaTopology,
    StaticTopology,
    TOPOLOGIES,
    TopologyDesign,
    build_topology,
    christofides_cycle,
    connectivity_graph,
    dmbst_topology,
    get_family,
    matcha_plus_topology,
    matcha_topology,
    mst_topology,
    nominal_delay_matrix,
    physical_graph,
    ring_topology,
    star_topology,
    _counter_uniform,
    _matching_decomposition,
    _round_robin_matchings,
)
