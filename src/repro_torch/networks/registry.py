"""Network registry: one lookup path for every silo network, the
counterpart of `repro.networks.registry` for the five paper networks.

    get_network("gaia")                      # fixed entry
    get_network("gaia", capacity_gbps=25.0)  # builder override
    list_networks()                          # concrete names
"""

from __future__ import annotations

from typing import Callable

from repro_torch.networks import zoo

_FIXED: dict[str, Callable[..., zoo.NetworkSpec]] = {
    name: getattr(zoo, f"_make_{name}")
    for name in ("gaia", "amazon", "geant", "exodus", "ebone")}


def list_networks() -> list[str]:
    """Sorted names of the registered networks."""
    return sorted(_FIXED)


def get_network(name: str, **overrides) -> zoo.NetworkSpec:
    """Resolve ``name`` to a built `NetworkSpec`; builder keyword
    overrides (``capacity_gbps=...``) pass through unchanged."""
    builder = _FIXED.get(name)
    if builder is None:
        raise KeyError(f"unknown network {name!r}; registered: "
                       f"{', '.join(list_networks())}")
    return builder(**overrides)
