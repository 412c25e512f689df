"""Network registry: one lookup path for every silo network, the
counterpart of `repro.networks.registry`.

    get_network("gaia")                      # fixed entry
    get_network("gaia", capacity_gbps=25.0)  # builder override
    get_network("wan64")                     # pattern entry -> wan(64)
    list_networks()                          # concrete names
    list_networks(include_patterns=True)     # + pattern templates

The five paper networks are fixed entries (``register``) and take only
keyword overrides; pattern entries (``register_pattern``) also receive the
``re.Match`` of the requested name, so a family such as ``wan<K>``
registers once.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable

from repro_torch.networks import zoo

_FIXED: dict[str, Callable[..., zoo.NetworkSpec]] = {
    name: getattr(zoo, f"_make_{name}")
    for name in ("gaia", "amazon", "geant", "exodus", "ebone")}
_PATTERNS: list["_Pattern"] = []


@dataclasses.dataclass(frozen=True)
class _Pattern:
    regex: re.Pattern
    template: str            # human-readable, e.g. "wan<K>"
    builder: Callable[..., zoo.NetworkSpec]


def register(name: str, builder: Callable[..., zoo.NetworkSpec],
             *, overwrite: bool = False) -> None:
    """Register a fixed network under ``name``."""
    if name in _FIXED and not overwrite:
        raise ValueError(f"network {name!r} already registered")
    _FIXED[name] = builder


def register_pattern(regex: str, template: str,
                     builder: Callable[..., zoo.NetworkSpec]) -> None:
    """Register a parameterized family. ``builder(match, **overrides)``
    receives the anchored ``re.Match`` for the requested name."""
    _PATTERNS.append(_Pattern(re.compile(regex), template, builder))


def list_networks(*, include_patterns: bool = False) -> list[str]:
    """Sorted concrete names; with ``include_patterns`` the pattern
    templates (e.g. ``wan<K>``) are appended."""
    names = sorted(_FIXED)
    if include_patterns:
        names += [p.template for p in _PATTERNS]
    return names


def get_network(name: str, **overrides) -> zoo.NetworkSpec:
    """Resolve ``name`` to a built `NetworkSpec`. Fixed entries win over
    patterns; builder keyword overrides (``capacity_gbps=...``) pass
    through unchanged."""
    builder = _FIXED.get(name)
    if builder is not None:
        return builder(**overrides)
    for pat in _PATTERNS:
        m = pat.regex.fullmatch(name)
        if m is not None:
            return pat.builder(m, **overrides)
    known = ", ".join(list_networks(include_patterns=True))
    raise KeyError(f"unknown network {name!r}; registered: {known}")


register_pattern(
    r"wan(\d+)", "wan<K>",
    lambda m, **kw: zoo._make_wan(num_silos=int(m.group(1)), **kw))
