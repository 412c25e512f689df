"""Silo network zoo: the paper's five networks (Gaia, Amazon, Geant,
Exodus, Ebone), counterpart of `repro.networks.zoo`.

Every network is a list of sites with (lat, lon), an access-link
capacity and a per-silo compute-time multiplier. Link latency between
two silos is great-circle distance at 2/3 c with a 1.5x path stretch
plus a per-hop constant. The site tables and the float operations are
the reference's, so both packages build bit-identical matrices.

Silo counts match the paper's Table 3: Gaia 11, Amazon 22, Geant 40,
Exodus 79, Ebone 87. `_make_wan` generates a WAN of any size over the
same metros (the registry's ``wan<K>`` family). The per-network
callables at the end (``gaia()``, ..., ``wan(n)``, ``NETWORKS``) are
deprecated shims over `repro_torch.networks.registry`.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np

# ---------------------------------------------------------------------------
# Site database (city, lat, lon). Coordinates are approximate city centers.
# ---------------------------------------------------------------------------

_GAIA_SITES = [
    # 11 cloud regions, after Hsieh et al., "Gaia: Geo-Distributed ML" [22].
    ("virginia", 38.95, -77.45),
    ("california", 37.35, -121.95),
    ("oregon", 45.84, -119.70),
    ("ireland", 53.35, -6.26),
    ("frankfurt", 50.11, 8.68),
    ("tokyo", 35.68, 139.69),
    ("seoul", 37.57, 126.98),
    ("singapore", 1.35, 103.82),
    ("sydney", -33.87, 151.21),
    ("mumbai", 19.08, 72.88),
    ("sao_paulo", -23.55, -46.63),
]

_AMAZON_SITES = [
    # 22 AWS data-center metros [63].
    ("n_virginia", 38.95, -77.45),
    ("ohio", 40.10, -83.20),
    ("n_california", 37.35, -121.95),
    ("oregon", 45.84, -119.70),
    ("montreal", 45.50, -73.57),
    ("sao_paulo", -23.55, -46.63),
    ("ireland", 53.35, -6.26),
    ("london", 51.51, -0.13),
    ("paris", 48.86, 2.35),
    ("frankfurt", 50.11, 8.68),
    ("milan", 45.46, 9.19),
    ("stockholm", 59.33, 18.06),
    ("bahrain", 26.07, 50.55),
    ("cape_town", -33.92, 18.42),
    ("mumbai", 19.08, 72.88),
    ("singapore", 1.35, 103.82),
    ("jakarta", -6.21, 106.85),
    ("hong_kong", 22.32, 114.17),
    ("tokyo", 35.68, 139.69),
    ("osaka", 34.69, 135.50),
    ("seoul", 37.57, 126.98),
    ("sydney", -33.87, 151.21),
]

_GEANT_SITES = [
    # 40 European NREN PoPs (Geant, Internet Topology Zoo) [35].
    ("amsterdam", 52.37, 4.90),
    ("athens", 37.98, 23.73),
    ("belgrade", 44.79, 20.45),
    ("bratislava", 48.15, 17.11),
    ("brussels", 50.85, 4.35),
    ("bucharest", 44.43, 26.10),
    ("budapest", 47.50, 19.04),
    ("copenhagen", 55.68, 12.57),
    ("dublin", 53.35, -6.26),
    ("frankfurt", 50.11, 8.68),
    ("geneva", 46.20, 6.14),
    ("helsinki", 60.17, 24.94),
    ("istanbul", 41.01, 28.98),
    ("kaunas", 54.90, 23.89),
    ("kiev", 50.45, 30.52),
    ("lisbon", 38.72, -9.14),
    ("ljubljana", 46.06, 14.51),
    ("london", 51.51, -0.13),
    ("luxembourg", 49.61, 6.13),
    ("madrid", 40.42, -3.70),
    ("malta", 35.90, 14.51),
    ("milan", 45.46, 9.19),
    ("minsk", 53.90, 27.57),
    ("moscow", 55.76, 37.62),
    ("nicosia", 35.19, 33.38),
    ("oslo", 59.91, 10.75),
    ("paris", 48.86, 2.35),
    ("prague", 50.08, 14.44),
    ("riga", 56.95, 24.11),
    ("rome", 41.90, 12.50),
    ("sofia", 42.70, 23.32),
    ("stockholm", 59.33, 18.06),
    ("tallinn", 59.44, 24.75),
    ("tel_aviv", 32.09, 34.78),
    ("tirana", 41.33, 19.82),
    ("vienna", 48.21, 16.37),
    ("vilnius", 54.69, 25.28),
    ("warsaw", 52.23, 21.01),
    ("zagreb", 45.81, 15.98),
    ("zurich", 47.37, 8.55),
]

# Exodus (Rocketfuel AS3967): US-centric ISP, 79 PoPs. We lay PoPs over
# US/EU metro areas; multiple PoPs per metro are offset slightly, which is
# faithful to how Rocketfuel city PoPs cluster.
_EXODUS_METROS = [
    ("atlanta", 33.75, -84.39), ("austin", 30.27, -97.74),
    ("boston", 42.36, -71.06), ("chicago", 41.88, -87.63),
    ("dallas", 32.78, -96.80), ("denver", 39.74, -104.99),
    ("el_segundo", 33.92, -118.42), ("herndon", 38.97, -77.39),
    ("houston", 29.76, -95.37), ("irvine", 33.68, -117.83),
    ("jersey_city", 40.73, -74.08), ("los_angeles", 34.05, -118.24),
    ("miami", 25.76, -80.19), ("new_york", 40.71, -74.01),
    ("oak_brook", 41.83, -87.93), ("palo_alto", 37.44, -122.14),
    ("philadelphia", 39.95, -75.17), ("phoenix", 33.45, -112.07),
    ("san_jose", 37.34, -121.89), ("santa_clara", 37.35, -121.95),
    ("seattle", 47.61, -122.33), ("tukwila", 47.47, -122.26),
    ("waltham", 42.38, -71.24), ("washington", 38.91, -77.04),
    ("toronto", 43.65, -79.38), ("london", 51.51, -0.13),
    ("amsterdam", 52.37, 4.90), ("frankfurt", 50.11, 8.68),
    ("tokyo", 35.68, 139.69),
]

# Ebone (Rocketfuel AS1755): pan-European ISP, 87 PoPs.
_EBONE_METROS = [
    ("amsterdam", 52.37, 4.90), ("barcelona", 41.39, 2.17),
    ("berlin", 52.52, 13.40), ("brussels", 50.85, 4.35),
    ("budapest", 47.50, 19.04), ("copenhagen", 55.68, 12.57),
    ("dublin", 53.35, -6.26), ("dusseldorf", 51.23, 6.77),
    ("frankfurt", 50.11, 8.68), ("geneva", 46.20, 6.14),
    ("hamburg", 53.55, 9.99), ("helsinki", 60.17, 24.94),
    ("lisbon", 38.72, -9.14), ("london", 51.51, -0.13),
    ("lyon", 45.76, 4.84), ("madrid", 40.42, -3.70),
    ("marseille", 43.30, 5.37), ("milan", 45.46, 9.19),
    ("munich", 48.14, 11.58), ("oslo", 59.91, 10.75),
    ("paris", 48.86, 2.35), ("prague", 50.08, 14.44),
    ("rome", 41.90, 12.50), ("rotterdam", 51.92, 4.48),
    ("stockholm", 59.33, 18.06), ("strasbourg", 48.58, 7.75),
    ("vienna", 48.21, 16.37), ("warsaw", 52.23, 21.01),
    ("zurich", 47.37, 8.55), ("new_york", 40.71, -74.01),
    ("washington", 38.91, -77.04),
]



@dataclasses.dataclass(frozen=True)
class Silo:
    """One data silo: a site with access-link capacities and compute speed."""

    name: str
    lat: float
    lon: float
    upload_gbps: float
    download_gbps: float
    # Relative compute-speed multiplier; T_c(i) = base_compute_ms * this.
    compute_scale: float


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """A cross-silo network: silos + pairwise one-way link latency (ms)."""

    name: str
    silos: tuple[Silo, ...]
    latency_ms: np.ndarray  # (N, N), symmetric, zero diagonal

    @property
    def num_silos(self) -> int:
        return len(self.silos)

    def upload_gbps(self) -> np.ndarray:
        return np.array([s.upload_gbps for s in self.silos])

    def download_gbps(self) -> np.ndarray:
        return np.array([s.download_gbps for s in self.silos])

    def compute_scale(self) -> np.ndarray:
        return np.array([s.compute_scale for s in self.silos])

    def subset(self, keep, name: str) -> "NetworkSpec":
        """The induced sub-network ``name`` on silo indices ``keep`` (in
        order)."""
        keep = np.asarray(keep, np.int64)
        return NetworkSpec(
            name=name,
            silos=tuple(self.silos[int(i)] for i in keep),
            latency_ms=self.latency_ms[np.ix_(keep, keep)])


_EARTH_RADIUS_KM = 6371.0
# Propagation speed in fiber ~ 2/3 c -> 200 km/ms; real WAN paths are not
# great circles, so apply the standard ~1.5x path-stretch factor.
_KM_PER_MS = 200.0
_PATH_STRETCH = 1.5
_PER_HOP_MS = 0.5  # equipment / serialization constant


def haversine_km(lat1, lon1, lat2, lon2) -> float:
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * _EARTH_RADIUS_KM * math.asin(math.sqrt(a))


def link_latency_ms(lat1, lon1, lat2, lon2) -> float:
    """One-way WAN latency between two coordinates."""
    km = haversine_km(lat1, lon1, lat2, lon2)
    return km * _PATH_STRETCH / _KM_PER_MS + _PER_HOP_MS


def _latency_matrix(sites: list[tuple[str, float, float]]) -> np.ndarray:
    n = len(sites)
    lat = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            lat[i, j] = lat[j, i] = link_latency_ms(
                sites[i][1], sites[i][2], sites[j][1], sites[j][2])
    return lat


def _expand_metros(metros, count: int, seed: int) -> list[tuple[str, float, float]]:
    """Place `count` PoPs over a metro list, clustering extras around metros."""
    rng = np.random.default_rng(seed)
    sites: list[tuple[str, float, float]] = []
    k = 0
    while len(sites) < count:
        name, la, lo = metros[k % len(metros)]
        rep = k // len(metros)
        if rep == 0:
            sites.append((name, la, lo))
        else:
            # Additional PoP in the same metro: jitter within ~40 km.
            dla = float(rng.uniform(-0.3, 0.3))
            dlo = float(rng.uniform(-0.3, 0.3))
            sites.append((f"{name}_{rep}", la + dla, lo + dlo))
        k += 1
    return sites


def _build(name: str, sites, *, capacity_gbps: float, hetero_seed: int,
           capacity_jitter: float, compute_jitter: float) -> NetworkSpec:
    rng = np.random.default_rng(hetero_seed)
    n = len(sites)
    # Mild heterogeneity in access links and compute speed, log-uniform
    # around 1 (real silos are not identical).
    cap_up = capacity_gbps * np.exp(rng.uniform(-capacity_jitter, capacity_jitter, n))
    cap_dn = capacity_gbps * np.exp(rng.uniform(-capacity_jitter, capacity_jitter, n))
    comp = np.exp(rng.uniform(-compute_jitter, compute_jitter, n))
    silos = tuple(
        Silo(name=s[0], lat=s[1], lon=s[2],
             upload_gbps=float(cap_up[i]), download_gbps=float(cap_dn[i]),
             compute_scale=float(comp[i]))
        for i, s in enumerate(sites)
    )
    return NetworkSpec(name=name, silos=silos, latency_ms=_latency_matrix(list(sites)))


def _make_gaia(capacity_gbps: float = 10.0) -> NetworkSpec:
    return _build("gaia", _GAIA_SITES, capacity_gbps=capacity_gbps,
                  hetero_seed=11, capacity_jitter=0.25, compute_jitter=0.20)


def _make_amazon(capacity_gbps: float = 10.0) -> NetworkSpec:
    return _build("amazon", _AMAZON_SITES, capacity_gbps=capacity_gbps,
                  hetero_seed=22, capacity_jitter=0.25, compute_jitter=0.20)


def _make_geant(capacity_gbps: float = 10.0) -> NetworkSpec:
    return _build("geant", _GEANT_SITES, capacity_gbps=capacity_gbps,
                  hetero_seed=40, capacity_jitter=0.25, compute_jitter=0.20)


def _make_exodus(capacity_gbps: float = 10.0) -> NetworkSpec:
    sites = _expand_metros(_EXODUS_METROS, 79, seed=79)
    return _build("exodus", sites, capacity_gbps=capacity_gbps,
                  hetero_seed=79, capacity_jitter=0.25, compute_jitter=0.20)


def _make_ebone(capacity_gbps: float = 10.0) -> NetworkSpec:
    sites = _expand_metros(_EBONE_METROS, 87, seed=87)
    return _build("ebone", sites, capacity_gbps=capacity_gbps,
                  hetero_seed=87, capacity_jitter=0.25, compute_jitter=0.20)


def _make_wan(num_silos: int = 64, capacity_gbps: float = 10.0) -> NetworkSpec:
    """Generated planetary WAN with ``num_silos`` sites: not a paper
    network, but the same latency model over the union of the metro
    anchors above, for runs that want more silos than the paper's
    networks have. Deterministic in ``num_silos``."""
    metros = list(dict.fromkeys(_EXODUS_METROS + _EBONE_METROS
                                + [(n, la, lo) for n, la, lo in _AMAZON_SITES]))
    sites = _expand_metros(metros, num_silos, seed=1000 + num_silos)
    return _build(f"wan{num_silos}", sites, capacity_gbps=capacity_gbps,
                  hetero_seed=1000 + num_silos, capacity_jitter=0.25,
                  compute_jitter=0.20)


# ---------------------------------------------------------------------------
# Registry delegation (`repro_torch.networks.registry` owns the lookup
# path). The per-network callables below are deprecated shims kept for
# code written against the reference's zoo; new code should use
# `registry.get_network(name, **overrides)` / `registry.list_networks()`.
# ---------------------------------------------------------------------------


def get_network(name: str, capacity_gbps: float = 10.0) -> NetworkSpec:
    """Resolve a network name via the registry (identical to
    `registry.get_network`). The registry imports this module, so the
    import stays inside the call."""
    from repro_torch.networks import registry
    return registry.get_network(name, capacity_gbps=capacity_gbps)


def _deprecated_shim(name: str):
    def build(capacity_gbps: float = 10.0) -> NetworkSpec:
        warnings.warn(
            f"repro_torch.networks.zoo.{name}() is deprecated; use "
            f"repro_torch.networks.registry.get_network({name!r})",
            DeprecationWarning, stacklevel=2)
        return get_network(name, capacity_gbps=capacity_gbps)
    build.__name__ = name
    build.__qualname__ = name
    build.__doc__ = (f"Deprecated: use registry.get_network({name!r}, "
                     "**overrides).")
    return build


gaia = _deprecated_shim("gaia")
amazon = _deprecated_shim("amazon")
geant = _deprecated_shim("geant")
exodus = _deprecated_shim("exodus")
ebone = _deprecated_shim("ebone")


def wan(num_silos: int = 64, capacity_gbps: float = 10.0) -> NetworkSpec:
    """Deprecated: use registry.get_network(f"wan{K}", **overrides)."""
    warnings.warn("repro_torch.networks.zoo.wan(n) is deprecated; use "
                  "repro_torch.networks.registry.get_network(f'wan{n}')",
                  DeprecationWarning, stacklevel=2)
    return get_network(f"wan{num_silos}", capacity_gbps=capacity_gbps)


#: Deprecated name->builder map (iteration order preserved); prefer
#: `registry.list_networks()`.
NETWORKS = {
    "gaia": gaia,
    "amazon": amazon,
    "geant": geant,
    "exodus": exodus,
    "ebone": ebone,
}
