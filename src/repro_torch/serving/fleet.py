"""Regional serving fleet over a federated checkpoint (counterpart of
`repro.serving.fleet`, DESIGN.md §18).

Closes the train->deploy->serve loop: an FL checkpoint (per-silo flat
rows + metadata, checkpoint/ckpt.py; the reference's
`launch/train.py --ckpt-dir` writes them, and the port reads them byte
for byte) deploys as one `ServingEngine` replica per geographic REGION,
where regions are derived from the training network's silo sites
(networks/zoo.py): every silo maps to its nearest continental anchor by
great-circle distance, and a region's model variant is built from ITS
OWN silos' rows.

Why regional variants instead of one global average: DPASGD converges
per-silo models that stay slightly specialized to their silo's data
distribution; serving each geography from the mean of its local silo
rows keeps that specialization exactly where the traffic that shaped
it originates, and it is also the deployment unit a real cross-silo
operator has (the silos in a jurisdiction can pool rows, the global
set often cannot).

Checkpoint kinds (meta["params_kind"]):

* "full"        — rows are complete flat parameter vectors; the region
                  variant is `unravel(spec, mean(region rows))`, the
                  mean taken in numpy as the reference takes it, so the
                  variants are bit-equal to the reference's.
* "lora_delta"  — rows are LoRA delta vectors over a frozen base; the
                  variant is `apply_delta(base, unravel(spec, mean(region
                  rows)))`. The port's trainer draws the base from a
                  CPU `torch.Generator` seeded ``seed + 1``
                  (`fl/lora.lora_base`) and records that as
                  ``base_init="torch-cpu"``; a checkpoint without that
                  key (the reference's, whose base comes from
                  `jax.random.PRNGKey(seed + 1)`, a stream torch cannot
                  reproduce) raises ValueError.

`RegionalFleet.route(lat, lon)` sends a client to its nearest region
anchor; serving/traffic.py drives the fleet under open-loop load. On the
card every region's engine captures its decode step once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint import FLCheckpoint, load_fl_checkpoint
from repro_torch.configs import get_config, reduce as reduce_cfg
from repro_torch.device import resolve_device
from repro_torch.fl import flat as flatmod
from repro_torch.fl import lora
from repro_torch.models import transformer as tf
from repro_torch.networks.registry import get_network
from repro_torch.networks.zoo import NetworkSpec, haversine_km
from repro_torch.serving.engine import ServingEngine

#: Continental anchor points (lat, lon) — the candidate serving sites.
#: A region exists in a fleet only if at least one training silo maps
#: to it, so a fleet over all 11 gaia silos gets na/sa/eu/me/asia/oceania
#: (Mumbai's nearest anchor is me) but no africa.
REGION_ANCHORS: dict[str, tuple[float, float]] = {
    "na": (39.0, -98.0),        # North America
    "sa": (-15.6, -56.1),       # South America
    "eu": (50.1, 8.7),          # Europe
    "africa": (-1.3, 26.0),
    "me": (25.0, 45.0),         # Middle East
    "asia": (30.0, 105.0),
    "oceania": (-25.0, 134.0),
}


def nearest_region(lat: float, lon: float,
                   anchors: dict[str, tuple[float, float]] | None = None
                   ) -> str:
    anchors = anchors or REGION_ANCHORS
    return min(anchors,
               key=lambda r: haversine_km(lat, lon, *anchors[r]))


def assign_regions(net: NetworkSpec, num_silos: int | None = None
                   ) -> dict[str, list[int]]:
    """Silo index lists per region (nearest-anchor), empty regions
    dropped; ``num_silos`` truncates to the training subset (the
    trainer keeps the FIRST n silos of the zoo network)."""
    n = net.num_silos if num_silos is None else min(num_silos,
                                                    net.num_silos)
    out: dict[str, list[int]] = {}
    for i in range(n):
        s = net.silos[i]
        out.setdefault(nearest_region(s.lat, s.lon), []).append(i)
    return {r: out[r] for r in REGION_ANCHORS if r in out}


@dataclasses.dataclass
class Region:
    """One deployed replica: an engine serving this region's variant."""

    name: str
    lat: float
    lon: float
    silo_indices: list[int]
    engine: ServingEngine

    @property
    def num_silos(self) -> int:
        return len(self.silo_indices)


class RegionalFleet:
    """Per-region `ServingEngine` replicas built from one checkpoint."""

    def __init__(self, regions: dict[str, Region], *, ckpt: FLCheckpoint,
                 staleness_lag_ms: float = 0.0):
        if not regions:
            raise ValueError("fleet has no regions")
        self.regions = regions
        self.ckpt = ckpt
        self.meta = ckpt.meta
        # how far behind the end of training the served rows are, on
        # the training simulator's clock (0 when serving the last step)
        self.staleness_lag_ms = float(staleness_lag_ms)

    # -- construction --------------------------------------------------
    @classmethod
    def from_checkpoint(cls, src, step: int | None = None, *,
                        max_slots: int = 4, max_seq: int = 128,
                        device=None) -> "RegionalFleet":
        """Build a fleet from a checkpoint dir / `CheckpointManager` /
        `FLCheckpoint`, its engines on ``device`` (the card unless the
        caller names another). Serving the non-latest ``step`` records
        the extra staleness (latest step's sim clock minus this
        step's)."""
        device = resolve_device(device)
        lag = 0.0
        if isinstance(src, FLCheckpoint):
            ckpt = src
        else:
            ckpt = load_fl_checkpoint(src, step)
            if step is not None:
                tip = load_fl_checkpoint(src)
                lag = max(0.0, float(tip.meta.get("sim_time_ms", 0.0)) -
                          float(ckpt.meta.get("sim_time_ms", 0.0)))
        meta = ckpt.meta
        if "arch" not in meta:
            raise ValueError(
                "checkpoint has no 'arch' metadata — the serving fleet "
                "deploys LM checkpoints from launch/train.py; "
                "fl/trainer.py classifier checkpoints are not servable")
        mcfg = reduce_cfg(get_config(meta["arch"]))
        net = get_network(meta["network"])
        groups = assign_regions(net, int(meta["num_silos"]))
        variants = _region_variants(ckpt, mcfg, groups, device)
        regions = {}
        for rname, idxs in groups.items():
            lat, lon = REGION_ANCHORS[rname]
            regions[rname] = Region(
                name=rname, lat=lat, lon=lon, silo_indices=idxs,
                engine=ServingEngine(mcfg, variants[rname],
                                     max_slots=max_slots,
                                     max_seq=max_seq, device=device))
        return cls(regions, ckpt=ckpt, staleness_lag_ms=lag)

    # -- routing & ops --------------------------------------------------
    def route(self, lat: float, lon: float) -> str:
        """Nearest deployed region for a client coordinate."""
        anchors = {r: (v.lat, v.lon) for r, v in self.regions.items()}
        return nearest_region(lat, lon, anchors)

    def reset(self) -> None:
        """Reset every engine (between load points of a sweep)."""
        for r in self.regions.values():
            r.engine.reset()

    def staleness_ms(self, t_serve_ms: float) -> float:
        """Checkpoint age at serving time ``t_serve_ms`` on a unified
        simulated clock where serving starts the instant training ends:
        the lag to the newest rows plus the time already served."""
        return self.staleness_lag_ms + float(t_serve_ms)

    @property
    def region_names(self) -> list[str]:
        return list(self.regions)


def _region_variants(ckpt: FLCheckpoint, mcfg, groups, device) -> dict:
    """Region name -> full parameter tree served by that region."""
    meta = ckpt.meta
    kind = meta.get("params_kind", "full")
    if kind == "lora_delta":
        # the exact base launch/train.py froze: `lora_base`, same arch cfg
        if meta.get("base_init") != lora.BASE_INIT:
            raise ValueError(
                "lora_delta checkpoint without base_init="
                f"{lora.BASE_INIT!r}: its frozen base was drawn from "
                "jax.random.PRNGKey(seed + 1) (the reference's trainer), "
                "which torch cannot reproduce, so the port cannot rebuild "
                "the model it served")
        rank = int(meta["lora_rank"])
        base = lora.lora_base(mcfg, int(meta.get("seed", 0)), device)
        spec = flatmod.make_flat_spec(lora.delta_template(base, rank))
        build = lambda row: lora.apply_delta(base, flatmod.unravel(spec, row))
    elif kind == "full":
        # the leaves' names, shapes and types; the values are not used
        spec = flatmod.make_flat_spec(
            tf.init_params(mcfg, torch.Generator(), device="cpu"))
        build = lambda row: flatmod.unravel(spec, row)
    else:
        raise ValueError(f"unknown params_kind {kind!r}")
    if ckpt.w.shape[1] != spec.size:
        raise ValueError(
            f"checkpoint rows have {ckpt.w.shape[1]} params but "
            f"{meta.get('arch')}/{kind} expects {spec.size}")
    return {r: build(torch.from_numpy(np.asarray(
                np.mean(ckpt.w[idxs], axis=0), np.float32)).to(device))
            for r, idxs in groups.items()}
