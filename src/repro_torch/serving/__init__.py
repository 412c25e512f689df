"""Serving (counterpart of `repro.serving`): the slot engine, the
regional fleet over an FL checkpoint, and the open-loop traffic sweep."""

from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.fleet import (REGION_ANCHORS, Region, RegionalFleet,
                                       assign_regions, nearest_region)
from repro_torch.serving.traffic import (LoadResult, RequestRecord,
                                         TrafficConfig, generate_requests,
                                         simulate, sweep_loads)

__all__ = ["Request", "ServingEngine", "RegionalFleet", "Region",
           "REGION_ANCHORS", "assign_regions", "nearest_region",
           "TrafficConfig", "RequestRecord", "LoadResult",
           "generate_requests", "simulate", "sweep_loads"]
