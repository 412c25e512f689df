"""Topology designs: the Table-1 catalog and the blossom matching its
Christofides overlay needs."""

from repro_torch.design.catalog import (DESIGN_FAMILIES, DesignFamily,
                                        get_family)  # noqa: F401
