"""Topology designs: the Table-1 catalog and the blossom matching its
Christofides overlay needs."""
