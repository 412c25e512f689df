"""Topology designs: the ring overlay the multigraph is built on."""
