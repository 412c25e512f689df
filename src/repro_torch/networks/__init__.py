"""Silo networks: the paper's five and the generated `wan<K>` family,
behind one registry."""

from repro_torch.networks.registry import get_network, list_networks
from repro_torch.networks.zoo import NetworkSpec, Silo

__all__ = ["NetworkSpec", "Silo", "get_network", "list_networks"]
