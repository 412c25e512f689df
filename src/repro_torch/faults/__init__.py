"""Silo removal (counterpart of the `removed_network` part of
`repro.faults`)."""

from repro_torch.faults.degrade import removed_network

__all__ = ["removed_network"]
