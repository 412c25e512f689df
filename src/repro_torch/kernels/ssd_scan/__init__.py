"""The Mamba-2 SSD chunked scan: CUDA kernel and plain version."""

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_ref"]
