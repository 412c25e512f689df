"""CSR edge aggregation: CUDA kernel, plain version and CSR plan."""

from repro_torch.kernels.gossip_combine.ops import csr_sort, edge_aggregate
from repro_torch.kernels.gossip_combine.ref import edge_aggregate_ref

__all__ = ["csr_sort", "edge_aggregate", "edge_aggregate_ref"]
