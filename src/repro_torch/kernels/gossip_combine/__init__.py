"""The gossip kernels: the fixed-K combine and the CSR edge aggregation,
each a CUDA kernel beside its plain version, and the CSR plan."""

from repro_torch.kernels.gossip_combine.ops import (combine_pytree, csr_sort,
                                                    edge_aggregate,
                                                    gossip_combine)
from repro_torch.kernels.gossip_combine.ref import (dense_edge_aggregate,
                                                    edge_aggregate_ref,
                                                    gossip_combine_ref)

__all__ = ["combine_pytree", "csr_sort", "dense_edge_aggregate",
           "edge_aggregate", "edge_aggregate_ref", "gossip_combine",
           "gossip_combine_ref"]
