"""The gossip kernels: the fixed-K combine and the fused CSR
refresh-and-aggregate, each a CUDA kernel beside its plain version, and
the CSR plan."""

from repro_torch.kernels.gossip_combine.ops import (combine_pytree, csr_sort,
                                                    edge_aggregate,
                                                    gossip_combine,
                                                    refresh_aggregate)
from repro_torch.kernels.gossip_combine.ref import (Segment,
                                                    dense_edge_aggregate,
                                                    edge_aggregate_ref,
                                                    gossip_combine_ref,
                                                    refresh_aggregate_ref,
                                                    refresh_buffers)

__all__ = ["Segment", "combine_pytree", "csr_sort", "dense_edge_aggregate",
           "edge_aggregate", "edge_aggregate_ref", "gossip_combine",
           "gossip_combine_ref", "refresh_aggregate", "refresh_aggregate_ref",
           "refresh_buffers"]
