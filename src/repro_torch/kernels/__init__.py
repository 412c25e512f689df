"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: `gossip_combine.refresh_aggregate` (the FL round's refresh and
aggregation, and `edge_aggregate`, its plain CSR sum),
`gossip_combine.gossip_combine` (the ring gossip round's combine),
`flash_attention.flash_attention` (prefill),
`decode_attention.decode_attention` (one-token decode) and
`ssd_scan.ssd_scan` (the Mamba-2 prefill scan)."""

#: Every CUDA kernel of the package, by its source name in csrc/.
KERNELS = ("edge_aggregate", "gossip_combine", "flash_attention",
           "decode_attention", "ssd_scan")
