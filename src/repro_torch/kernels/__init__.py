"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. The ones on the main path: `gossip_combine.edge_aggregate`."""

#: Every CUDA kernel of the package, by its source name in csrc/.
KERNELS = ("edge_aggregate",)
