"""Refresh and aggregation (`kernels/gossip_combine/ops.refresh_aggregate`
-> `csrc/edge_aggregate.cu`): the least time the stretch's calls need on
this card (for each round, the larger of its bytes over the HBM rate and
its FLOPs over the fp32 rate, by `yardstick.fused_work`), over the
kernel's profiled time, in %."""


def read(td):
    t = sum(e - s for name, s, e in td.kernels if "edge_aggregate" in name)
    if t <= 0:
        return None
    return 100.0 * td.edge_bound_us / t
