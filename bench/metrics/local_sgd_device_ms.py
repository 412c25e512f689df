"""Local SGD (`vmap(grad_and_value)` -> cuDNN / cuBLAS, `optim.flat_sgd`):
device time per FL round of every kernel in the traced stretch but the
fused refresh-and-aggregate. The evaluations' forward passes, one every
`eval_every` rounds, are counted in it."""


def read(td):
    ks = [e - s for name, s, e in td.kernels if "edge_aggregate" not in name]
    if not td.rounds or not ks:
        return None
    return sum(ks) / 1e3 / td.rounds
