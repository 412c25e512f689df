"""Cycle loop (`fl/runtime.make_cycle_fn`): device kernel records in the
traced stretch (copies and fills left out) per FL round."""


def read(td):
    if not td.rounds or not td.kernels:
        return None
    return len(td.kernels) / td.rounds
