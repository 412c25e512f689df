"""The benchmark's plain reference: DPASGD over the paper's multigraph,
silo by silo, in plain PyTorch and numpy.

It imports nothing of the program. What `run_fl` derives from its
config (the synthetic data and its sampling stream, the initial
parameters, the overlay, its strong sets and coefficients, the simulated
clock) is worked out again here from frozen copies of the numpy code and
from the data files under `bench/`.
"""
