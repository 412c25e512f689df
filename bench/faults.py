"""Faults planted under the timed path, for the checks that `correct`
catches them: each is a context manager that patches the program's
round for as long as it is open. The benchmark's own runs never open
one; `bench/controls.py` reads them at a cell's size on the card and
`bench/tests/test_bench_faults.py` drives a whole run through each on the
CPU.

* ``unchanged``: every round's local step returns the parameters and
  optimizer state it was given (the losses it computed, but no step
  taken), so the round leaves the state as it was;
* ``half_batch``: every silo trains on the first half of its batch, the
  mean taken over that half;
* ``no_exchange``: the refresh and aggregation are left out, every silo
  keeps its own parameters (the exchange between silos, which on one
  card stands for the exchange between chips);
* ``altered``: the answer is altered where it is produced, each round's
  loss reported one round late;
* ``refresh_all``: the strong mask is ignored, every edge's buffer is
  refreshed every round, so a weak edge carries its source's fresh
  parameters where it should carry the stale ones.
"""

from __future__ import annotations

import contextlib

NAMES = ("unchanged", "half_batch", "no_exchange", "altered",
         "refresh_all")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _wrap_cycle(runtime, wrap):
    real = runtime.make_cycle_fn

    def make_cycle_fn(*args, **kw):
        return wrap(real(*args, **kw))

    return _patched(runtime, "make_cycle_fn", make_cycle_fn)


def planted(name: str):
    """The context manager of fault ``name`` (one of `NAMES`)."""
    import torch

    from repro_torch.fl import runtime
    from repro_torch.kernels.gossip_combine import ops

    if name == "unchanged":
        real = runtime.local_sgd

        def local_sgd(silo_grads, opt, lr_scale, w, opt_state, *args, **kw):
            out = real(silo_grads, opt, lr_scale, w, opt_state, *args, **kw)
            return (w, opt_state) + tuple(out[2:])
        return _patched(runtime, "local_sgd", local_sgd)
    if name == "half_batch":
        def wrap(cycle):
            def run(state, batches, *args):
                half = {k: v[:, :, :, :v.shape[3] // 2]
                        for k, v in batches.items()}
                return cycle(state, half, *args)
            return run
        return _wrap_cycle(runtime, wrap)
    if name == "no_exchange":
        return _patched(ops, "refresh_aggregate",
                        lambda segments: [s.w for s in segments])
    if name == "refresh_all":
        real = ops.refresh_aggregate

        def refresh_aggregate(segments):
            return real([s if s.strong is None
                         else s._replace(strong=torch.ones_like(s.strong))
                         for s in segments])
        return _patched(ops, "refresh_aggregate", refresh_aggregate)
    if name == "altered":
        def wrap(cycle):
            def run(*args):
                out = cycle(*args)
                late = torch.cat([out[1][:1], out[1][:-1]])
                return (out[0], late) + tuple(out[2:])
            return run
        return _wrap_cycle(runtime, wrap)
    raise KeyError(f"unknown fault {name!r}; known: {NAMES}")
