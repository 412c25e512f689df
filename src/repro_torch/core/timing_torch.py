"""Device grid engine for Eq. 4/5 (counterpart of `repro.core.timing_jax`,
DESIGN.md §15).

The numpy `timing.TimingGrid` steps all recurrence cells together, but
with one host round step per live round and a per-cell orbit check in
Python. That suits the 105 paper cells, whose orbits lock early; it
binds a population search, whose random candidates have long
transients. This module runs the whole horizon on the stacked
``(C, S_max, E_max)`` cell axis in torch float64, on the card unless the
caller names another device:

* a Python loop over rounds, each round a handful of tensor ops;
* each cell's phase ``k % S_c`` gathers its own rows of ``strong``,
  ``trans`` and ``lone_comp``, so cells with different state counts
  batch without grouping on the host;
* the four Eq. 4 branches are selected by transition code
  (``T_WW=0``, ``T_WS=1``, ``T_SW=2``, ``T_SS=3``) with nested
  `torch.where`, the order of the numpy grid's `np.where` tree;
* round 0 applies no transition (a host-side branch, no device op).

Every op is an IEEE float64 add, subtract, max or select, with no
multiply (so no FMA can form), and max is exact in any order. So the
result is bit for bit the numpy `timing._grid_recurrence_taus`, with no
tolerance. Orbit detection stays on the host engine: this one steps the
full horizon, which gives the same bits because a locked cell's further
stepping is its tiled replay.

The reference's ``bucket=`` option is left out. It pads C and S_max to
powers of two so that `jax.jit` reuses one compiled program across
shapes; eager PyTorch compiles no program, so there is nothing to reuse.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.timing import T_SS, T_SW, T_WW
from repro_torch.device import resolve_device

__all__ = ["grid_recurrence_taus"]


def _on(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)


def grid_recurrence_taus(d0, pair_comp, strong, trans, lone_comp,
                         num_states, num_rounds: int, *,
                         device=None) -> np.ndarray:
    """``(C, num_rounds)`` float64 taus of the numpy grid's stacked arrays:
    ``strong``/``trans`` ``(C, S_max, E_max)``, ``lone_comp``
    ``(C, S_max)``, ``num_states`` ``(C,)``, with ``d0``/``pair_comp``
    per cell ``(C, E_max)`` or shared ``(E_max,)``. Inputs may be numpy
    arrays or tensors (a scorer keeps its shared ``(E,)`` rows on the
    device). The result is copied to the host once, at the end.
    """
    if np.ndim(strong) != 3:
        raise ValueError(
            f"strong must be (C, S, E), got {tuple(np.shape(strong))}")
    dev = resolve_device(device)
    f64 = torch.float64
    strong = _on(strong, torch.bool, dev)
    trans = _on(trans, torch.int8, dev)
    lone_comp = _on(lone_comp, f64, dev)
    num_states = _on(num_states, torch.int64, dev)
    pair_comp = _on(pair_comp, f64, dev)
    num_cells, _, e_max = strong.shape
    rows = torch.arange(num_cells, device=dev)
    d_cur = _on(d0, f64, dev).expand(num_cells, e_max)
    d_prev = d_cur
    prev_tau = None
    neg_inf = torch.tensor(-torch.inf, dtype=f64, device=dev)
    taus = []
    for k in range(int(num_rounds)):
        s = torch.remainder(k, num_states)       # (C,) per-cell phase
        st = strong[rows, s]
        if k:
            code = trans[rows, s]
            pt = prev_tau[:, None]
            ws = torch.maximum(pair_comp, d_cur - d_prev)
            d_next = torch.where(
                code == T_SS, d_cur, torch.where(
                    code == T_WW, pt + d_cur, torch.where(
                        code == T_SW, pt.expand_as(d_cur), ws)))
            d_prev, d_cur = d_cur, d_next
        if e_max:
            tau = torch.amax(torch.where(st, d_cur, neg_inf), dim=1)
        else:   # amax raises on an empty axis; the max of nothing is -inf
            tau = neg_inf.expand(num_cells)
        tau = torch.maximum(tau, lone_comp[rows, s])
        taus.append(tau)
        prev_tau = tau
    if not taus:
        return np.empty((num_cells, 0), np.float64)
    return torch.stack(taus, dim=1).cpu().numpy()
