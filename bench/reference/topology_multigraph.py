"""The multigraph topology's round plan and simulated clock, worked out
again in numpy from the overlay: a frozen copy of the float operations
`run_fl` runs, so that the simulated axis agrees bit for bit and the
strong sets and coefficients are the same.

* Algorithm 1 (multiplicities n = max(1, min(t, round(d / d_min)))) and
  Algorithm 2 in closed form (pair p strong in state m iff
  m % L[p] == 0, the multiplicities clamped so their LCM stays within
  360 states);
* the round plan: directed edges, per-state strong masks,
  Metropolis-Hastings coefficients of the overlay (weak edges keep their
  coefficient and read a stale buffer);
* Eq. 4/5: the per-round cycle times, round by round, with no orbit
  short cut.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from bench.reference.overlay import (Network, compute_ms, pair_delays,
                                     ring_pairs)

CAP_STATES = 360


def _degrees(n: int, pairs) -> np.ndarray:
    deg = np.zeros(n, dtype=np.int64)
    for i, j in pairs:
        deg[i] += 1
        deg[j] += 1
    return deg


@dataclasses.dataclass(frozen=True)
class Plan:
    """Directed edges in the overlay's pair order (2e: i -> j, 2e+1:
    j -> i), per-state strong masks and coefficients, and the Eq. 4/5
    inputs of the simulated clock."""

    num_silos: int
    src: np.ndarray        # (2E,)
    dst: np.ndarray        # (2E,)
    strong: np.ndarray     # (S, 2E) bool
    coeffs: np.ndarray     # (2E,) f32: A[dst, src]
    diag: np.ndarray       # (N,) f32: A[i, i]
    pair_strong: np.ndarray  # (S, E) bool
    d0: np.ndarray         # (E,) f64
    pair_comp: np.ndarray  # (E,) f64
    lone_comp: np.ndarray  # (S,) f64

    @property
    def num_states(self) -> int:
        return self.strong.shape[0]

    def round(self, k: int):
        """(strong (2E,), coeffs (2E,), diag (N,)) of round ``k``."""
        return self.strong[k % self.num_states], self.coeffs, self.diag


def plan(net: Network, wl: dict, traffic: dict) -> Plan:
    """Algorithms 1 and 2 over the ring overlay, the MH weights of the
    overlay, and the Eq. 4/5 constants."""
    n = net.num_silos
    pairs = ring_pairs(net, wl)
    pi = np.array([p[0] for p in pairs], np.int64)
    pj = np.array([p[1] for p in pairs], np.int64)
    deg = _degrees(n, pairs)
    d0 = pair_delays(net, wl, pi, pj, deg)
    d_min = d0.min()
    t = traffic["t"]
    mult = [max(1, int(min(t, int(np.round(dp / d_min))))) for dp in d0]
    m_max = max(mult)

    def lcm_clamped(clamp):
        s = 1
        for m in mult:
            s = math.lcm(s, min(m, clamp))
        return s

    while m_max > 1 and lcm_clamped(m_max) > CAP_STATES:
        m_max -= 1
    mult = np.array([min(m, m_max) for m in mult], np.int64)
    num_states = 1
    for m in mult:
        num_states = math.lcm(num_states, int(m))
    pair_strong = (np.arange(num_states)[:, None] % mult[None, :]) == 0

    a = np.zeros((n, n))
    for i, j in pairs:
        a[i, j] = a[j, i] = 1.0 / (1.0 + max(deg[i], deg[j]))
    a[np.diag_indices(n)] = 1.0 - a.sum(axis=1)
    src = np.stack([pi, pj], axis=1).reshape(-1)
    dst = np.stack([pj, pi], axis=1).reshape(-1)
    comp = compute_ms(net, wl).astype(np.float64)
    in_strong = np.zeros((num_states, n), bool)
    for e, (i, j) in enumerate(pairs):
        in_strong[pair_strong[:, e], i] = True
        in_strong[pair_strong[:, e], j] = True
    lone = np.max(np.where(in_strong, -np.inf, comp[None, :]), axis=1)
    return Plan(
        num_silos=n, src=src, dst=dst,
        strong=np.repeat(pair_strong, 2, axis=1),
        coeffs=a[dst, src].astype(np.float32),
        diag=np.diag(a).astype(np.float32), pair_strong=pair_strong,
        d0=d0, pair_comp=np.maximum(comp[pi], comp[pj]), lone_comp=lone)


def cycle_times(plan: Plan, num_rounds: int) -> np.ndarray:
    """Eq. 4/5, one round after the other: the pair delays move by their
    edge type's transition (weak -> weak adds the last round's time,
    strong -> weak resets to it, weak -> strong takes the larger of the
    pair's compute and the last change, strong -> strong keeps), and a
    round lasts as long as its slowest strong pair or lone silo."""
    s_n = plan.num_states
    taus = np.empty(num_rounds, np.float64)
    d_cur = plan.d0.copy()
    d_prev = plan.d0.copy()
    prev_tau = 0.0
    for k in range(num_rounds):
        s = k % s_n
        cur = plan.pair_strong[s]
        if k > 0:
            prev = plan.pair_strong[(s - 1) % s_n]
            nxt = d_cur.copy()
            ww, sw, ws = ~prev & ~cur, prev & ~cur, ~prev & cur
            nxt[ww] += prev_tau
            nxt[sw] = prev_tau
            nxt[ws] = np.maximum(plan.pair_comp[ws], d_cur[ws] - d_prev[ws])
            d_prev, d_cur = d_cur, nxt
        tau = float(d_cur[cur].max()) if cur.any() else -np.inf
        if plan.lone_comp[s] > tau:
            tau = float(plan.lone_comp[s])
        taus[k] = tau
        prev_tau = tau
    return taus
