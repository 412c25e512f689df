"""Faulted Eq. 4 delay recurrence with graceful degradation (counterpart
of `repro.faults.engine`).

`FaultedSession` runs the SAME per-pair delay recurrence as
`core/timing.py` (`_recurrence_taus`), but feeds it OBSERVED
conditions: each round the candidate strong delay is scaled by the
round's link multipliers and shifted by observed compute spikes, and
the round's effective strong set is the planned one minus degraded
pairs. Degradation follows the paper's own isolated-node mechanic:

* a pair whose observed delay exceeds the policy timeout — or whose
  endpoint is crashed/flapped — is DEMOTED to weak for the round: its
  delay takes the weak branch of Eq. 4 (`tau_k` / `tau_k + d_k`), the
  training plan keeps its coefficient but reads the stale buffer, and
  a silo left with no effective strong pair becomes an isolated node
  that "does model aggregation without waiting for other nodes";
* bounded staleness: after `max_stale` consecutive demotions an ALIVE
  pair is forced strong again (the Eq. 4 weak->strong branch, paying
  whatever the observed delay is) so staleness cannot grow unbounded;
* the wall clock differs by policy: a STATIC fleet discovers each
  degraded round by waiting out the timeout (tau >= timeout on every
  demoted round), while an ADAPTIVE fleet pays the timeout once per
  demotion streak (detection) and then proactively routes around the
  pair. The effective strong masks are IDENTICAL across the two
  policies — absent controller re-plans they train the same params —
  so any time-to-accuracy gap is purely wall-clock.

Two taus per round: the LATENT tau (nominal units, Eq. 5 over the
effective strong set) drives the Eq. 4 recurrence — the schedule
pipeline advances on the nominal clock — while the OBSERVED tau (the
latent candidates scaled/shifted by the round's faults, plus timeout
charges and the observed lone-compute term) is the reported wall
clock. Feeding the observed tau back into the WW/SW branches instead
would compound multiplicative faults exponentially: a weak->strong
pair re-enters at roughly the previous tau, and re-scaling that on
every hop turns a 3x link drift into 3^k. A fault scales the waiting
it causes; it does not recursively slow the pipeline bookkeeping.

Under the nominal schedule every scale is exactly 1.0, every mask is
False, and every arithmetic op matches `_recurrence_taus` bit-for-bit
(`x * 1.0 + 0.0 == x` for the positive finite doubles of the delay
model), so `FaultedSession(...).advance(R).taus` reproduces
`plan.cycle_times(R)` exactly.

Demotion decisions read the round's observed delay directly; this is
the simulator's omniscient stand-in for the heartbeat/probe a real
deployment would use — the paper's timing model is an oracle model
throughout, and the faulted one inherits that.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.faults.degrade import DegradePolicy
from repro_torch.faults.schedule import NOMINAL, FaultSchedule


@dataclasses.dataclass(frozen=True)
class FaultedSegment:
    """Observed history for one `advance` call (``r`` rounds).

    ``base`` is the schedule-only faulted Eq. 3 pair delay (nominal d0
    scaled/shifted, no recurrence) — the re-planning signal; ``taus``
    is the realized per-round cycle time; ``eff``/``planned`` the
    effective vs planned strong masks over overlay pairs.
    """

    start: int               # global round index of the first row
    taus: np.ndarray         # (r,) f64 realized cycle times
    planned: np.ndarray      # (r, E) bool — plan's strong mask
    eff: np.ndarray          # (r, E) bool — after degradation
    dead: np.ndarray         # (r, E) bool — endpoint crashed/flapped
    base: np.ndarray         # (r, E) f64 — faulted Eq. 3 (no recurrence)
    crashed: np.ndarray      # (r, N) bool
    comp_obs: np.ndarray     # (r, N) f64 — observed per-silo compute
    paid_timeout: np.ndarray  # (r,) bool — clock hit the timeout
    phases: np.ndarray       # (r,) int64 — plan state index per round
    obs: np.ndarray | None = None  # (r, E) f64 observed per-pair delay
    #   (what the round's strong pairs block on; populated only when
    #   the session is built with record_obs=True — the obs layer's
    #   span source, inert otherwise)


@dataclasses.dataclass
class FaultedSession:
    """Stateful faulted recurrence over a recurrence-kind TimingPlan.

    `advance(r)` steps ``r`` rounds and returns the segment; chunked
    advances are bit-identical to one big advance (the schedule is
    counter-based and all carried state lives on the session).
    `swap_plan` installs a new plan (same overlay pair set) mid-run:
    delay state carries across — only the planned masks change — which
    is exactly the live-schedule-swap the controller performs.
    """

    plan: "object"                       # timing.TimingPlan (recurrence)
    schedule: FaultSchedule = NOMINAL
    policy: DegradePolicy = DegradePolicy()
    record_obs: bool = False             # keep per-round observed pair
    #   delays on each segment (obs/trace.py span source); pure extra
    #   storage — decisions and taus are identical either way

    def __post_init__(self):
        plan = self.plan
        if plan.kind != "recurrence":
            raise ValueError("FaultedSession needs a recurrence-kind "
                             f"TimingPlan, got kind={plan.kind!r}")
        self._pi = plan.pair_i
        self._pj = plan.pair_j
        self._pair_comp = plan.pair_comp
        self._comp = plan.comp
        self._num_silos = int(plan.num_nodes)
        self._strong = plan.strong
        # carried recurrence state
        self._d_cur = plan.d0.copy()
        self._d_prev = plan.d0.copy()
        self._prev_tau = 0.0
        self._prev_eff = np.zeros(len(plan.d0), bool)
        self._streak = np.zeros(len(plan.d0), np.int64)
        self._silo_streak = np.zeros(self._num_silos, np.int64)
        self._k = 0       # global round counter (never resets)
        self._phase = 0   # plan-local round counter (resets on swap)

    @property
    def round(self) -> int:
        return self._k

    def swap_plan(self, plan) -> None:
        """Install a new recurrence plan; delay state carries across."""
        if plan.kind != "recurrence":
            raise ValueError("swap_plan needs a recurrence-kind plan")
        if not (np.array_equal(plan.pair_i, self._pi)
                and np.array_equal(plan.pair_j, self._pj)):
            raise ValueError("swapped plan must share the overlay pair set")
        self.plan = plan
        self._strong = plan.strong
        self._phase = 0

    def advance(self, num_rounds: int) -> FaultedSegment:
        pi, pj = self._pi, self._pj
        e = len(self._d_cur)
        n = self._num_silos
        s_count = self._strong.shape[0]
        start = self._k
        rounds_idx = np.arange(start, start + num_rounds, dtype=np.int64)
        arr = self.schedule.arrays(rounds_idx, n)
        comp_obs = self._comp[None, :] * arr.comp_scale            # (r, N)
        link_pair = np.maximum(arr.link_scale[:, pi],
                               arr.link_scale[:, pj])              # (r, E)
        # observed-compute shift over the nominal pair compute already
        # inside the recurrence delay (0.0 exactly when comp_scale==1)
        extra = (np.maximum(comp_obs[:, pi], comp_obs[:, pj])
                 - self._pair_comp[None, :])                       # (r, E)
        down = arr.crashed | arr.flapped
        dead = down[:, pi] | down[:, pj]                           # (r, E)
        base = self._d0_base(link_pair, extra)

        taus = np.empty(num_rounds, np.float64)
        planned_out = np.empty((num_rounds, e), bool)
        eff_out = np.empty((num_rounds, e), bool)
        paid = np.zeros(num_rounds, bool)
        phases = np.empty(num_rounds, np.int64)
        obs_out = (np.empty((num_rounds, e), np.float64)
                   if self.record_obs else None)
        timeout = self.policy.timeout_ms
        max_stale = self.policy.max_stale
        adaptive = self.policy.adaptive
        finite_to = math.isfinite(timeout)

        for r in range(num_rounds):
            phases[r] = self._phase % s_count
            planned = self._strong[phases[r]]
            if self._k == 0:
                cand_strong = self._d_cur
                cand_weak = self._d_cur
            else:
                ws = np.maximum(self._pair_comp,
                                self._d_cur - self._d_prev)
                cand_strong = np.where(self._prev_eff, self._d_cur, ws)
                cand_weak = np.where(self._prev_eff,
                                     np.float64(self._prev_tau),
                                     self._prev_tau + self._d_cur)
            obs = cand_strong * link_pair[r] + extra[r]
            if obs_out is not None:
                obs_out[r] = obs
            over = obs > timeout
            want = planned & (dead[r] | over)
            forced = planned & ~dead[r] & (self._streak >= max_stale)
            demoted = want & ~forced
            eff = planned & ~demoted
            pay = demoted if not adaptive else (demoted
                                                & (self._streak == 0))
            d_next = np.where(eff, cand_strong, cand_weak)
            in_eff = np.zeros(n, bool)
            in_eff[pi[eff]] = True
            in_eff[pj[eff]] = True
            # Latent tau (NOMINAL units) drives the Eq. 4 recurrence —
            # the pipeline advances on the nominal clock, so a fault
            # scales the waiting it causes without feeding back into
            # the delay state (scaled taus re-entering the WW/SW
            # branches would compound exponentially).
            tau_lat = float(np.max(np.where(eff, cand_strong, -np.inf),
                                   initial=-np.inf))
            lone_lat = ~in_eff
            if lone_lat.any():
                lv = float(self._comp[lone_lat].max())
                if lv > tau_lat:
                    tau_lat = lv
            if not math.isfinite(tau_lat):
                tau_lat = 0.0
            # Observed tau is the wall clock of the round.
            tau = float(np.max(np.where(eff, obs, -np.inf),
                               initial=-np.inf))
            if finite_to and pay.any():
                paid[r] = True
                if timeout > tau:
                    tau = timeout
            # Eq. 5 lone-node term over OBSERVED compute: nodes with no
            # effective strong pair contribute their local compute —
            # except crashed silos, which the fleet never waits for, and
            # STRAGGLERS (observed compute over the timeout): the fleet
            # stops waiting at the timeout — charged by the same policy
            # rule as pair demotions (every round static, once per
            # straggle streak adaptive) — instead of stalling the cycle
            # on an alive-but-spiked isolated silo.
            lone = lone_lat & ~arr.crashed[r]
            straggler = comp_obs[r] > timeout
            lone_wait = lone & ~straggler
            if lone_wait.any():
                lv = float(comp_obs[r][lone_wait].max())
                if lv > tau:
                    tau = lv
            lone_straggle = lone & straggler
            if finite_to and lone_straggle.any():
                pay_silo = (lone_straggle if not adaptive else
                            lone_straggle & (self._silo_streak == 0))
                if pay_silo.any():
                    paid[r] = True
                    if timeout > tau:
                        tau = timeout
            if not math.isfinite(tau):
                tau = 0.0   # whole fleet down: the round costs nothing
            taus[r] = tau
            planned_out[r] = planned
            eff_out[r] = eff
            self._d_prev, self._d_cur = self._d_cur, d_next
            # Staleness is buffer age: it grows on demotion, HOLDS on
            # planned-weak rounds (not being scheduled does not refresh
            # the stale buffer), and resets only when the pair actually
            # completes a strong exchange. This is what lets an adaptive
            # fleet pay detection once per outage instead of once per
            # scheduled appearance of a multiplicity-m pair.
            self._streak = np.where(demoted, self._streak + 1,
                                    np.where(eff, 0, self._streak))
            self._silo_streak = np.where(lone_straggle,
                                         self._silo_streak + 1, 0)
            self._prev_eff = eff
            self._prev_tau = tau_lat
            self._k += 1
            self._phase += 1
        return FaultedSegment(
            start=start, taus=taus, planned=planned_out, eff=eff_out,
            dead=dead, base=base, crashed=arr.crashed, comp_obs=comp_obs,
            paid_timeout=paid, phases=phases, obs=obs_out)

    def _d0_base(self, link_pair: np.ndarray,
                 extra: np.ndarray) -> np.ndarray:
        return self.plan.d0[None, :] * link_pair + extra
