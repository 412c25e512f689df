"""Seeded, counter-based fault schedules (counterpart of
`repro.faults.schedule`, DESIGN.md §14).

A `FaultSchedule` is a list of events that perturb the Eq. 3 delay
inputs per round. Everything is expressed as dense per-round arrays —
``link_scale``/``comp_scale`` ``(R, N)`` multipliers, ``crashed``/
``flapped`` ``(R, N)`` bools — so the timing recurrence and the
training loop consume OBSERVED conditions with no new control flow:
the nominal schedule produces exact-identity arrays (scale ``1.0``,
masks ``False``), and ``x * 1.0`` / ``x + 0.0`` are bitwise identities
for the positive finite doubles the delay model produces, which is
what makes the faulted engine bit-exact with the nominal one under
``nominal``.

Randomized events (flash stragglers, churn, link flaps) are
COUNTER-BASED: each draw is a pure splitmix64 function of
``(schedule seed, event index, frame, silo)`` via the same
`_counter_uniform` the MATCHA sampler uses, so any fault trace
reproduces cross-process and any subset of rounds can be materialized
in any order with identical bits — no RNG state is ever carried.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.design.catalog import _counter_uniform


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault process. ``kind`` selects which knobs apply.

    kind="link_drift"  — multiplicative link-delay ramp on ``silos``:
        scale ramps 1 -> ``peak_scale`` over ``ramp_rounds`` rounds
        starting at ``start``, then holds until ``stop``.
    kind="diurnal"     — capacity curve: scale = 1 + amplitude *
        (1 - cos(2*pi*(k - start)/period)) / 2 on ``silos``.
    kind="flash"       — compute spikes: in each ``duration``-round
        frame a silo is spiked (comp_scale = ``spike_scale``) with
        probability ``rate`` (counter-based per (frame, silo)).
    kind="churn"       — crash/recovery windows: in each ``duration``-
        round frame a silo is down with probability ``rate``.
    kind="crash"       — deterministic outage: ``silos`` are down for
        rounds [start, stop).
    kind="link_loss"   — transient flaps: a silo's links are down for
        one round with probability ``rate`` (counter-based per
        (round, silo)); the silo itself keeps computing.

    ``silos=None`` targets every silo. All events are inert outside
    ``[start, stop)`` (``stop=None`` = forever).
    """

    kind: str
    silos: tuple[int, ...] | None = None
    start: int = 0
    stop: int | None = None
    peak_scale: float = 1.0
    ramp_rounds: int = 1
    amplitude: float = 0.0
    period: int = 64
    rate: float = 0.0
    duration: int = 1
    spike_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class FaultArrays:
    """Materialized per-round fault state for a set of rounds.

    ``link_scale``/``comp_scale`` are >= 1 multipliers on a silo's link
    delays / local compute; ``crashed`` marks silos that are down
    (network partition: local training continues, the fleet does not
    wait); ``flapped`` marks silos whose links are transiently lost
    this round (alive, computing, unreachable).
    """

    link_scale: np.ndarray   # (R, N) f64
    comp_scale: np.ndarray   # (R, N) f64
    crashed: np.ndarray      # (R, N) bool
    flapped: np.ndarray      # (R, N) bool


def _silo_cols(ev: FaultEvent, n: int) -> np.ndarray:
    if ev.silos is None:
        return np.arange(n)
    return np.asarray([s for s in ev.silos if s < n], np.int64)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A named, seeded composition of fault events.

    Scales compose by elementwise max (concurrent degradations do not
    multiply — the worst one dominates), outage masks by OR. The empty
    schedule is the nominal world: exact-identity arrays.
    """

    name: str
    events: tuple[FaultEvent, ...] = ()
    seed: int = 0

    @property
    def is_nominal(self) -> bool:
        return not self.events

    def arrays(self, rounds_idx, num_silos: int) -> FaultArrays:
        """Fault state for ``rounds_idx`` (any subset, any order)."""
        rounds_idx = np.asarray(rounds_idx, np.int64)
        r, n = len(rounds_idx), num_silos
        link = np.ones((r, n), np.float64)
        comp = np.ones((r, n), np.float64)
        crashed = np.zeros((r, n), bool)
        flapped = np.zeros((r, n), bool)
        for idx, ev in enumerate(self.events):
            cols = _silo_cols(ev, n)
            if cols.size == 0:
                continue
            stop = np.iinfo(np.int64).max if ev.stop is None else ev.stop
            win = (rounds_idx >= ev.start) & (rounds_idx < stop)  # (R,)
            if not win.any():
                continue
            ev_seed = self.seed * 1_000_003 + idx
            if ev.kind == "link_drift":
                frac = np.clip((rounds_idx - ev.start + 1)
                               / max(ev.ramp_rounds, 1), 0.0, 1.0)
                scale = 1.0 + (ev.peak_scale - 1.0) * np.where(win, frac, 0.0)
                link[:, cols] = np.maximum(link[:, cols], scale[:, None])
            elif ev.kind == "diurnal":
                phase = 2.0 * math.pi * (rounds_idx - ev.start) / ev.period
                scale = 1.0 + ev.amplitude * np.where(
                    win, 0.5 * (1.0 - np.cos(phase)), 0.0)
                link[:, cols] = np.maximum(link[:, cols], scale[:, None])
            elif ev.kind == "flash":
                frames = rounds_idx // max(ev.duration, 1)
                hit = _counter_uniform(ev_seed, frames, n)[:, cols] < ev.rate
                hit &= win[:, None]
                comp[:, cols] = np.where(hit, np.maximum(comp[:, cols],
                                                         ev.spike_scale),
                                         comp[:, cols])
            elif ev.kind == "churn":
                frames = rounds_idx // max(ev.duration, 1)
                hit = _counter_uniform(ev_seed, frames, n)[:, cols] < ev.rate
                crashed[:, cols] |= hit & win[:, None]
            elif ev.kind == "crash":
                crashed[np.ix_(win, cols)] = True
            elif ev.kind == "link_loss":
                hit = _counter_uniform(ev_seed, rounds_idx, n)[:, cols] \
                    < ev.rate
                flapped[:, cols] |= hit & win[:, None]
            else:
                raise ValueError(f"unknown fault kind {ev.kind!r}")
        return FaultArrays(link, comp, crashed, flapped)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named schedule plus the degradation knobs consumers default to
    (`degrade.DegradePolicy` is built from these unless overridden)."""

    schedule: FaultSchedule
    timeout_ms: float = math.inf
    max_stale: int = 8


NOMINAL = FaultSchedule(name="nominal")

#: Named scenario registry (the sweep's and the obs CLI's `--scenario`
#: flag). Silo indices are valid on every
#: paper network (N >= 11). Magnitudes are sized for the paper's delay
#: regime (tens-to-hundreds of ms pair delays).
SCENARIOS: dict[str, Scenario] = {
    "nominal": Scenario(schedule=NOMINAL),
    # Sustained link degradation that ramps PAST the timeout. The
    # multigraph recurrence strongly dampens drift — a pair's observed
    # delay on a strong round is its pipelined WS residual (~1/6 of the
    # Eq. 3 delay on gaia), so the drift must be deep (8x) before the
    # steady-state observation crosses an SLA that still clears the
    # nominal round-0 overlay peak. Once it does, the static fleet
    # waits out the timeout on every planned appearance of a drifted
    # pair, while the adaptive fleet pays detection once per staleness
    # streak and re-plans the multiplicities — the re-planning scenario.
    "drift": Scenario(schedule=FaultSchedule(name="drift", events=(
        FaultEvent(kind="link_drift", silos=(0, 1, 2), start=4,
                   ramp_rounds=12, peak_scale=8.0),)), timeout_ms=80.0),
    # Slow sinusoidal capacity swing across the whole fleet.
    "diurnal": Scenario(schedule=FaultSchedule(name="diurnal", events=(
        FaultEvent(kind="diurnal", amplitude=1.0, period=48),))),
    # Compute spikes far above the timeout: the spiked silo must degrade
    # to an isolated node (the paper's own mechanic) or stall the fleet.
    "flash": Scenario(schedule=FaultSchedule(name="flash", events=(
        FaultEvent(kind="flash", rate=0.25, duration=6,
                   spike_scale=2000.0),)), timeout_ms=600.0),
    # Random crash/recovery windows (connectivity churn).
    "churn": Scenario(schedule=FaultSchedule(name="churn", events=(
        FaultEvent(kind="churn", rate=0.15, duration=10),)),
        timeout_ms=500.0),
    # Deterministic regional outage mid-horizon.
    "outage": Scenario(schedule=FaultSchedule(name="outage", events=(
        FaultEvent(kind="crash", silos=(0, 1), start=12, stop=36),)),
        timeout_ms=500.0),
    # Transient per-round link flaps.
    "flap": Scenario(schedule=FaultSchedule(name="flap", events=(
        FaultEvent(kind="link_loss", rate=0.05),)), timeout_ms=500.0),
}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; known: "
                         f"{sorted(SCENARIOS)}") from None


def scenario_overrides(scenario: Scenario, net, wl, overlay,
                       rounds: int) -> tuple[np.ndarray | None,
                                             np.ndarray | None]:
    """Horizon-mean observed delay estimates for planning under faults.

    Returns ``(d0_override, comp_override)`` for
    `timing.multiplicity_timing_plan`: the mean faulted Eq. 3 pair
    delay over the horizon (pairs with any dead rounds floored at the
    scenario timeout — each use of a dead pair costs the timeout) and
    the mean observed per-silo compute. The nominal scenario returns
    ``(None, None)`` so nominal callers take today's exact code path.
    """
    if scenario.schedule.is_nominal:
        return None, None
    from repro_torch.core import timing as tmod

    pairs = overlay.pairs
    pi = np.fromiter((p[0] for p in pairs), np.int64, len(pairs))
    pj = np.fromiter((p[1] for p in pairs), np.int64, len(pairs))
    comp = wl.compute_ms(net).astype(np.float64)
    d0 = tmod.pair_delay_vector(net, wl, pi, pj, overlay.degrees())
    pair_comp = np.maximum(comp[pi], comp[pj])
    arr = scenario.schedule.arrays(np.arange(rounds), net.num_silos)
    cs = comp[None, :] * arr.comp_scale                     # (R, N)
    scale = np.maximum(arr.link_scale[:, pi], arr.link_scale[:, pj])
    extra = np.maximum(cs[:, pi], cs[:, pj]) - pair_comp[None, :]
    base = d0[None, :] * scale + extra                      # (R, E)
    down = arr.crashed | arr.flapped
    dead = down[:, pi] | down[:, pj]
    d0_obs = base.mean(axis=0)
    if np.isfinite(scenario.timeout_ms):
        d0_obs = np.where(dead.any(axis=0),
                          np.maximum(d0_obs, scenario.timeout_ms), d0_obs)
    return d0_obs, cs.mean(axis=0)
