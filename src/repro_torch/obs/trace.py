"""Three-clock span recorder for the FL stack (counterpart of
`repro.obs.trace`, numpy only).

A `TraceRecorder` fuses three time sources into one ordered event log:

  * **simulated clock** — per-silo compute/transfer/wait spans per
    round, decomposed from `TimingPlan.delay_history()` (the Eq. 4
    pair-delay replay) or from a `FaultedSegment`'s observed delays.
    Span ends reconcile EXACTLY with `cycle_times`: for every round,
    each silo's last span ends at the round's tau.
  * **host wall clock** — `host_span(...)` context manager around
    compile/dispatch/eval/checkpoint boundaries in `fl/trainer.py`,
    measured from the recorder's epoch.
  * **controller events** — instants (`observe`/`replan`/`swap`) of a
    design controller, anchored on the simulated clock at the segment
    boundary where they fire.

Events are plain dicts; `obs/export.py` turns them into Perfetto
`trace_event` JSON (sim spans on one track per silo, counters from the
in-scan metrics, host/controller on their own processes) or a JSONL
run-record.

Span decomposition per (round k, silo i): compute `[0, comp_i]`;
transfer `[comp_i, f]` where `f = max d[k][e]` over silo i's strong
pairs this round (the recurrence guarantees `f >= pair_comp_e >=
comp_i`); wait `[f, tau_k]`. The wait (or "down") span carries the
round's ABSOLUTE end time `t1_ms` — the cumulative tau sum, stored
rather than re-derived from `t0 + dur` — so span ends reconcile with
`cycle_times` bit-exactly, free of float re-association. A silo with
no strong pair gets status "isolated" (compute + wait only); faulted
rounds add "demoted" (planned-strong pair degraded away) and "down"
(crashed silo, one span covering the round).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import numpy as np


@dataclasses.dataclass
class TraceRecorder:
    """Mutable event log; see module docstring. All times in ms."""

    sim_events: list = dataclasses.field(default_factory=list)
    host_events: list = dataclasses.field(default_factory=list)
    ctrl_events: list = dataclasses.field(default_factory=list)
    counter_events: list = dataclasses.field(default_factory=list)
    serve_events: list = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._epoch = time.perf_counter()

    # ---- host wall clock --------------------------------------------
    def host_now_ms(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e3

    @contextlib.contextmanager
    def host_span(self, name: str, **args: Any):
        """Wall-clock span around a compile/dispatch/eval boundary."""
        t0 = self.host_now_ms()
        try:
            yield
        finally:
            self.host_events.append({
                "clock": "host", "name": name, "t0_ms": t0,
                "dur_ms": self.host_now_ms() - t0, "args": args})

    # ---- serving clock ----------------------------------------------
    def request_span(self, name: str, *, t0_ms: float, dur_ms: float,
                     region: str, **args: Any) -> None:
        """One request's lifetime on the SERVING simulated clock (the
        traffic generator's tick clock, ms from serve start): generated
        at the client at `t0_ms`, last token back at `t0_ms + dur_ms`.
        Exported on its own Perfetto process, one track per region."""
        self.serve_events.append({
            "clock": "serve", "name": name, "t0_ms": float(t0_ms),
            "dur_ms": float(dur_ms), "region": str(region), "args": args})

    # ---- controller events ------------------------------------------
    def instant(self, name: str, *, t_ms: float, round: int | None = None,
                **args: Any) -> None:
        """Controller instant on the SIMULATED clock (observe/replan/
        swap), anchored at the cumulative cycle time where it fired."""
        self.ctrl_events.append({
            "clock": "ctrl", "name": name, "t_ms": float(t_ms),
            "round": round, "args": args})

    # ---- simulated clock --------------------------------------------
    def add_sim_spans(self, tplan, num_rounds: int, *,
                      start_round: int = 0, t0_ms: float = 0.0) -> float:
        """Per-silo spans for `num_rounds` of a recurrence TimingPlan.

        Returns the simulated end time (t0_ms + sum of taus). For a
        cyclic-kind plan (no per-pair state) each silo gets a single
        compute+wait decomposition against the round's cycle time.
        """
        if tplan.kind != "recurrence":
            taus = np.asarray(tplan.cycle_times(num_rounds), np.float64)
            comp = np.asarray(tplan.comp, np.float64)
            t = float(t0_ms)
            for k in range(num_rounds):
                tau = float(taus[k])
                t_end = t + tau
                for i in range(comp.shape[0]):
                    c = min(float(comp[i]), tau)
                    self._silo_round(start_round + k, i, t, c, c, t_end,
                                     "strong")
                t = t_end
            return t
        taus, d, strong = tplan.delay_history(num_rounds)
        return self._emit_rounds(
            np.asarray(tplan.pair_i), np.asarray(tplan.pair_j),
            np.asarray(tplan.comp, np.float64), taus, d, strong,
            start_round=start_round, t0_ms=t0_ms)

    def add_faulted_spans(self, pair_i, pair_j, seg, *,
                          start_round: int | None = None,
                          t0_ms: float = 0.0) -> float:
        """Spans for one faulted segment using its OBSERVED per-pair
        delays. ``seg`` is read by attribute only (``start``, ``taus``,
        ``eff``, ``planned``, ``obs``, ``comp_obs``, ``crashed``: the
        fields of the fault engine's `FaultedSegment`); ``seg.obs`` is
        set when the session records observations (``record_obs=True``).
        Per-silo compute comes from the segment's observed ``comp_obs``,
        so spike rounds show their real compute stretch.

        Statuses: "strong" (live strong pair), "isolated" (no strong
        pair planned), "demoted" (planned strong, degraded away this
        round), "down" (crashed silo — one span for the whole round).
        """
        if seg.obs is None:
            raise ValueError("segment has no observed-delay record; build "
                             "the FaultedSession with record_obs=True")
        pair_i = np.asarray(pair_i)
        pair_j = np.asarray(pair_j)
        taus = np.asarray(seg.taus, np.float64)
        start = seg.start if start_round is None else start_round
        t = float(t0_ms)
        for k in range(taus.shape[0]):
            tau = float(taus[k])
            t_end = t + tau
            eff = np.asarray(seg.eff[k], bool)
            planned = np.asarray(seg.planned[k], bool)
            obs = np.asarray(seg.obs[k], np.float64)
            comp = np.asarray(seg.comp_obs[k], np.float64)
            for i in range(comp.shape[0]):
                if bool(seg.crashed[k, i]):
                    self.sim_events.append({
                        "clock": "sim", "name": "down", "round": start + k,
                        "silo": i, "t0_ms": t, "dur_ms": tau,
                        "t1_ms": t_end, "args": {"status": "down"}})
                    continue
                inc = (pair_i == i) | (pair_j == i)
                live = inc & eff
                if live.any():
                    f = min(float(obs[live].max()), tau)
                    status = "strong"
                elif (inc & planned).any():
                    f = min(float(comp[i]), tau)
                    status = "demoted"
                else:
                    f = min(float(comp[i]), tau)
                    status = "isolated"
                c = min(float(comp[i]), f)
                self._silo_round(start + k, i, t, c, f, t_end, status)
            t = t_end
        return t

    def add_metrics(self, metrics, columns, round_starts_ms,
                    *, start_round: int = 0) -> None:
        """Counter samples from an `(R, K)` in-scan metrics matrix,
        one sample per round at the round's simulated start time."""
        m = np.asarray(metrics, np.float64)
        starts = np.asarray(round_starts_ms, np.float64)
        for k in range(m.shape[0]):
            for j, name in enumerate(columns):
                self.counter_events.append({
                    "clock": "sim", "name": str(name),
                    "round": start_round + k, "t_ms": float(starts[k]),
                    "value": float(m[k, j])})

    # ---- assembly ---------------------------------------------------
    def _silo_round(self, rnd: int, silo: int, t: float, c: float,
                    f: float, t_end: float, status: str) -> None:
        ev = self.sim_events
        base = {"clock": "sim", "round": rnd, "silo": silo,
                "args": {"status": status}}
        ev.append({**base, "name": "compute", "t0_ms": t, "dur_ms": c})
        if f > c:
            ev.append({**base, "name": "transfer", "t0_ms": t + c,
                       "dur_ms": f - c})
        # the closing span stores the round's absolute end: reconciling
        # against cycle_times never re-sums floats
        ev.append({**base, "name": "wait", "t0_ms": t + f,
                   "dur_ms": t_end - (t + f), "t1_ms": t_end})

    def _emit_rounds(self, pair_i, pair_j, comp, taus, d, strong, *,
                     start_round: int, t0_ms: float) -> float:
        t = float(t0_ms)
        for k in range(taus.shape[0]):
            tau = float(taus[k])
            t_end = t + tau
            s = strong[k]
            for i in range(comp.shape[0]):
                live = ((pair_i == i) | (pair_j == i)) & s
                if live.any():
                    f = min(float(d[k][live].max()), tau)
                    status = "strong"
                else:
                    f = min(float(comp[i]), tau)
                    status = "isolated"
                c = min(float(comp[i]), f)
                self._silo_round(start_round + k, i, t, c, f, t_end, status)
            t = t_end
        return t

    def events(self) -> list[dict]:
        """One ordered log: sim+ctrl by (round, silo, time), host spans
        appended on their own clock."""
        def key(e):
            return (e.get("round") if e.get("round") is not None else -1,
                    e.get("silo") if e.get("silo") is not None else -1,
                    e.get("t0_ms", e.get("t_ms", 0.0)))
        sim = sorted(self.sim_events + self.ctrl_events +
                     self.counter_events, key=key)
        host = sorted(self.host_events, key=lambda e: e["t0_ms"])
        serve = sorted(self.serve_events, key=lambda e: e["t0_ms"])
        return sim + host + serve

    def round_end_ms(self, rnd: int) -> float:
        """Simulated end time of a round (max wait-span end)."""
        ends = [e["t1_ms"] for e in self.sim_events
                if e.get("round") == rnd and e["name"] in ("wait", "down")]
        if not ends:
            raise KeyError(f"no sim spans recorded for round {rnd}")
        return max(ends)
