"""Open-loop traffic generator + fleet simulator (counterpart of
`repro.serving.traffic`, DESIGN.md §18; numpy, copied as it is).

Drives a `RegionalFleet` under heavy simulated load on a DISCRETE
simulated clock: one engine step costs `step_ms` of simulated time,
and client arrivals are an open-loop (arrivals never wait for
completions) Poisson process per client site, Bernoulli-binned onto
the same `step_ms` grid.

Determinism and the nested-load property both come from the
counter-based RNG the MATCHA sampler and the fault engine already use
(`design.catalog._counter_uniform`, splitmix64): site `m` generates a
request in tick `k` iff

    u(seed, k, m)  <  p_m(k, load)

where `u` is a pure function of (seed, tick, site) and `p_m` is
monotone increasing in the offered load. Raising the load therefore
only ADDS arrivals — every request of a lighter trace appears, with
identical content and timing, in every heavier trace — which, with
FIFO work-conserving engines, is what makes the bench's "p99 latency
is monotone non-decreasing in offered load" gate robust rather than a
statistical accident.

Clients live at the TRAINING silo sites (the population whose data
shaped the model), with a diurnal rate profile phased by longitude
(one synthetic day per serving window) — so the na region sleeps
while asia peaks, like real inference traffic. Each request pays the
zoo's great-circle WAN latency (`link_latency_ms`) client->region and
back; end-to-end latency = network + queueing + decoding.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.design.catalog import _counter_uniform
from repro_torch.networks.zoo import link_latency_ms

_PROMPT_SALT = 0x5EED_0001
_LEN_SALT = 0x5EED_0002


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Workload shape; `load` (offered req/s) is passed per run."""

    seed: int = 0
    duration_ms: float = 2_000.0   # arrival window (simulated)
    step_ms: float = 10.0          # simulated cost of one engine step
    prompt_len: tuple[int, int] = (4, 10)      # inclusive range
    max_new_tokens: tuple[int, int] = (4, 12)  # inclusive range
    diurnal_amp: float = 0.6       # 0 = flat; 0.6 = +-60% swing
    max_steps: int = 100_000       # drain safety valve

    @property
    def ticks(self) -> int:
        return int(math.ceil(self.duration_ms / self.step_ms))


@dataclasses.dataclass
class RequestRecord:
    """One completed request, all times on the serving sim clock (ms)."""

    rid: int
    site: str
    region: str
    t_gen: float        # client generates the request
    net_ms: float       # one-way client->region WAN latency
    t_submit: float     # reaches the region engine's queue
    t_done: float       # last token leaves the engine
    prompt: list[int]
    new_tokens: int
    staleness_ms: float  # served checkpoint's age at t_gen

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def e2e_ms(self) -> float:
        """Generate -> last token back at the client (both WAN legs)."""
        return self.t_done + self.net_ms - self.t_gen


@dataclasses.dataclass
class LoadResult:
    load: float
    requests: list[RequestRecord]
    summary: dict


def _diurnal(cfg: TrafficConfig, lons: np.ndarray) -> np.ndarray:
    """(ticks, M) rate multipliers: one synthetic day per window,
    phased by longitude, floor 0.1 so no site ever goes fully dark."""
    frac = (np.arange(cfg.ticks, dtype=np.float64)[:, None]
            * cfg.step_ms / cfg.duration_ms)
    phase = 2.0 * np.pi * (frac + lons[None, :] / 360.0)
    return np.maximum(0.1, 1.0 + cfg.diurnal_amp * np.sin(phase))


def generate_requests(fleet, cfg: TrafficConfig, load: float
                      ) -> list[RequestRecord]:
    """The arrival trace for an offered load (req/s across all sites).

    Pure function of (fleet's network metadata, cfg, load); t_done is
    left at -1 until `simulate` runs the trace. Nested in `load`: see
    module docstring.
    """
    from repro_torch.networks.registry import get_network
    net = get_network(fleet.meta["network"])
    n = int(fleet.meta["num_silos"])
    sites = net.silos[:n]
    lons = np.array([s.lon for s in sites])
    mult = _diurnal(cfg, lons)                        # (ticks, M)
    u = _counter_uniform(cfg.seed, np.arange(cfg.ticks), n)
    # per-site per-tick arrival probability, monotone in `load`
    p = np.clip((load / n) * (cfg.step_ms / 1e3) * mult, 0.0, 1.0)
    ticks, siloss = np.nonzero(u < p)

    # request content from counter draws keyed ONLY by (tick, site):
    # identical across loads for every shared arrival
    any_engine = next(iter(fleet.regions.values())).engine
    vocab = any_engine.cfg.vocab_size
    max_seq = any_engine.max_seq
    lo_p, hi_p = cfg.prompt_len
    lo_t, hi_t = cfg.max_new_tokens
    out: list[RequestRecord] = []
    for rid, (k, m) in enumerate(zip(ticks.tolist(), siloss.tolist())):
        ul = _counter_uniform(cfg.seed ^ _LEN_SALT, np.array([k]), n)[0, m]
        plen = lo_p + int(ul * (hi_p - lo_p + 1))
        ut = _counter_uniform(cfg.seed ^ _LEN_SALT, np.array([k + 1]),
                              n)[0, m]
        ntok = lo_t + int(ut * (hi_t - lo_t + 1))
        ntok = max(1, min(ntok, max_seq - plen))
        toks = _counter_uniform(cfg.seed ^ _PROMPT_SALT,
                                np.array([k * n + m]), plen)[0]
        prompt = [1 + int(t * (vocab - 1)) for t in toks]
        site = sites[m]
        region = fleet.route(site.lat, site.lon)
        anchor = fleet.regions[region]
        net_ms = link_latency_ms(site.lat, site.lon, anchor.lat,
                                 anchor.lon)
        t_gen = k * cfg.step_ms
        out.append(RequestRecord(
            rid=rid, site=site.name, region=region, t_gen=t_gen,
            net_ms=net_ms, t_submit=t_gen + net_ms, t_done=-1.0,
            prompt=prompt, new_tokens=ntok,
            staleness_ms=fleet.staleness_ms(t_gen)))
    return out


def simulate(fleet, cfg: TrafficConfig, load: float, *,
             recorder=None) -> LoadResult:
    """Run one offered-load point to completion (arrivals + drain).

    Engines are reset first; every arrival is driven until it
    completes, tick by tick: submit what has reached each region, step
    every busy engine (one simulated `step_ms` each — regions decode
    in parallel, as real replicas do), collect completions. With a
    `TraceRecorder`, each request lands as a span on the serving clock
    (`obs/export.py` pid 4, one track per region).
    """
    from repro_torch.serving.engine import Request

    fleet.reset()
    trace = generate_requests(fleet, cfg, load)
    queue = sorted(trace, key=lambda r: (r.t_submit, r.rid))
    pending = {r: {} for r in fleet.regions}          # rid -> record
    seen_done = {r: 0 for r in fleet.regions}
    util_sum, util_ticks = 0.0, 0
    nxt = 0
    t = 0.0
    completed: list[RequestRecord] = []
    for _ in range(cfg.max_steps):
        if nxt >= len(queue) and not any(pending.values()):
            break
        while nxt < len(queue) and queue[nxt].t_submit <= t:
            rec = queue[nxt]
            eng = fleet.regions[rec.region].engine
            rid = eng.submit(Request(prompt=list(rec.prompt),
                                     max_new_tokens=rec.new_tokens))
            pending[rec.region][rid] = rec
            nxt += 1
        for rname, reg in fleet.regions.items():
            eng = reg.engine
            if not pending[rname]:
                continue
            eng.step()
            util_sum += eng.utilization()
            util_ticks += 1
            done = eng.completed
            while seen_done[rname] < len(done):
                req = done[seen_done[rname]]
                seen_done[rname] += 1
                rec = pending[rname].pop(req.rid)
                rec.t_done = t + cfg.step_ms
                completed.append(rec)
        t += cfg.step_ms
    else:
        raise RuntimeError(f"load {load}: drain exceeded "
                           f"{cfg.max_steps} steps")

    completed.sort(key=lambda r: r.rid)
    if recorder is not None:
        for rec in completed:
            recorder.request_span(
                "request", t0_ms=rec.t_gen, dur_ms=rec.e2e_ms,
                region=rec.region, site=rec.site, load=load,
                prompt_len=rec.prompt_len, new_tokens=rec.new_tokens,
                staleness_ms=round(rec.staleness_ms, 3))

    lat = np.array([r.e2e_ms for r in completed])
    toks = sum(r.new_tokens for r in completed)
    span_ms = max((r.t_done for r in completed), default=cfg.step_ms)
    summary = {
        "load_rps": float(load),
        "arrived": len(trace),
        "completed": len(completed),
        "tokens": int(toks),
        "tokens_per_s": round(toks / (span_ms / 1e3), 3),
        "p50_ms": round(float(np.percentile(lat, 50)), 3) if len(lat)
        else 0.0,
        "p99_ms": round(float(np.percentile(lat, 99)), 3) if len(lat)
        else 0.0,
        "util": round(util_sum / util_ticks, 4) if util_ticks else 0.0,
        "staleness_p50_ms": round(float(np.percentile(
            [r.staleness_ms for r in completed], 50)), 3)
        if completed else 0.0,
        "sim_ms": round(float(span_ms), 3),
        "regions": {r: sum(1 for c in completed if c.region == r)
                    for r in fleet.regions},
    }
    return LoadResult(load=float(load), requests=completed,
                      summary=summary)


def sweep_loads(fleet, cfg: TrafficConfig, loads, *, recorder=None,
                trace_load: float | None = None) -> list[LoadResult]:
    """One `LoadResult` per offered load, ascending. Request spans go
    to the recorder only for ``trace_load`` (default: the highest), so
    a sweep's trace stays one readable serving timeline."""
    loads = sorted(float(x) for x in loads)
    if trace_load is None and loads:
        trace_load = loads[-1]
    out = []
    for load in loads:
        rec = recorder if (recorder is not None and
                           load == trace_load) else None
        out.append(simulate(fleet, cfg, load, recorder=rec))
    return out


# ---------------------------------------------------------------------------
# BENCH_torch_serving.json rows (the benchmarks/ merge format: name +
# us_per_call + derived, optional monotone ts — what `python -m
# repro_torch.obs validate --bench` checks). Lives here, so `python -m
# repro_torch.serving --bench` works from any cwd.
# ---------------------------------------------------------------------------

#: name prefixes the serving sweep owns inside its BENCH file
OWN_PREFIXES = ("serving/",)


def bench_rows(results: list[LoadResult], fleet) -> list[tuple]:
    """(name, us_per_call, derived) rows, one per load point plus a
    fleet row; us_per_call is the load point's p99 end-to-end latency
    in microseconds."""
    rows = [("serving/fleet", 0.0,
             f"network={fleet.meta.get('network')} "
             f"arch={fleet.meta.get('arch')} "
             f"ckpt_step={fleet.ckpt.step} "
             f"regions={','.join(fleet.region_names)} "
             f"staleness_lag_ms={fleet.staleness_lag_ms:.3f}")]
    for r in results:
        s = r.summary
        rows.append((
            f"serving/load_{s['load_rps']:g}rps",
            s["p99_ms"] * 1e3,
            f"tokens_per_s={s['tokens_per_s']} p50_ms={s['p50_ms']} "
            f"p99_ms={s['p99_ms']} util={s['util']} "
            f"completed={s['completed']}/{s['arrived']} "
            f"staleness_p50_ms={s['staleness_p50_ms']}"))
    return rows


def write_bench_json(rows: list[tuple], path="BENCH_torch_serving.json"):
    """Merge-write: rows from other suites sharing the file survive;
    ``ts`` stamps keep the BENCH-schema monotonicity check meaningful
    (same protocol as benchmarks/obs_bench.py)."""
    import json
    import pathlib
    import time
    p = pathlib.Path(path)
    kept = []
    if p.exists():
        kept = [r for r in json.loads(p.read_text())
                if not str(r.get("name", "")).startswith(OWN_PREFIXES)]
    now = time.time()
    out = [{"name": n, "us_per_call": round(us, 1), "derived": d,
            "ts": round(now + i * 1e-3, 3)}
           for i, (n, us, d) in enumerate(rows)]
    p.write_text(json.dumps(kept + out, indent=1))
    return out
