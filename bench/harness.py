"""One run of one cell of `BENCHMARK.json`: set-up, the timed window of
back-to-back `repro_torch.fl.run_fl` calls, on ``--trace 1`` a profiled
stretch, then the comparison with the plain reference.

Everything a cell is made of is found by name: its workload entry in
`BENCHMARK.json` names a configuration (`configs/<name>.json`, with its
plain reference `configs/<name>.py` beside it) and a traffic mix
(`traffic/<name>.json`); the cell's own file (`cells/<workload>.json`)
holds the rounds the reference follows and the limits of the comparison;
each per-layer metric is read by `metrics/<name>.py`.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    check_rounds: int
    limits: dict
    per_layer: list     # the manifest's per-layer entries this cell reports


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(workload: str) -> Cell:
    """The cell ``workload`` of `BENCHMARK.json`, with its configuration,
    traffic and check files."""
    manifest = _json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in manifest["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    cell = _json(BENCH / "cells" / f"{workload}.json")
    return Cell(
        name=workload, chips=entry["chips"],
        cfg=_json(ROOT / cfg_entry["file"]),
        traffic=_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        check_rounds=cell["check_rounds"], limits=cell["limits"],
        per_layer=[m for m in manifest["per_layer"]
                   if workload in m.get("workloads", [workload])])


def fl_kwargs(cell: Cell, seed: int, **over) -> dict:
    """`FLConfig` fields of one run of the cell from ``seed``."""
    c, t = cell.cfg, cell.traffic
    kw = dict(dataset=c["dataset"], network=t["network"],
              topology=t["topology"], t=t["t"], rounds=t["rounds"],
              local_updates=c["local_updates"], batch_size=c["batch_size"],
              lr=c["lr"], momentum=c["momentum"], seed=seed,
              eval_every=t["eval_every"],
              samples_per_silo=t["samples_per_silo"], alpha=t["alpha"])
    kw.update(over)
    return kw


def call_seeds(seed: int):
    """The seeds of a run's `run_fl` calls, drawn from ``--seed``: every
    call trains on its own data and initial parameters."""
    rng = np.random.default_rng(seed % 2 ** 64)
    while True:
        yield int(rng.integers(0, 2 ** 31 - 1))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _stretch(cell, seed, device, window_round_ms, peaks):
    """The profiled stretch: one whole call with the program's recorder
    on, and what the per-layer readers read from it."""
    import torch

    from bench import devtrace, yardstick
    from bench.reference import fl as reffl
    from repro_torch.fl import FLConfig, run_fl

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run_trace.json")
        cfg = FLConfig(**fl_kwargs(cell, seed, trace=path))
        window_us, ops = devtrace.profile_stretch(
            torch, lambda: run_fl(cfg, device=device))
        spans = devtrace.read_host_spans(path)
    rounds = cell.traffic["rounds"]
    _, plan = reffl.plan_of(cell.cfg, cell.traffic)
    # one call a round over the (N, T) rows; in the flat runtime the
    # fresh rows are w itself, so the count does not depend on the
    # round's strong set
    nbytes, flops = yardstick.fused_work(plan.num_silos, len(plan.src),
                                         yardstick.param_count(cell.cfg))
    bound_us = rounds * max(nbytes / peaks["hbm_bytes_per_s"],
                            flops / peaks["fp32_flops"]) * 1e6
    return devtrace.TraceData(
        rounds=rounds, window_us=window_us, device_ops=ops, host_spans=spans,
        host_offset_us=devtrace.align_host_spans(spans, ops),
        edge_bound_us=bound_us,
        round_flops=yardstick.round_flops(cell.cfg, plan.num_silos),
        window_round_ms=window_round_ms, peak_flops=peaks["fp32_flops"])


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run: returns the result line's object, the compared numbers
    (the largest over the window's calls) beside their limits last."""
    t_start = time.perf_counter() if t_start is None else t_start
    phases = {}
    import torch

    from bench import check
    from bench.reference import fl as reffl
    from repro_torch.fl import FLConfig, run_fl

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
    phases["imports_s"] = time.perf_counter() - t_start
    if on_card:
        from repro_torch.kernels import build
        build.load("edge_aggregate")
    phases["kernels_s"] = time.perf_counter() - t_start - sum(phases.values())
    seeds = call_seeds(seed)
    tr = cell.traffic
    # the warm-up reaches every chunk shape of the cell and an evaluation
    run_fl(FLConfig(**fl_kwargs(cell, next(seeds), rounds=tr["eval_every"])),
           device=device)
    setup_s = time.perf_counter() - t_start
    phases["warm_up_s"] = setup_s - sum(phases.values())

    results = []
    w0 = time.perf_counter()
    while not results or time.perf_counter() - w0 < seconds:
        s = next(seeds)
        results.append((s, run_fl(FLConfig(**fl_kwargs(cell, s)),
                                  device=device)))
    window_s = time.perf_counter() - w0
    rounds = tr["rounds"] * len(results)
    round_ms = window_s * 1e3 / rounds
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name() if on_card else "cpu"

    out = {"correct": False, "attempted": len(results)}
    out["failed"] = sum(not check.well_formed(r, tr["rounds"],
                                              tr["eval_every"])
                        for _, r in results)
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        from bench import devtrace, yardstick
        td = _stretch(cell, next(seeds), device, round_ms,
                      yardstick.card_peaks(kind))
        metrics = {}
        for m in cell.per_layer:
            v = load_reader(m["name"])(td)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy_us, _ = devtrace.union_busy(td.device_ops, td.window_us)
        device_info.update(busy_s=busy_us / 1e6, window_s=td.window_us / 1e6)
        out["breakdown"] = devtrace.breakdown(td)
    else:
        metrics = {"round_ms": {"value": round_ms, "unit": "ms/round"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    out["metrics"] = metrics
    out["device"] = device_info

    # the reference runs once the window is closed and the peak read
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # the reference follows the first rounds of every call of the window
    numbers = dict.fromkeys(check.NUMBERS, 0.0)
    for call_seed, res in results:
        ref = reffl.run(cell.cfg, tr, call_seed, device=device,
                        check_rounds=cell.check_rounds)
        for k, v in check.compare(res, ref, cell.check_rounds).items():
            numbers[k] = max(numbers[k], v)
    out["correct"] = bool(check.judge(numbers, cell.limits)
                          and out["failed"] == 0)
    out["setup_phases"] = phases
    # last in the line: each compared number beside its limit
    out["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                     for k in check.NUMBERS if k in cell.limits}
    return out
