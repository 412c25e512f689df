"""Observability CLI (counterpart of `python -m repro.obs`, DESIGN.md
§17).

  python -m repro_torch.obs trace --network gaia --rounds 24 --out run.json
      Build the simulated silo timeline for a topology on a network
      (optionally replayed through a fault scenario) and write Perfetto
      trace-event JSON — no training, pure timing replay on the host.

  python -m repro_torch.obs convert run.jsonl run.json
      JSONL run-record -> trace JSON.

  python -m repro_torch.obs validate run.json ... [--bench BENCH.json ...]
      Schema-check trace files and/or BENCH_*.json benchmark tables;
      exits non-zero listing every problem.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.export import (load_run_record, validate_trace,
                                    write_trace, write_run_record)
from repro_torch.obs.trace import TraceRecorder


def _cmd_trace(args) -> int:
    from repro_torch.core.delay import WORKLOADS
    from repro_torch.core.timing import make_timing_plan
    from repro_torch.networks.registry import get_network

    net = get_network(args.network)
    wl = WORKLOADS[args.workload]
    tplan = make_timing_plan(args.topology, net, wl, t=args.t,
                             seed=args.seed)
    rec = TraceRecorder()
    rec.meta.update(network=net.name, topology=args.topology,
                    workload=wl.name, rounds=args.rounds, t=args.t,
                    seed=args.seed, scenario=args.scenario)
    if args.scenario:
        from repro_torch.faults import FaultedSession, get_scenario
        sess = FaultedSession(tplan, get_scenario(args.scenario).schedule,
                              record_obs=True)
        seg = sess.advance(args.rounds)
        end = rec.add_faulted_spans(tplan.pair_i, tplan.pair_j, seg)
    else:
        end = rec.add_sim_spans(tplan, args.rounds)
    write_trace(args.out, rec)
    if args.jsonl:
        write_run_record(args.jsonl, rec)
    print(json.dumps({"out": args.out, "rounds": args.rounds,
                      "silos": net.num_silos,
                      "sim_end_ms": round(end, 3),
                      "events": len(rec.sim_events)}))
    return 0


def _cmd_convert(args) -> int:
    rec = load_run_record(args.jsonl)
    write_trace(args.out, rec)
    print(json.dumps({"out": args.out, "events": len(rec.sim_events)
                      + len(rec.host_events) + len(rec.ctrl_events)
                      + len(rec.counter_events)}))
    return 0


def validate_bench_rows(rows) -> list[str]:
    """Schema check for a BENCH_*.json table (the benchmarks/ merge
    format): a list of rows each carrying a ``name`` string and a
    numeric ``us_per_call``. Rows MAY carry a numeric ``ts`` stamp;
    every stamped row must be monotone
    non-decreasing in file order — unstamped legacy rows are skipped
    by the monotonicity walk, not failed."""
    errs: list[str] = []
    if not isinstance(rows, list):
        return ["top level must be a JSON list of benchmark rows"]
    last_ts = float("-inf")
    for k, r in enumerate(rows):
        where = f"row[{k}]"
        if not isinstance(r, dict):
            errs.append(f"{where}: not an object")
            continue
        name = r.get("name")
        if not isinstance(name, str) or not name:
            errs.append(f"{where}: missing/empty name")
        us = r.get("us_per_call")
        if not isinstance(us, (int, float)) or isinstance(us, bool):
            errs.append(f"{where} ({name!r}): us_per_call not numeric: "
                        f"{us!r}")
        ts = r.get("ts")
        if ts is not None:
            if not isinstance(ts, (int, float)) or isinstance(ts, bool):
                errs.append(f"{where} ({name!r}): ts not numeric: {ts!r}")
            elif ts < last_ts:
                errs.append(f"{where} ({name!r}): ts {ts} decreases "
                            f"(prev {last_ts})")
            else:
                last_ts = float(ts)
    return errs


def _cmd_validate(args) -> int:
    problems = 0
    for path in args.files:
        try:
            with open(path) as f:
                obj = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{path}: unreadable: {e}", file=sys.stderr)
            problems += 1
            continue
        errs = validate_trace(obj)
        for e in errs:
            print(f"{path}: {e}", file=sys.stderr)
        problems += len(errs)
        if not errs:
            print(f"{path}: OK ({len(obj['traceEvents'])} events)")
    for path in args.bench:
        try:
            with open(path) as f:
                rows = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{path}: unreadable: {e}", file=sys.stderr)
            problems += 1
            continue
        errs = validate_bench_rows(rows)
        for e in errs:
            print(f"{path}: {e}", file=sys.stderr)
        problems += len(errs)
        if not errs:
            print(f"{path}: OK ({len(rows)} rows)")
    return 1 if problems else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("trace", help="simulated timeline -> trace JSON")
    tr.add_argument("--network", default="gaia")
    tr.add_argument("--topology", default="multigraph")
    tr.add_argument("--workload", default="femnist")
    tr.add_argument("--rounds", type=int, default=24)
    tr.add_argument("--t", type=int, default=5)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--scenario", default=None,
                    help="replay through a fault scenario "
                         "(faults.SCENARIOS name)")
    tr.add_argument("--out", required=True, metavar="OUT.json")
    tr.add_argument("--jsonl", default=None, metavar="OUT.jsonl",
                    help="also write the JSONL run-record")
    tr.set_defaults(fn=_cmd_trace)

    cv = sub.add_parser("convert", help="JSONL run-record -> trace JSON")
    cv.add_argument("jsonl")
    cv.add_argument("out")
    cv.set_defaults(fn=_cmd_convert)

    va = sub.add_parser("validate",
                        help="schema-check trace / BENCH json files")
    va.add_argument("files", nargs="*", metavar="TRACE.json")
    va.add_argument("--bench", nargs="*", default=[],
                    metavar="BENCH.json",
                    help="benchmark tables to check (name + numeric "
                         "us_per_call per row; stamped rows monotone)")
    va.set_defaults(fn=_cmd_validate)

    args = ap.parse_args(argv)
    if args.cmd == "validate" and not args.files and not args.bench:
        ap.error("validate: give trace files and/or --bench files")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
