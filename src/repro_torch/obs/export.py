"""Perfetto/Chrome `trace_event` export + JSONL run-record.

The Chrome trace-event format (also what Perfetto's legacy importer
reads) is a JSON object `{"traceEvents": [...]}` where each event has
a phase `ph`: "X" complete spans (ts/dur, microseconds), "C" counters,
"i" instants, "M" metadata. Tracks are (pid, tid) pairs; we lay out

  pid 1  "simulated"   — one thread per silo (tid = silo), counter
                         tracks from the in-scan metrics
  pid 2  "host"        — wall-clock compile/dispatch/eval spans
  pid 3  "controller"  — observe/replan/swap instants
  pid 4  "serving"     — request lifetimes, one thread per region
                         (only present when the fleet recorded any)

`validate_trace` enforces the subset we emit (well-formed phases,
non-negative durations, per-track monotone timestamps); `write_trace`
runs it before it writes a file.
"""

from __future__ import annotations

import json
from typing import Any

SIM_PID = 1
HOST_PID = 2
CTRL_PID = 3
SERVE_PID = 4


def _meta(pid: int, name: str, sort: int) -> list[dict]:
    return [
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": {"name": name}},
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_sort_index",
         "args": {"sort_index": sort}},
    ]


def to_trace_json(rec, *, extra_meta: dict | None = None) -> dict:
    """TraceRecorder -> Chrome/Perfetto trace-event JSON object.

    Simulated/controller events keep their millisecond clocks scaled
    to trace microseconds; host events land on their own process so
    the two clocks never interleave on one track.
    """
    ev: list[dict] = []
    ev += _meta(SIM_PID, "simulated", 0)
    ev += _meta(HOST_PID, "host", 1)
    ev += _meta(CTRL_PID, "controller", 2)
    if rec.serve_events:
        ev += _meta(SERVE_PID, "serving", 3)
        regions = sorted({e["region"] for e in rec.serve_events})
        tid_of = {r: i + 1 for i, r in enumerate(regions)}
        for r, tid in tid_of.items():
            ev.append({"ph": "M", "pid": SERVE_PID, "tid": tid,
                       "name": "thread_name", "args": {"name": r}})
        for e in rec.serve_events:
            ev.append({"ph": "X", "pid": SERVE_PID,
                       "tid": tid_of[e["region"]],
                       "name": e["name"], "cat": "serve",
                       "ts": e["t0_ms"] * 1e3, "dur": e["dur_ms"] * 1e3,
                       "args": {"region": e["region"], **e["args"]}})

    silos = sorted({e["silo"] for e in rec.sim_events})
    for i in silos:
        ev.append({"ph": "M", "pid": SIM_PID, "tid": int(i) + 1,
                   "name": "thread_name", "args": {"name": f"silo{i}"}})

    for e in rec.sim_events:
        ev.append({"ph": "X", "pid": SIM_PID, "tid": int(e["silo"]) + 1,
                   "name": e["name"], "cat": "sim",
                   "ts": e["t0_ms"] * 1e3, "dur": e["dur_ms"] * 1e3,
                   "args": {"round": e["round"], **e["args"]}})
    for e in rec.counter_events:
        ev.append({"ph": "C", "pid": SIM_PID, "tid": 0,
                   "name": e["name"], "ts": e["t_ms"] * 1e3,
                   "args": {"value": e["value"]}})
    for e in rec.host_events:
        ev.append({"ph": "X", "pid": HOST_PID, "tid": 1,
                   "name": e["name"], "cat": "host",
                   "ts": e["t0_ms"] * 1e3, "dur": e["dur_ms"] * 1e3,
                   "args": dict(e["args"])})
    for e in rec.ctrl_events:
        ev.append({"ph": "i", "pid": CTRL_PID, "tid": 1,
                   "name": e["name"], "cat": "ctrl", "s": "p",
                   "ts": e["t_ms"] * 1e3,
                   "args": {"round": e["round"], **e["args"]}})

    # Perfetto tolerates any order, but monotone per track keeps the
    # validate contract simple and diffs stable
    def key(e):
        return (e["pid"], e.get("tid", 0), 0 if e["ph"] == "M" else 1,
                e.get("ts", -1.0))
    ev.sort(key=key)
    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": dict(rec.meta, **(extra_meta or {}))}


def validate_trace(obj: Any) -> list[str]:
    """Schema check for the subset of trace-event JSON we emit.

    Returns a list of human-readable problems (empty = valid):
    structure, known phases, required per-phase fields, non-negative
    ts/dur, numeric counter values, and monotone non-decreasing
    timestamps within each (pid, tid) track.
    """
    errs: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a traceEvents list"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents must be a list"]
    last_ts: dict[tuple, float] = {}
    for k, e in enumerate(evs):
        where = f"traceEvents[{k}]"
        if not isinstance(e, dict) or "ph" not in e:
            errs.append(f"{where}: not an event object with ph")
            continue
        ph = e["ph"]
        if ph not in ("X", "C", "i", "M"):
            errs.append(f"{where}: unknown phase {ph!r}")
            continue
        if "name" not in e or "pid" not in e:
            errs.append(f"{where}: missing name/pid")
            continue
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where}: bad ts {ts!r}")
            continue
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: X event with bad dur {dur!r}")
        if ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                errs.append(f"{where}: C event args must be numeric")
        if ph == "i" and e.get("s") not in ("g", "p", "t", None):
            errs.append(f"{where}: i event bad scope {e.get('s')!r}")
        track = (e["pid"], e.get("tid", 0), ph == "C")
        if ts < last_ts.get(track, float("-inf")):
            errs.append(f"{where}: ts {ts} not monotone on track {track}")
        last_ts[track] = ts
    return errs


def write_trace(path, rec, *, extra_meta: dict | None = None) -> dict:
    """Validate-then-write the trace JSON; returns the object."""
    obj = to_trace_json(rec, extra_meta=extra_meta)
    errs = validate_trace(obj)
    if errs:
        raise ValueError("refusing to write invalid trace:\n  " +
                         "\n  ".join(errs[:10]))
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


# ---------------------------------------------------------------------------
# JSONL run-record: one event per line, replayable into a recorder
# ---------------------------------------------------------------------------

_KINDS = ("sim", "host", "ctrl", "counter", "serve", "meta")


def run_record_rows(rec) -> list[dict]:
    rows = [{"kind": "meta", **rec.meta}] if rec.meta else []
    rows += [{"kind": "sim", **e} for e in rec.sim_events]
    rows += [{"kind": "counter", **e} for e in rec.counter_events]
    rows += [{"kind": "ctrl", **e} for e in rec.ctrl_events]
    rows += [{"kind": "host", **e} for e in rec.host_events]
    rows += [{"kind": "serve", **e} for e in rec.serve_events]
    return rows


def write_run_record(path, rec) -> int:
    """JSONL run-record, one event per line (`load_run_record` reads it
    back); returns the row count."""
    rows = run_record_rows(rec)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return len(rows)


def load_run_record(path):
    """JSONL -> TraceRecorder (inverse of `write_run_record`)."""
    from repro_torch.obs.trace import TraceRecorder
    rec = TraceRecorder()
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            kind = row.pop("kind", None)
            if kind not in _KINDS:
                raise ValueError(f"{path}:{line_no}: unknown kind {kind!r}")
            row.pop("clock", None)
            if kind == "meta":
                rec.meta.update(row)
            elif kind == "sim":
                rec.sim_events.append({"clock": "sim", **row})
            elif kind == "counter":
                rec.counter_events.append({"clock": "sim", **row})
            elif kind == "ctrl":
                rec.ctrl_events.append({"clock": "ctrl", **row})
            elif kind == "serve":
                rec.serve_events.append({"clock": "serve", **row})
            else:
                rec.host_events.append({"clock": "host", **row})
    return rec
