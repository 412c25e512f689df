"""The traced stretch of a `--trace 1` run: one whole `run_fl` call under
`torch.profiler`, read from the profiler's raw records, beside the host
spans the program's own `TraceRecorder` wrote for the same call.

The profiler drops device records as a process ages, so its window is
padded with PAD_S of host sleep on both sides of the work. Records are
read from the raw kineto results: `key_averages` builds an event tree in
Python, seconds of host time for tens of thousands of kernels.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import time

PAD_S = 0.2
STRETCH = "bench.stretch"
#: Host spans of the program's trainer that end with a device-to-host
#: read of what the card computed: the losses of a chunk, an accuracy.
_SYNCED_SPANS = ("compile+dispatch", "dispatch", "eval")
#: How near (us) a synced span's end, moved to the profiler's clock, has
#: to lie to a device-to-host copy's end.
_ALIGN_TOL_US = 1000.0


@dataclasses.dataclass
class TraceData:
    """What the per-layer readers read. Times in microseconds on the
    profiler's clock, from the start of the traced stretch."""

    rounds: int              # FL rounds the stretch ran
    window_us: float         # length of the stretch
    device_ops: list         # (name, start, end) of every device record
    host_spans: list         # (name, start, end) of the recorder's spans,
    #                          on the recorder's clock (us from its epoch)
    host_offset_us: float | None  # recorder clock -> stretch clock
    edge_bound_us: float     # least time of the stretch's fused
    #                          refresh-and-aggregate calls on this card
    round_flops: int         # model FLOPs of one round
    window_round_ms: float   # round_ms of the same run's timed window
    peak_flops: float        # the card's fp32 FLOP/s

    @property
    def kernels(self) -> list:
        return [op for op in self.device_ops if not is_memop(op[0])]


def is_memop(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _records(prof, device_type):
    """(name, start_us, end_us) of the profile's records of
    ``device_type`` that `key_averages` would count."""
    from torch.autograd.profiler_util import _filter_name

    results = prof.profiler.kineto_results
    zero = results.trace_start_ns()
    for ev in results.events():
        if (ev.device_type() != device_type or _filter_name(ev.name())
                or getattr(ev, "is_hidden_event", lambda: False)()
                or ev.is_async()
                or ev.start_thread_id() != ev.end_thread_id()):
            continue
        yield ev.name(), (ev.start_ns() - zero) / 1e3, \
            (ev.end_ns() - zero) / 1e3


def profile_stretch(torch, fn):
    """Run ``fn()`` under the profiler; returns the stretch's length, from
    its start to the end of its last device record, and those records,
    in us from its start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        with record_function(STRETCH):
            fn()
            torch.cuda.synchronize()
        time.sleep(PAD_S)
    marks = [(s, e) for name, s, e in _records(prof, DeviceType.CPU)
             if name == STRETCH]
    if len(marks) != 1:
        raise RuntimeError(f"the profile holds {len(marks)} records of the "
                           "traced stretch, not one")
    w0, w1 = marks[0]
    # the stretch's own range shows on the device's timeline too
    ops = sorted(((name, max(s, w0) - w0, min(e, w1) - w0)
                  for name, s, e in _records(prof, DeviceType.CUDA)
                  if e > w0 and s < w1 and name != STRETCH),
                 key=lambda op: op[1])
    # the stretch ends with the run's last device record: what the host
    # does after it (the report, and the trace file that only a traced
    # call writes) leaves the card idle in no run but this one
    end = max((e for _, _, e in ops), default=w1 - w0)
    return end, ops


def read_host_spans(path) -> list:
    """(name, start_us, end_us) of the host spans in a trace JSON that
    the program's `TraceRecorder` wrote."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "host"),
                  key=lambda s: s[1])


def align_host_spans(host_spans, device_ops) -> float | None:
    """Offset from the recorder's clock to the stretch's. Each synced
    host span ends right after the device-to-host copy of what it waited
    for, and the run's last copy is its last evaluation's: that pair
    gives the offset, which holds where nearly every other synced span
    also ends within _ALIGN_TOL_US of a copy. None otherwise."""
    ends = [e for name, _, e in host_spans if name in _SYNCED_SPANS]
    copies = sorted(e for name, _, e in device_ops
                    if name.startswith("Memcpy DtoH"))
    if not ends or not copies:
        return None
    off = copies[-1] - ends[-1]
    hits = 0
    for e in ends:
        i = bisect.bisect_left(copies, e + off - _ALIGN_TOL_US)
        hits += i < len(copies) and copies[i] <= e + off + _ALIGN_TOL_US
    return off if hits >= 0.8 * len(ends) else None


def union_busy(ops, window_us: float) -> tuple[float, list]:
    """(busy us, idle gaps [(start, end)]) of the device over the
    stretch: the union of the records' intervals, each overlap counted
    once."""
    busy, gaps, cur = 0.0, [], 0.0
    for _, s, e in sorted(ops, key=lambda op: op[1]):
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            busy += e - s
        else:
            busy += e - cur
        cur = e
    if cur < window_us:
        gaps.append((cur, window_us))
    return busy, gaps


def host_label(t_us: float, host_spans, offset: float | None) -> str:
    """What the host was doing at stretch time ``t_us``, by the
    recorder's spans."""
    if offset is None:
        return "unattributed"
    t = t_us - offset
    for name, s, e in host_spans:
        if s <= t <= e:
            return name
    if not host_spans or t < host_spans[0][1]:
        return "run set-up (data, plan, init)"
    if t > host_spans[-1][2]:
        return "run end (report, trace file)"
    return "between spans (sampling, staging)"


def breakdown(td: TraceData, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each named by what the host was doing; seconds."""
    by_name: dict = {}
    for name, s, e in td.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    _, gaps = union_busy(td.device_ops, td.window_us)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[name[:200], s] for name, s in ops],
            "idle_gaps": [[host_label((a + b) / 2, td.host_spans,
                                      td.host_offset_us), (b - a) / 1e6]
                          for a, b in gaps]}
