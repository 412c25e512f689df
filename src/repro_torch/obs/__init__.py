"""Observability of the FL stack (counterpart of `repro.obs`).

  * `obs.metrics` — `MetricsSpec`: per-round scalars the whole-cycle
    runtime computes on the device, one extra `(R, K)` cycle output;
    `metrics=None` leaves the cycle unchanged.
  * `obs.trace`   — `TraceRecorder`: simulated time from the
    `TimingPlan`, host wall clock around dispatch/eval/checkpoint, and
    controller instants, in one ordered event log keyed on (round, silo).
  * `obs.export`  — Chrome/Perfetto `trace_event` JSON and a JSONL
    run-record.
"""

from repro_torch.obs.metrics import MetricsSpec, assemble_row, metric_columns
from repro_torch.obs.trace import TraceRecorder
from repro_torch.obs.export import (to_trace_json, validate_trace,
                                    write_trace, write_run_record,
                                    load_run_record)

__all__ = [
    "MetricsSpec", "assemble_row", "metric_columns", "TraceRecorder",
    "to_trace_json", "validate_trace", "write_trace",
    "write_run_record", "load_run_record",
]
