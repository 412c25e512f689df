"""In-cycle metrics of the whole-cycle FL runtime (counterpart of
`repro.obs.metrics`).

A `MetricsSpec` names per-round scalars that the cycle computes on the
device beside the training step: one `(K,)` fp32 row per round, stacked
into the cycle's extra `(R, K)` output. Rows stay on the device until
the caller reads the round losses, so a metrics run adds no host sync.

The inertness contract: `metrics=None` adds no op to the cycle (the
runtime branches on the spec in Python only), so the state is bit for
bit that of a run without metrics. The taps only read the cycle's
tensors; none of them writes one.

`metric_columns` gives the canonical column order; the mesh runtime's
extra ``fabric_bytes`` column is not ported (no mesh runtime yet).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    """Which per-round scalars the cycle should record.

    grad_norm    — global l2 norm of the round's local-step gradients
                   (sum of squares over every local update and silo).
    param_norm   — global l2 norm of the post-aggregation params.
    update_norm  — l2 norm of (w_end - w_start) for the round.
    silo_loss    — per-silo mean local loss: N columns `loss/silo{i}`.
    staleness    — `stale_frac` (1 - strong-edge fraction this round)
                   and `buf_age` (mean rounds since each directed edge
                   buffer was refreshed, counted from the cycle call's
                   start).
    traffic      — `gossip_bytes`: strong-edge count x flat row bytes.
    """

    grad_norm: bool = True
    param_norm: bool = True
    update_norm: bool = True
    silo_loss: bool = True
    staleness: bool = True
    traffic: bool = True

    def __post_init__(self):
        if not (self.grad_norm or self.param_norm or self.update_norm
                or self.silo_loss or self.staleness or self.traffic):
            raise ValueError("MetricsSpec with every metric disabled "
                             "records nothing; pass metrics=None instead")

    def columns(self, num_silos: int) -> tuple[str, ...]:
        return metric_columns(self, num_silos)


def metric_columns(ms: MetricsSpec, num_silos: int) -> tuple[str, ...]:
    """Canonical column order of the `(R, K)` metrics output."""
    cols: list[str] = []
    if ms.grad_norm:
        cols.append("grad_norm")
    if ms.param_norm:
        cols.append("param_norm")
    if ms.update_norm:
        cols.append("update_norm")
    if ms.silo_loss:
        cols.extend(f"loss/silo{i}" for i in range(num_silos))
    if ms.staleness:
        cols.extend(("stale_frac", "buf_age"))
    if ms.traffic:
        cols.append("gossip_bytes")
    return tuple(cols)


def assemble_row(ms: MetricsSpec, vals: dict) -> torch.Tensor:
    """Order computed device values into the canonical `(K,)` fp32 row.

    ``vals`` holds 0-d tensors ``gsq``/``psq``/``usq`` (sums of squares;
    the square root is taken here), ``silo_loss`` (N,), ``stale_frac``,
    ``buf_age`` and ``gossip_bytes``, each only where its flag is on.
    """
    parts = []
    if ms.grad_norm:
        parts.append(torch.sqrt(vals["gsq"]).reshape(1))
    if ms.param_norm:
        parts.append(torch.sqrt(vals["psq"]).reshape(1))
    if ms.update_norm:
        parts.append(torch.sqrt(vals["usq"]).reshape(1))
    if ms.silo_loss:
        parts.append(vals["silo_loss"].reshape(-1))
    if ms.staleness:
        parts.append(vals["stale_frac"].reshape(1))
        parts.append(vals["buf_age"].reshape(1))
    if ms.traffic:
        parts.append(vals["gossip_bytes"].reshape(1))
    return torch.cat([p.to(torch.float32) for p in parts])
