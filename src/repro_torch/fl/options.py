"""Shared runtime options of the FL entry points (counterpart of
`repro.fl.options`).

`FLConfig` embeds one `RuntimeOptions` value and also keeps the four
legacy keyword fields (``mesh``, ``gossip``, ``metrics``, ``trace``).
`adopt_runtime_options` reconciles the two views: an explicitly set
legacy field wins over the embedded object's value, then ``options`` is
rebuilt so that both agree.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RuntimeOptions:
    """Runtime knobs shared by trainer / controller / launch configs.

    mesh    -- silo sharding for the flat runtime (fl/mesh.py): None =
               one device (the oracle); an int D = D shards stacked in
               this process on the run's device (`StackedShards`);
               "auto" = one shard per rank of the default
               `torch.distributed` group when one is initialised
               (`GroupShards`: gloo on the CPU, NCCL across cards), else
               one stacked shard; or a shard-axis object, used as is.
    gossip  -- the mesh runtime's cross-shard source-row collective:
               "halo" (boundary exchange) or "all_gather" (baseline).
    metrics -- an `obs.MetricsSpec` computed inside the cycle; None = off.
    trace   -- path for a Perfetto trace-event JSON of the run; None =
               off.
    """

    mesh: object = None
    gossip: str = "halo"
    metrics: object = None
    trace: str | None = None


_DEFAULTS = RuntimeOptions()
_FIELDS = tuple(f.name for f in dataclasses.fields(RuntimeOptions))


def adopt_runtime_options(cfg) -> None:
    """Reconcile a config's legacy runtime fields with its embedded
    ``options``; call from ``__post_init__``."""
    if cfg.options is not None:
        if isinstance(cfg.options, dict):
            # a JSON round trip (`config_cli.load`): `dataclasses.asdict`
            # flattened the embedded options into a mapping
            object.__setattr__(cfg, "options",
                               RuntimeOptions(**cfg.options))
        if not isinstance(cfg.options, RuntimeOptions):
            raise TypeError(f"options must be a RuntimeOptions, got "
                            f"{type(cfg.options).__name__}")
        for name in _FIELDS:
            if getattr(cfg, name) == getattr(_DEFAULTS, name):
                object.__setattr__(cfg, name, getattr(cfg.options, name))
    object.__setattr__(cfg, "options", RuntimeOptions(
        **{n: getattr(cfg, n) for n in _FIELDS}))
