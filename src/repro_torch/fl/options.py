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
    """mesh (silo-axis sharding), gossip (its cross-shard collective),
    metrics (an `obs.MetricsSpec` of in-cycle metrics) and trace (a trace
    file path). metrics and trace are ported; mesh and gossip are not
    (the trainer raises for ``mesh=``, and ``gossip`` is read only by the
    mesh runtime)."""

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
