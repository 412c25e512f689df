"""Dotted-override config system for the package's dataclass configs
(counterpart of `repro.config_cli`).

    cfg = apply_overrides(FLConfig(), ["lr=0.1", "topology=ring"])
    cfg = apply_overrides(get_config("yi-9b"), ["num_layers=2"])

Values are parsed against the dataclass field's declared type (bool
accepts true/false/1/0; Optional unwrapped, in both the ``Optional[X]``
and the ``X | None`` spelling; tuples split on ','). Also provides
save/load of full configs as JSON for experiment reproducibility.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import types
import typing
from typing import Any, Sequence


class OverrideError(ValueError):
    pass


def _parse_bool(s: str) -> bool:
    if s.lower() in ("1", "true", "yes", "on"):
        return True
    if s.lower() in ("0", "false", "no", "off"):
        return False
    raise OverrideError(f"not a bool: {s!r}")


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    # The reference checks `typing.Union` alone, so it cannot coerce a
    # field annotated ``X | None`` (FLConfig's trace, multiplicity, ...).
    if origin in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(value: str, tp) -> Any:
    tp = _unwrap_optional(tp)
    if tp is bool:
        return _parse_bool(value)
    if tp is int:
        return int(value)
    if tp is float:
        return float(value)
    if tp is str or tp is Any:
        return value
    origin = typing.get_origin(tp)
    if origin in (tuple, list):
        inner = (typing.get_args(tp) or (str,))[0]
        items = [_coerce(v, inner) for v in value.split(",") if v]
        return tuple(items) if origin is tuple else items
    if isinstance(tp, type) and issubclass(tp, str):  # Literal-ish
        return value
    # typing.Literal
    if typing.get_origin(tp) is typing.Literal:
        allowed = typing.get_args(tp)
        if value not in allowed:
            raise OverrideError(f"{value!r} not in {allowed}")
        return value
    raise OverrideError(f"cannot coerce {value!r} to {tp}")


def _field_types(cfg) -> dict:
    hints = typing.get_type_hints(type(cfg))
    return {f.name: hints.get(f.name, Any)
            for f in dataclasses.fields(cfg)}


def apply_overrides(cfg, overrides: Sequence[str]):
    """Return a new dataclass with `key=value` overrides applied.

    Unknown keys raise with the list of valid field names.
    """
    if not dataclasses.is_dataclass(cfg):
        raise OverrideError(f"{type(cfg).__name__} is not a dataclass")
    types = _field_types(cfg)
    updates: dict = {}
    for item in overrides:
        if "=" not in item:
            raise OverrideError(f"override {item!r} must be key=value")
        key, value = item.split("=", 1)
        key = key.strip()
        if key not in types:
            raise OverrideError(
                f"unknown field {key!r} for {type(cfg).__name__}; "
                f"valid: {sorted(types)}")
        updates[key] = _coerce(value.strip(), types[key])
    return dataclasses.replace(cfg, **updates)


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=1, default=str)


def save(cfg, path) -> None:
    pathlib.Path(path).write_text(to_json(cfg))


def load(cls, path):
    data = json.loads(pathlib.Path(path).read_text())
    hints = typing.get_type_hints(cls)
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in data.items():
        if k not in fields:
            continue
        tp = _unwrap_optional(hints.get(k, Any))
        if typing.get_origin(tp) is tuple and isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return cls(**kw)
