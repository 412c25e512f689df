"""Shared set-up of the examples' tests (`test_torch_examples*.py`): load
a port example (`examples_torch/<name>.py`) as a module, and run a
reference example (`examples/<name>.py`) as its own script in this
process."""

import importlib.util
import pathlib
import runpy
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_port(name: str):
    """The port's example ``name`` as a fresh module."""
    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(monkeypatch, name: str, *argv: str) -> None:
    """``python examples/<name>.py ARGV`` in this process."""
    path = ROOT / "examples" / f"{name}.py"
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    runpy.run_path(str(path), run_name="__main__")
