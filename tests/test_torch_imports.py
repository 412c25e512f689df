"""Import hygiene of the PyTorch port: `repro_torch`, its examples
(`examples_torch/`) and `chip_smoke.py` import neither jax, networkx,
the reference package `repro`, msgpack nor ml_dtypes (the card's machine
has none of them)."""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "networkx", "repro", "msgpack", "ml_dtypes")


def test_package_imports_nothing_forbidden():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module was imported


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_nothing_forbidden():
    roots = _imported_roots(ROOT / "chip_smoke.py")
    assert "repro_torch" in roots
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)


def test_package_sources_import_nothing_forbidden():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, (path, bad)


EXAMPLES = ("topology_comparison", "quickstart", "serve_decode",
            "continuous_batching", "fl_llm_finetune")


def test_example_sources_import_nothing_forbidden():
    paths = sorted((ROOT / "examples_torch").glob("*.py"))
    assert {p.stem for p in paths} == set(EXAMPLES)
    for path in paths:
        roots = _imported_roots(path)
        assert "repro_torch" in roots, path
        bad = roots & set(FORBIDDEN)
        assert not bad, (path, bad)


def test_examples_import_nothing_forbidden():
    """Each example, loaded as a module the way the smoke loads it,
    brings in none of the forbidden packages."""
    code = (
        "import importlib.util, sys\n"
        f"for name in {EXAMPLES!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'examples_torch/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_mesh_and_lora_import_nothing_forbidden():
    """The mesh runtime, its shard axis and the LoRA deltas import alone
    without any of the forbidden packages."""
    code = (
        "import sys\n"
        "import repro_torch.fl.mesh, repro_torch.fl.lora\n"
        "import repro_torch.launch.mesh\n"
        "from repro_torch.fl import make_mesh_runtime, make_lora_adapter\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_launch_analysis_imports_nothing_forbidden():
    """The launch analysis tools (specs, roofline, dry run, perf variants)
    import alone without any of the forbidden packages."""
    code = (
        "import sys\n"
        "import repro_torch.launch.specs, repro_torch.launch.roofline\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.perf\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sharded_program_imports_nothing_forbidden():
    """The sharded LLM program (sharding rules, activation anchors, the
    collective counter, the production meshes, the topology shim) imports
    alone without any of the forbidden packages, and importing the whole
    package starts no process group nor loads the fake backend."""
    code = (
        "import sys\n"
        "import torch.distributed as dist\n"
        "import importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.launch.sharding, repro_torch.launch.hlo_analysis\n"
        "import repro_torch.models.shard_ctx, repro_torch.core.topology\n"
        "from repro_torch.launch.mesh import fake_world, make_production_mesh\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "assert not dist.is_initialized()\n"
        "assert 'torch.testing._internal.distributed.fake_pg' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
