"""What the benchmark loads and reads: no JAX and no JAX package in a
run, nothing of the program in the reference, nothing read from the JAX
package's benchmarks."""

import ast
import json
import subprocess
import sys

from bench import harness

BENCH = harness.BENCH
ROOT = harness.ROOT


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program():
    files = list((BENCH / "reference").glob("*.py")) + \
        list((BENCH / "configs").glob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in ("repro_torch", "repro", "jax",
                                             "jaxlib", "flax"), (f, mod)
    got = _run(
        "import sys, json; sys.path[:0] = ['.', 'bench/tests']\n"
        "from bench.reference import fl\n"
        "from _small import small_cell\n"
        "cell = small_cell(rounds=1, batch=2)\n"
        "fl.run(cell.cfg, cell.traffic, 1, device='cpu', check_rounds=1)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(got) & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    got = _run(
        "import sys, json; sys.path[:0] = ['.', 'src', 'bench/tests']\n"
        "from bench import harness\n"
        "from _small import small_cell\n"
        "out = harness.run_cell(small_cell(rounds=2), 5, 0.0, False, "
        "device='cpu')\n"
        "print(json.dumps([out['correct'], harness.forbidden_modules(), "
        "'repro_torch' in sys.modules]))")
    assert got == [True, [], True]


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("repro_torch_lookalike", sys)
    try:
        assert "repro_torch_lookalike" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike"]


def test_nothing_reads_the_jax_benchmarks():
    for f in BENCH.rglob("*.py"):
        if f.name.startswith("test_bench_isolation"):
            continue
        text = f.read_text()
        assert "benchmarks/" not in text and "BENCH_" not in text, f
