"""Run one cell of the benchmark of `repro_torch` (see bench/README.md):

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Prints the compared numbers beside their
limits on standard error and, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``. Exits non-zero and prints no
result without enough CUDA devices, without the program's sources, or
if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _finite(x):
    """JSON has no infinity: a gap that could not be read is a string."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the program's sources (src/repro_torch) are missing",
              file=sys.stderr)
        return 2
    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from bench import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: modules loaded that the benchmark may not load: "
              f"{bad}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
