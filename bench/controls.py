"""Readings that the limits of `correct` are set from, at a cell's own
size on the card (not part of a benchmark run):

    python3 bench/controls.py --workload NAME --seeds 1 2 3 \
        [--modes sound tf32 tf32_backward unchanged half_batch \
         no_exchange altered refresh_all]

For each seed, the plain reference runs the cell's config once in fp32,
and each mode is compared with it by `check.compare`, as a run compares
its checked call: ``sound`` is the program as it is (the lower
readings), ``tf32`` and ``tf32_backward`` the reference computed in TF32
throughout or in its backward pass alone (the precision controls,
`reference.fl.PRECISIONS`), and the others the program with a fault of
`faults.py` planted. Prints one JSON line per seed and mode, with the relative loss
gap of every round the reference followed (``--rounds``).
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--modes", nargs="+", default=["sound", "tf32"])
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds the reference follows (default: the "
                    "cell's check_rounds)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from bench import check, faults, harness
    from bench.reference import fl as reffl
    from repro_torch.fl import FLConfig, run_fl

    cell = harness.load_cell(args.workload)
    if args.rounds:
        cell.check_rounds = args.rounds
    from repro_torch.kernels import build
    build.load("edge_aggregate")
    for seed in args.seeds:
        t0 = time.perf_counter()
        ref = reffl.run(cell.cfg, cell.traffic, seed, device="cuda",
                        check_rounds=cell.check_rounds)
        ref_s = time.perf_counter() - t0
        for mode in args.modes:
            t0 = time.perf_counter()
            if mode in reffl.PRECISIONS:
                res = reffl.run(cell.cfg, cell.traffic, seed,
                                device="cuda",
                                check_rounds=cell.check_rounds,
                                precision=mode)
            else:
                cfg = FLConfig(**harness.fl_kwargs(cell, seed))
                if mode == "sound":
                    res = run_fl(cfg, device="cuda")
                else:
                    with faults.planted(mode):
                        res = run_fl(cfg, device="cuda")
            numbers = check.compare(res, ref, cell.check_rounds)
            gaps = [abs(a - b) / abs(b) for a, b in
                    zip(res.round_losses, ref.round_losses)]
            print(json.dumps({
                "workload": args.workload, "seed": seed, "mode": mode,
                **{k: (v if math.isfinite(v) else str(v))
                   for k, v in numbers.items()},
                "round_gaps": gaps,
                "correct": check.judge(numbers, cell.limits),
                "ref_s": ref_s, "mode_s": time.perf_counter() - t0}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
