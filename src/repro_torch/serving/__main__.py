"""Serve an FL checkpoint, end to end (counterpart of `python -m
repro.serving`, DESIGN.md §18).

  python -m repro_torch.serving --skip-train --ckpt-dir DIR --loads 20,60,120

deploys DIR's latest FL checkpoint as a regional fleet (one
ServingEngine replica per continent with silos, serving/fleet.py), its
decode steps captured as CUDA graphs on the card, then sweeps open-loop
offered load through the fleet (serving/traffic.py) and prints one
summary row per load. Training first (the reference's default, through
`launch/train.run_reduced_fl`) waits for the port of launch/train.py
(ROADMAP queue 1 #7): without --skip-train, or with --mesh or
--lora-rank, the command refuses before anything runs, and the
reference's training flags (--arch, --network, --topology, --silos,
--rounds, --t, --ckpt-every) come with that port: argparse rejects them.

  --bench BENCH_torch_serving.json  merge serving/ rows (the format
                               `python -m repro_torch.obs validate
                               --bench` checks)
  --trace serve_trace.json     Perfetto timeline: request spans on the
                               serving clock, one track per region
  --device cpu                 run the engines on the CPU (default: the
                               card)
"""

from __future__ import annotations

import argparse
import json

_TRAINING = ("training before serving needs launch/train.py, which is not "
             "ported yet (ROADMAP queue 1 #7)")


def main(argv=None) -> int:
    # no abbreviations: the reference's --t would otherwise pass as --trace
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serving",
                                 description=__doc__, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="train on the mesh runtime: an int or 'auto'")
    ap.add_argument("--lora-rank", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--skip-train", action="store_true",
                    help="serve --ckpt-dir's latest checkpoint as-is")
    ap.add_argument("--loads", default="20,60,120",
                    help="offered req/s sweep, comma-separated")
    ap.add_argument("--duration-ms", type=float, default=1_000.0)
    ap.add_argument("--step-ms", type=float, default=10.0)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--bench", default=None, metavar="BENCH.json")
    ap.add_argument("--trace", default=None, metavar="OUT.json")
    ap.add_argument("--device", default=None,
                    help="torch device of the engines (default: the card)")
    args = ap.parse_args(argv)
    if not args.skip_train:
        ap.error(f"{_TRAINING}; serve an existing checkpoint with "
                 "--skip-train --ckpt-dir DIR")
    if args.mesh is not None or args.lora_rank:
        ap.error(f"--mesh and --lora-rank train: {_TRAINING}")
    if args.ckpt_dir is None:
        ap.error("--skip-train serves --ckpt-dir's latest checkpoint: give "
                 "--ckpt-dir")

    from repro_torch.serving.fleet import RegionalFleet
    from repro_torch.serving.traffic import TrafficConfig, sweep_loads
    out = {"ckpt_dir": args.ckpt_dir}
    fleet = RegionalFleet.from_checkpoint(
        args.ckpt_dir, max_slots=args.max_slots, max_seq=args.max_seq,
        device=args.device)
    out["regions"] = {r: v.silo_indices
                      for r, v in fleet.regions.items()}
    out["ckpt_step"] = fleet.ckpt.step

    recorder = None
    if args.trace:
        from repro_torch.obs import TraceRecorder
        recorder = TraceRecorder()
        recorder.meta.update(arch=fleet.meta["arch"],
                             network=fleet.meta["network"],
                             ckpt_step=fleet.ckpt.step,
                             regions=list(fleet.regions))
    cfg = TrafficConfig(seed=args.seed, duration_ms=args.duration_ms,
                        step_ms=args.step_ms)
    loads = [float(x) for x in args.loads.split(",") if x]
    results = sweep_loads(fleet, cfg, loads, recorder=recorder)
    out["serve"] = [r.summary for r in results]

    if args.trace:
        from repro_torch.obs import write_trace
        write_trace(args.trace, recorder)
        out["trace"] = args.trace
    if args.bench:
        from repro_torch.serving.traffic import bench_rows, write_bench_json
        write_bench_json(bench_rows(results, fleet), path=args.bench)
        out["bench"] = args.bench
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
