"""Train -> deploy -> serve, end to end (counterpart of `python -m
repro.serving`, DESIGN.md §18).

  python -m repro_torch.serving --network gaia --rounds 6 --loads 20,60,120

runs the whole loop on one card: federally train a reduced LM over the
network's silos with FEMNIST as the timing workload
(`launch/train.run_reduced_fl`), emitting FL checkpoints; deploy the
latest checkpoint as a regional fleet (one ServingEngine replica per
continent with silos, serving/fleet.py), its decode steps captured as
CUDA graphs on the card; then sweep open-loop offered load through the
fleet (serving/traffic.py) and print one summary row per load.
--mesh trains on the mesh-sharded whole-cycle runtime (an int D: D
shards stacked on the device; 'auto': the default process group if one
is initialised) and --lora-rank R (with --mesh) trains rank-R LoRA deltas
over a frozen base, which the fleet rebuilds to serve them.

  --bench BENCH_torch_serving.json  merge serving/ rows (the format
                               `python -m repro_torch.obs validate
                               --bench` checks)
  --trace serve_trace.json     Perfetto timeline: request spans on the
                               serving clock, one track per region
  --ckpt-dir DIR               reuse/keep checkpoints (default: a
                               temporary directory); with
                               --skip-train, serve DIR's latest
                               checkpoint without training first
  --device cpu                 train and serve on the CPU (default: the
                               card)
"""

from __future__ import annotations

import argparse
import json
import tempfile

def main(argv=None) -> int:
    # no abbreviations: the reference's --t would otherwise pass as --trace
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serving",
                                 description=__doc__, allow_abbrev=False)
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--network", default="gaia")
    ap.add_argument("--topology", default="multigraph")
    ap.add_argument("--silos", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--t", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="train on the mesh runtime: an int or 'auto'")
    ap.add_argument("--lora-rank", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
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
                    help="torch device to train and serve on (default: the "
                         "card)")
    args = ap.parse_args(argv)
    if args.skip_train and args.ckpt_dir is None:
        ap.error("--skip-train serves --ckpt-dir's latest checkpoint: give "
                 "--ckpt-dir")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="fl_serve_")
    out = {"ckpt_dir": ckpt_dir}
    if not args.skip_train:
        from repro_torch.launch.train import TrainConfig, run_reduced_fl
        mesh = args.mesh
        if mesh is not None and mesh != "auto":
            mesh = int(mesh)
        train = run_reduced_fl(TrainConfig(
            arch=args.arch, topology=args.topology, network=args.network,
            silos=args.silos, rounds=args.rounds, t=args.t,
            seed=args.seed, mesh=mesh, lora_rank=args.lora_rank,
            ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every),
            device=args.device)
        out["train"] = {k: train[k] for k in
                        ("arch", "topology", "silos", "loss_first",
                         "loss_last", "train_seconds", "ckpt_steps")}

    from repro_torch.serving.fleet import RegionalFleet
    from repro_torch.serving.traffic import TrafficConfig, sweep_loads
    fleet = RegionalFleet.from_checkpoint(
        ckpt_dir, max_slots=args.max_slots, max_seq=args.max_seq,
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
