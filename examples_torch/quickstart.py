"""Quickstart: build the multigraph, parse its states, and see why it is
faster — isolated nodes skip the blocking aggregation (the PyTorch
port's copy of `examples/quickstart.py`).

Sections 1-6 run on the host (numpy). Section 7 trains a reduced LM
federally and serves it, on the card unless ``--device`` names another
device; without a card and without ``--device`` the script raises.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse
import functools
import operator
import os
import tempfile

from repro_torch.core import parsing
from repro_torch.core.delay import FEMNIST, MultigraphDelayTracker
from repro_torch.core.multigraph import build_multigraph
from repro_torch.core.simulator import simulate
from repro_torch.core.topology import ring_topology
from repro_torch.device import resolve_device
from repro_torch.networks.zoo import get_network

#: Section 6 writes its trace here, under the temporary directory.
TRACE_NAME = "quickstart_trace.json"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of section 7 (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    net = get_network("gaia")
    print(f"network: {net.name} with {net.num_silos} silos\n")

    # 1. the overlay (Christofides ring, as in RING [58])
    overlay = ring_topology(net, FEMNIST).graph
    print(f"overlay: ring with {overlay.num_pairs} pairs")

    # 2. Algorithm 1: multigraph (long-delay pairs get more weak edges)
    mg = build_multigraph(net, FEMNIST, overlay, t=5)
    print("edge multiplicities:", sorted(mg.multiplicity.values()))

    # 3. Algorithm 2: parse into states; find the isolated nodes
    states = parsing.parse_multigraph(mg)
    print(f"parsed into {len(states)} states; "
          f"{sum(s.has_isolated() for s in states)} contain isolated nodes")

    # 4. cycle time per round (Eq. 4/5) — the vectorized TimingPlan is
    # what the simulator/trainer/sweep use; the dict tracker is its
    # bit-for-bit equivalence oracle.
    from repro_torch.core.timing import multigraph_timing_plan
    plan = multigraph_timing_plan(net, FEMNIST, t=5, overlay=overlay)
    taus = plan.cycle_times(12)
    tracker = MultigraphDelayTracker(net=net, wl=FEMNIST, overlay=overlay)
    print("\nround | isolated nodes | cycle time (ms)")
    for k, st in parsing.state_schedule(states, 12):
        tau = tracker.round_cycle_time(st)
        if tau != taus[k]:
            raise AssertionError(f"round {k}: the vectorized engine reads "
                                 f"{taus[k]}, the oracle {tau}")
        print(f"{k:5d} | {str(st.isolated_nodes()):>14s} | {tau:8.2f}")

    # 5. the headline: average cycle time vs every baseline topology
    print("\ntopology       mean cycle (ms)")
    for topo in ["star", "matcha", "mst", "ring", "multigraph"]:
        rep = simulate(topo, net, FEMNIST, num_rounds=600)
        print(f"{topo:12s} {rep.mean_cycle_ms:10.2f}")

    # 6. profile a run (obs/): per-silo compute/transfer/wait spans from
    # the same TimingPlan, exported as Perfetto trace-event JSON — open
    # it at ui.perfetto.dev. The span ends reconcile bit-exactly with
    # the cycle times above; `python -m repro_torch.obs trace --help` is
    # the CLI twin.
    from repro_torch.obs import TraceRecorder, write_trace
    rec = TraceRecorder()
    rec.meta.update(network=net.name, topology="multigraph")
    end_ms = rec.add_sim_spans(plan, 12)
    trace_path = os.path.join(tempfile.gettempdir(), TRACE_NAME)
    write_trace(trace_path, rec)
    # the recorder accumulates round ends left to right; `sum()` of
    # floats is compensated since Python 3.12, so it is not the oracle
    if end_ms != functools.reduce(operator.add, map(float, taus)):
        raise AssertionError(f"trace end {end_ms} is not the left-to-right "
                             "sum of the cycle times")
    print(f"\ntrace: {len(rec.sim_events)} spans over {end_ms:.1f} ms "
          f"simulated -> {trace_path}")

    # 7. close the loop: train -> checkpoint -> serve. Federally train a
    # reduced LM over gaia's silos (FEMNIST is the timing workload; one
    # launch of the fused edge_aggregate kernel a round on the card),
    # checkpoint the per-silo rows, deploy one serving replica per
    # continent (each region serves the mean of ITS silos' rows, its
    # decode step captured as one CUDA graph on the card), and push
    # open-loop traffic through the fleet. `python -m repro_torch.serving`
    # is the CLI twin with a load sweep, BENCH output, and a Perfetto
    # serving timeline.
    from repro_torch.launch.train import TrainConfig, run_reduced_fl
    from repro_torch.serving import RegionalFleet, TrafficConfig
    from repro_torch.serving import simulate as serve
    with tempfile.TemporaryDirectory(prefix="quickstart_ckpt_") as ckpt_dir:
        train = run_reduced_fl(TrainConfig(arch="mamba2-370m", network="gaia",
                                           silos=6, rounds=3, t=2, seq_len=16,
                                           batch_size=2, ckpt_dir=ckpt_dir),
                               device=device)
        fleet = RegionalFleet.from_checkpoint(ckpt_dir, max_slots=4,
                                              max_seq=64, device=device)
    res = serve(fleet, TrafficConfig(duration_ms=400.0), load=60.0)
    s = res.summary
    print(f"\nserving: regions={list(fleet.regions)} "
          f"completed={s['completed']}/{s['arrived']} "
          f"p50={s['p50_ms']:.0f}ms p99={s['p99_ms']:.0f}ms "
          f"tokens/s={s['tokens_per_s']:.0f}")
    return {"trace_path": trace_path, "train": train, "fleet": fleet,
            "serving": s}


if __name__ == "__main__":
    main()
