"""Paper Table 1 in miniature: cycle time of every topology on every
network, FEMNIST workload + the isolated-node statistics of Table 3
(the PyTorch port's copy of `examples/topology_comparison.py`).

The simulator is host numpy, so the table is the same on every device;
like every script here it still runs on the card unless ``--device``
names another device, and raises without one.

    PYTHONPATH=src python examples_torch/topology_comparison.py [--full] \
        [--device cpu]
"""

import argparse

from repro_torch.core.delay import FEMNIST
from repro_torch.core.simulator import simulate
from repro_torch.device import resolve_device
from repro_torch.networks.registry import get_network, list_networks

TOPOLOGIES = ["star", "matcha", "matcha_plus", "mst", "dmbst", "ring",
              "multigraph"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="6,400 rounds (the paper's) instead of 800")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    rounds = 6400 if args.full else 800
    print(f"mean cycle time (ms) over {rounds} rounds, FEMNIST workload\n")
    print(f"{'network':10s}" + "".join(f"{t:>13s}" for t in TOPOLOGIES))
    for name in list_networks():
        net = get_network(name)
        row = [f"{name:10s}"]
        for topo in TOPOLOGIES:
            rep = simulate(topo, net, FEMNIST, num_rounds=rounds)
            row.append(f"{rep.mean_cycle_ms:13.1f}")
        print("".join(row))
    print("\nours vs RING speedup:")
    for name in list_networks():
        net = get_network(name)
        ours = simulate("multigraph", net, FEMNIST, num_rounds=rounds)
        ring = simulate("ring", net, FEMNIST, num_rounds=rounds)
        print(f"  {name:8s} x{ring.mean_cycle_ms / ours.mean_cycle_ms:.2f} "
              f"(isolated rounds: {ours.rounds_with_isolated}/{rounds})")


if __name__ == "__main__":
    main()
