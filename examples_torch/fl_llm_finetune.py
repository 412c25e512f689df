"""End-to-end example: federally train a (reduced) assigned LLM
architecture across silos with the multigraph topology, and compare the
simulated wall-clock against RING — the paper's technique applied to a
modern model stack (the PyTorch port's copy of
`examples/fl_llm_finetune.py`).

The training runs on the mesh-sharded flat runtime (`fl/mesh.py`):
silos are sharded over a shard axis, and the per-silo trainable state
is a LoRA delta over a frozen shared base (`fl/lora.py`), drawn on the
host so that card and CPU runs train the same model. Each round
refreshes and aggregates every shard's rows in one launch of the
hand-written `edge_aggregate` kernel on the card. ``mesh="auto"`` is one
stacked shard in a plain process, and one shard a rank under `torchrun`
(the default process group). Without a card the script raises unless
``--device`` names another device.

    PYTHONPATH=src python examples_torch/fl_llm_finetune.py \
        [--arch qwen2-7b] [--device cpu]
"""

import argparse

from repro_torch.device import resolve_device
from repro_torch.launch.train import TrainConfig, run_reduced_fl

TOPOLOGIES = ("multigraph", "ring")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--silos", type=int, default=5)
    ap.add_argument("--lora-rank", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    results = {}
    for topo in TOPOLOGIES:
        cfg = TrainConfig(arch=args.arch, topology=topo, silos=args.silos,
                          rounds=args.rounds, lr=5e-2, mesh="auto",
                          lora_rank=args.lora_rank)
        results[topo] = r = run_reduced_fl(cfg, device=device)
        print(f"{topo:11s} loss {r['loss_first']:.3f} -> {r['loss_last']:.3f}"
              f"  sim cycle {r['sim_mean_cycle_ms']:.1f} ms"
              f"  sim total {r['sim_total_time_s']:.2f} s")
    m, g = results["multigraph"], results["ring"]
    print(f"\nwall-clock speedup vs RING: "
          f"x{g['sim_mean_cycle_ms'] / m['sim_mean_cycle_ms']:.2f} "
          f"at comparable per-round loss "
          f"({m['loss_last']:.3f} vs {g['loss_last']:.3f})")
    return results


if __name__ == "__main__":
    main()
