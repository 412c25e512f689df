"""A cell cut to a size the CPU runs in seconds: a configuration's model
(by default the program's FEMNIST CNN, `configs/femnist_cnn.json`, which
is no cell of `BENCHMARK.json` but runs the same timed path) on the
traffic of inat.gaia.multigraph, four rounds of batch 8, three of them
followed by the reference, with limits that sound CPU runs of that size
meet (their gaps read under 1e-7)."""

import dataclasses
import json

from bench import harness


def small_cell(config="femnist_cnn", rounds=4, batch=8):
    base = harness.load_cell("inat.gaia.multigraph")
    cfg = json.loads((harness.BENCH / "configs" /
                      f"{config}.json").read_text())
    return dataclasses.replace(
        base, name=f"{config}.small", cfg=dict(cfg, batch_size=batch),
        traffic=dict(base.traffic, rounds=rounds, eval_every=2,
                     samples_per_silo=16),
        check_rounds=min(rounds, 3),
        limits={"loss_rel_gap": 1e-5, "sim_gap_ms": 0.0})
