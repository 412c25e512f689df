"""The benchmark's arithmetic: model FLOPs from a configuration's layer
list, the bytes and FLOPs the fused refresh-and-aggregate needs, and the
card's peaks (`peaks.json`)."""

from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def layer_flops(layer: dict) -> int:
    """Forward FLOPs of one layer for one sample: two per multiply-add of
    a direct convolution ((out_h, out_w) positions of a k x k x cin
    window for each of cout filters) or of a dense product."""
    if layer["kind"] == "conv":
        oh, ow = layer["out_hw"]
        return 2 * layer["k"] ** 2 * layer["cin"] * layer["cout"] * oh * ow
    if layer["kind"] == "dense":
        return 2 * layer["in"] * layer["out"]
    raise ValueError(f"unknown layer kind {layer['kind']!r}")


def train_flops_per_sample(cfg: dict) -> int:
    """Forward plus backward FLOPs of one sample: the forward product of
    every layer, its weight gradient (the same count), and its input
    gradient (the same count again) for every layer but the first, whose
    input needs none. Element-wise work (biases, activations, pooling,
    batch norm, the loss) is not counted."""
    layers = cfg["flops"]["layers"]
    fwd = [layer_flops(x) for x in layers]
    return sum(fwd) * 3 - fwd[0]


def round_flops(cfg: dict, num_silos: int) -> int:
    """Model FLOPs of one FL round: every silo's local updates on its
    batch."""
    return (train_flops_per_sample(cfg) * cfg["batch_size"]
            * cfg["local_updates"] * num_silos)


def param_count(cfg: dict) -> int:
    """Parameters the layer list holds, plus the configuration's biases
    and norm scales (``extra_params``)."""
    n = 0
    for x in cfg["flops"]["layers"]:
        n += (x["k"] ** 2 * x["cin"] * x["cout"] if x["kind"] == "conv"
              else x["in"] * x["out"])
    return n + cfg["flops"]["extra_params"]


def fused_work(num_silos: int, num_edges: int, width: int
               ) -> tuple[int, int]:
    """(bytes, FLOPs) one refresh-and-aggregate call of the flat runtime
    needs on ``num_silos`` fp32 rows of ``width`` and ``num_edges``
    dst-sorted edges: each row of w read once (the strong edges' fresh
    rows are rows of w), each weak buffer row read once and each strong
    one written once (one row per edge either way), the output rows
    written once, and the edge tables (coefficients, row pointers, diag,
    sources, strong mask) read once; two FLOPs per edge element and per
    row element of diag * w."""
    n, e, t = num_silos, num_edges, width
    tables = 4 * (e + 2 * n + 1) + e * (4 + 1)
    return (2 * n + e) * t * 4 + tables, 2 * (e + n) * t


def card_peaks(device_name: str) -> dict:
    """The first row of `peaks.json` whose ``match`` is in the card's
    name."""
    table = json.loads((BENCH / "peaks.json").read_text())
    for row in table["cards"]:
        if row["match"] in device_name:
            return row
    raise KeyError(f"no peak row for card {device_name!r} in peaks.json")
