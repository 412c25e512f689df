"""Plain reference of `femnist_cnn.json`: the program's FEMNIST CNN (two
5x5 SAME convolutions of 32 and 64 filters without bias, each with ReLU
and a 2x2 max pool, a 384-wide dense layer with ReLU, 62 logits), fp32,
plain `torch.nn.functional`. No public source gives these widths, so it
is no configuration of `BENCHMARK.json`; the CPU tests run it as a small
model on the timed path. Parameters are a dict of (kh, kw, cin, cout)
filters and (in, out) dense weights drawn from a CPU `torch.Generator`
in the program's initialiser's order (He-normal filters, 1/sqrt(fan_in)
dense weights, zero biases), so the same seed gives the same start.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _normal(gen, shape, scale):
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


def init(cfg: dict, gen: torch.Generator) -> dict:
    k, c1, c2 = cfg["kernel_size"], cfg["conv1_filters"], cfg["conv2_filters"]
    cin, hid, ncls = cfg["input_shape"][2], cfg["hidden_size"], \
        cfg["num_classes"]
    flat = (cfg["input_shape"][0] // 4) * (cfg["input_shape"][1] // 4) * c2
    return {
        "c1": _normal(gen, (k, k, cin, c1), math.sqrt(2.0 / (k * k * cin))),
        "c2": _normal(gen, (k, k, c1, c2), math.sqrt(2.0 / (k * k * c1))),
        "fc1": _normal(gen, (flat, hid), 1.0 / math.sqrt(flat)),
        "b1": torch.zeros(hid),
        "fc2": _normal(gen, (hid, ncls), 1.0 / math.sqrt(hid)),
        "b2": torch.zeros(ncls),
    }


def apply(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> logits (B, classes)."""
    pad = (cfg["kernel_size"] - 1) // 2
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(F.relu(F.conv2d(h, p["c1"].permute(3, 2, 0, 1),
                                     padding=pad)), 2)
    h = F.max_pool2d(F.relu(F.conv2d(h, p["c2"].permute(3, 2, 0, 1),
                                     padding=pad)), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flattened as NHWC
    h = F.relu(h @ p["fc1"] + p["b1"])
    return h @ p["fc2"] + p["b2"]
