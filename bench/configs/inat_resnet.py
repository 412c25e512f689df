"""Plain reference of `inat_resnet.json`: pytorch-cifar's ResNet18 at
32x32x3, the model the paper trains on iNaturalist (a 3x3 stem of 64
filters, four stages of two basic blocks at 64/128/256/512 filters, the
first block of each later stage at stride 2 with a 1x1 projection,
global average pool), fp32, plain `torch.nn.functional`. Departures
from the source, as the file's `reduced` lists them: 1,010 logits; no
batch norm on the projections; batch norm normalises with the batch's
own statistics (population variance, eps 1e-5) and keeps no running
statistics. Parameters are drawn from a CPU `torch.Generator` in the
program's initialiser's order (He-normal filters, unit scales, zero
biases, 1/sqrt(fan_in) classifier), so the same seed gives the same
start.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _normal(gen, shape, scale):
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


def _conv(gen, k, cin, cout):
    return _normal(gen, (k, k, cin, cout), math.sqrt(2.0 / (k * k * cin)))


def _bn_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def init(cfg: dict, gen: torch.Generator) -> dict:
    stem = cfg["stem_filters"]
    p = {"stem": _conv(gen, 3, cfg["input_shape"][2], stem),
         "bn0": _bn_init(stem)}
    cin = stem
    for si, (cout, stride) in enumerate(cfg["stages"]):
        for bi in range(cfg["blocks_per_stage"]):
            s = stride if bi == 0 else 1
            blk = {"c1": _conv(gen, 3, cin, cout), "bn1": _bn_init(cout),
                   "c2": _conv(gen, 3, cout, cout), "bn2": _bn_init(cout)}
            if s != 1 or cin != cout:
                blk["proj"] = _conv(gen, 1, cin, cout)
            p[f"s{si}b{bi}"] = blk
            cin = cout
    p["fc"] = _normal(gen, (cin, cfg["num_classes"]), 1.0 / math.sqrt(cin))
    p["fc_b"] = torch.zeros(cfg["num_classes"])
    return p


def _conv_bn(x, w, bn, stride):
    k = w.shape[0]
    h = F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride,
                 padding=(k - 1) // 2)
    if bn is None:
        return h
    return F.batch_norm(h, None, None, bn["scale"], bn["bias"],
                        training=True, eps=1e-5)


def apply(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> logits (B, classes)."""
    h = F.relu(_conv_bn(x.permute(0, 3, 1, 2), p["stem"], p["bn0"], 1))
    for si, (_, stride) in enumerate(cfg["stages"]):
        for bi in range(cfg["blocks_per_stage"]):
            blk = p[f"s{si}b{bi}"]
            s = stride if bi == 0 else 1
            y = F.relu(_conv_bn(h, blk["c1"], blk["bn1"], s))
            y = _conv_bn(y, blk["c2"], blk["bn2"], 1)
            sc = _conv_bn(h, blk["proj"], None, s) if "proj" in blk else h
            h = F.relu(y + sc)
    return h.mean(dim=(2, 3)) @ p["fc"] + p["fc_b"]
