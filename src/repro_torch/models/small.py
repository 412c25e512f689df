"""The paper's FEMNIST CNN (counterpart of `repro.models.small`).

Parameters are a dict of tensors with the reference's names and shapes:
`(kh, kw, cin, cout)` conv filters and `(in, out)` dense weights, so a
flat row packs the same numbers in the same places in both packages.
Inputs are NHWC, as in the reference; `apply` permutes to the NCHW
layout of `F.conv2d` inside.

The Sent140 LSTM and the iNaturalist ResNet are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SmallModelSpec:
    name: str
    init: Callable[[torch.Generator], Params]
    apply: Callable[[Params, torch.Tensor], torch.Tensor]
    input_shape: tuple[int, ...]
    num_classes: int

    def loss(self, params: Params, batch: dict) -> torch.Tensor:
        """Mean cross-entropy; ``batch`` holds x (B, ...) and int y (B,)."""
        logits = self.apply(params, batch["x"])
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, batch["y"][:, None])[:, 0]
        return torch.mean(logz - ll)

    def accuracy(self, params: Params, batch: dict) -> torch.Tensor:
        logits = self.apply(params, batch["x"])
        return torch.mean((torch.argmax(logits, -1) == batch["y"]).float())


# ---------------------------------------------------------------------------
# FEMNIST CNN (LEAF benchmark CNN, as used by Marfoq et al.)
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


def femnist_cnn_init(gen: torch.Generator) -> Params:
    """The reference's initializer in distribution (He-normal convs,
    1/sqrt(fan_in) dense, zero biases), drawn from ``gen`` on the CPU."""
    return {
        "c1": _normal(gen, (5, 5, 1, 32), math.sqrt(2.0 / 25)),
        "c2": _normal(gen, (5, 5, 32, 64), math.sqrt(2.0 / (25 * 32))),
        "fc1": _normal(gen, (7 * 7 * 64, 384), 1.0 / math.sqrt(7 * 7 * 64)),
        "b1": torch.zeros(384),
        "fc2": _normal(gen, (384, 62), 1.0 / math.sqrt(384)),
        "b2": torch.zeros(62),
    }


def _conv_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME conv, stride 1: x (B, C, H, W), w (kh, kw, cin, cout)."""
    kh, kw = w.shape[0], w.shape[1]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    x = F.pad(x, (pw, kw - 1 - pw, ph, kh - 1 - ph))
    return F.conv2d(x, w.permute(3, 2, 0, 1))


def femnist_cnn_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, 28, 28, 1) NHWC -> logits (B, 62)."""
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(torch.relu(_conv_same(h, p["c1"])), 2)
    h = F.max_pool2d(torch.relu(_conv_same(h, p["c2"])), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC flatten
    h = torch.relu(h @ p["fc1"] + p["b1"])
    return h @ p["fc2"] + p["b2"]


def params_from_reference(params: dict[str, np.ndarray]) -> Params:
    """Carry the reference's parameters across: a dict of numpy arrays
    (``jax.device_get`` of a `repro` model's params) -> this package's
    dict of fp32 tensors. Names and shapes are the same on both sides."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

FEMNIST_CNN = SmallModelSpec("femnist_cnn", femnist_cnn_init,
                             femnist_cnn_apply, (28, 28, 1), 62)

SMALL_MODELS = {m.name: m for m in (FEMNIST_CNN,)}
