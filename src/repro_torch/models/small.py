"""The paper's federated models (counterpart of `repro.models.small`,
Table 2):

  FEMNIST      -- CNN,    1,280,478 params, 62-way characters
  Sentiment140 -- LSTM,   5,070,882 params, binary sentiment
  iNaturalist  -- ResNet, 11,685,170 params (ResNet-18-like), 1010 classes

Parameters are (nested) dicts of tensors with the reference's names and
shapes: `(kh, kw, cin, cout)` conv filters and `(in, out)` dense weights,
so a flat row packs the same numbers in the same places in both
packages. Image inputs are NHWC, as in the reference; `apply` permutes
to the NCHW layout of `F.conv2d` inside. Token inputs are int32.
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
    input_dtype: str = "float32"

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


def _conv_same(x: torch.Tensor, w: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """SAME conv: x (B, C, H, W), w (kh, kw, cin, cout) -> (B, cout,
    ceil(H/stride), ceil(W/stride)). Pads (k-1)//2 before and the rest
    after, as the reference's im2col does."""
    kh, kw = w.shape[0], w.shape[1]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    x = F.pad(x, (pw, kw - 1 - pw, ph, kh - 1 - ph))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def femnist_cnn_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, 28, 28, 1) NHWC -> logits (B, 62)."""
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(torch.relu(_conv_same(h, p["c1"])), 2)
    h = F.max_pool2d(torch.relu(_conv_same(h, p["c2"])), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC flatten
    h = torch.relu(h @ p["fc1"] + p["b1"])
    return h @ p["fc2"] + p["b2"]


# ---------------------------------------------------------------------------
# Sentiment140 LSTM
# ---------------------------------------------------------------------------

_S140_VOCAB = 15_000
_S140_EMBED = 300  # GloVe-300, the standard Sent140 embedding
_S140_HIDDEN = 256
_S140_SEQ = 32


def lstm_init(gen: torch.Generator) -> Params:
    d, h = _S140_EMBED, _S140_HIDDEN
    return {
        "embed": _normal(gen, (_S140_VOCAB, d), 0.02),
        "wx": _normal(gen, (d, 4 * h), 1.0 / math.sqrt(d)),
        "wh": _normal(gen, (h, 4 * h), 1.0 / math.sqrt(h)),
        "b": torch.zeros(4 * h),
        "out": _normal(gen, (h, 2), 1.0 / math.sqrt(h)),
        "out_b": torch.zeros(2),
    }


def lstm_apply(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, 2). Gates split i, f, g, o; the
    carry (h, c) starts at zeros; the logits come from the last h."""
    x = F.embedding(tokens, p["embed"])          # (B, S, D)
    xw = x @ p["wx"]                             # every step's x_t @ wx
    b = tokens.shape[0]
    h = x.new_zeros((b, _S140_HIDDEN))
    c = x.new_zeros((b, _S140_HIDDEN))
    for t in range(tokens.shape[1]):
        gates = xw[:, t] + h @ p["wh"] + p["b"]
        i, f, g, o = torch.split(gates, _S140_HIDDEN, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return h @ p["out"] + p["out_b"]


# ---------------------------------------------------------------------------
# iNaturalist ResNet (ResNet-18-like)
# ---------------------------------------------------------------------------

_RESNET_STAGES = [(64, 1), (128, 2), (256, 2), (512, 2)]
_INAT_CLASSES = 1010


def _conv_init(gen, shape) -> torch.Tensor:
    return _normal(gen, shape, math.sqrt(2.0 / (shape[0] * shape[1]
                                                * shape[2])))


def _bn_init(c: int) -> Params:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _bn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Normalise over N, H and W with the population variance, in the
    reference's order; no running statistics. x is (B, C, H, W)."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, correction=0)
    return ((x - mean) * torch.rsqrt(var + 1e-5) * p["scale"][:, None, None]
            + p["bias"][:, None, None])


def _block_init(gen, cin: int, cout: int, stride: int) -> Params:
    p = {"c1": _conv_init(gen, (3, 3, cin, cout)), "bn1": _bn_init(cout),
         "c2": _conv_init(gen, (3, 3, cout, cout)), "bn2": _bn_init(cout)}
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, (1, 1, cin, cout))
    return p


def _block_apply(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = torch.relu(_bn(p["bn1"], _conv_same(x, p["c1"], stride)))
    h = _bn(p["bn2"], _conv_same(h, p["c2"]))
    sc = _conv_same(x, p["proj"], stride) if "proj" in p else x
    return torch.relu(h + sc)


def resnet_init(gen: torch.Generator) -> Params:
    p: Params = {"stem": _conv_init(gen, (3, 3, 3, 64)), "bn0": _bn_init(64)}
    cin = 64
    for si, (cout, stride) in enumerate(_RESNET_STAGES):
        for bi in range(2):
            p[f"s{si}b{bi}"] = _block_init(gen, cin, cout,
                                           stride if bi == 0 else 1)
            cin = cout
    p["fc"] = _normal(gen, (512, _INAT_CLASSES), 1.0 / math.sqrt(512))
    p["fc_b"] = torch.zeros(_INAT_CLASSES)
    return p


def resnet_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, 32, 32, 3) NHWC -> logits (B, 1010)."""
    h = x.permute(0, 3, 1, 2)
    h = torch.relu(_bn(p["bn0"], _conv_same(h, p["stem"])))
    for si, (_, stride) in enumerate(_RESNET_STAGES):
        for bi in range(2):
            h = _block_apply(p[f"s{si}b{bi}"], h, stride if bi == 0 else 1)
    h = h.mean(dim=(2, 3))
    return h @ p["fc"] + p["fc_b"]


def params_from_reference(params: dict) -> Params:
    """Carry the reference's parameters across: a (nested) dict of numpy
    arrays (``jax.device_get`` of a `repro` model's params) -> this
    package's (nested) dict of fp32 tensors, same names and shapes."""
    return {k: (params_from_reference(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v, np.float32)))
            for k, v in params.items()}


def param_count(params: Params) -> int:
    return sum(param_count(v) if isinstance(v, dict) else v.numel()
               for v in params.values())


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

FEMNIST_CNN = SmallModelSpec("femnist_cnn", femnist_cnn_init,
                             femnist_cnn_apply, (28, 28, 1), 62)
SENT140_LSTM = SmallModelSpec("sent140_lstm", lstm_init, lstm_apply,
                              (_S140_SEQ,), 2, input_dtype="int32")
INAT_RESNET = SmallModelSpec("inat_resnet", resnet_init, resnet_apply,
                             (32, 32, 3), _INAT_CLASSES)

SMALL_MODELS = {m.name: m for m in (FEMNIST_CNN, SENT140_LSTM, INAT_RESNET)}
