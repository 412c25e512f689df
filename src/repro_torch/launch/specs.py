"""Assigned input shapes and meta-tensor stand-ins for the dry run
(counterpart of `repro.launch.specs`).

No storage is allocated here: params, batches and decode caches are
trees of tensors on the ``meta`` device (shape and type, no data). They
come from the real constructors, `transformer.init_params` and
`init_decode_state`, run under `FakeTensorMode` on the CPU with a CPU
generator, and are then moved to ``meta`` (`torch.empty_like`). So the
full-size configs are described on any host in a second or two.

Trees are nested dicts whose leaves are taken in sorted-key order
(`launch/mesh.tree_leaves`), the order of the reference's
`jax.tree.leaves` and of the flat rows (`fl/flat.py`); a `DecodeState`'s
leaves are its caches' (the KV groups in list order), then its position.

Types: tokens and labels are int32, as in the reference (the port's
steps take int32 or int64 tokens, and the LM streams are int32). The
one difference is the decode state's position: the port's
`init_decode_state` keeps it int64, the reference int32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import prefix_tokens


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    mode: str         # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return False, (f"{cfg.name} is pure full-attention; 500k decode is "
                       "quadratic — skipped per DESIGN.md §4")
    return True, ""


def to_meta(tree):
    """A tree of tensors (dicts, lists, `DecodeState`) -> the same tree of
    meta tensors."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_meta(v) for v in tree]
    if isinstance(tree, tf.DecodeState):
        return tf.DecodeState(caches=to_meta(tree.caches),
                              position=to_meta(tree.position))
    return torch.empty_like(tree, device="meta")


def meta_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree (dicts, lists, tuples, `DecodeState`) in the
    reference's `jax.tree.leaves` order; other leaves (an int position)
    are left out."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in meta_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in meta_leaves(v)]
    if isinstance(tree, tf.DecodeState):
        return meta_leaves(tree.caches) + meta_leaves(tree.position)
    return [tree] if isinstance(tree, torch.Tensor) else []


def params_shape(cfg: ModelConfig):
    with FakeTensorMode():
        params = tf.init_params(cfg, torch.Generator(), device="cpu")
    return to_meta(params)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_shape(cfg: ModelConfig, shape: InputShape, *,
                fl_silos: int = 0) -> dict:
    """Meta tensors for a train/prefill batch.

    fl_silos > 0 prepends the silo axis (FL training).
    """
    b, s = shape.global_batch, shape.seq_len
    lead = (fl_silos, b // fl_silos) if fl_silos else (b,)
    out = {"tokens": _meta(lead + (s,), torch.int32),
           "labels": _meta(lead + (s,), torch.int32)}
    p = prefix_tokens(cfg)
    if p:
        out["prefix_embeds"] = _meta(lead + (p, cfg.d_model),
                                     getattr(torch, cfg.dtype))
    return out


def decode_shapes(cfg: ModelConfig, shape: InputShape):
    """(tokens, DecodeState) meta tensors for one decode step."""
    b, s = shape.global_batch, shape.seq_len
    tokens = _meta((b, 1), torch.int32)
    with FakeTensorMode():
        state = tf.init_decode_state(cfg, b, s, dtype=torch.bfloat16,
                                     device="cpu")
    return tokens, to_meta(state)


def input_specs(arch: str, shape_name: str, *, fl_silos: int = 0):
    """Public entry: meta stand-ins for every model input."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(why)
    if shape.mode in ("train", "prefill"):
        return {"params": params_shape(cfg),
                "batch": batch_shape(cfg, shape, fl_silos=fl_silos)}
    tokens, state = decode_shapes(cfg, shape)
    return {"params": params_shape(cfg), "tokens": tokens, "state": state}
