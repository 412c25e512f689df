"""LoRA-style low-rank per-silo deltas over a shared frozen base
(counterpart of `repro.fl.lora`).

The mesh runtime (fl/mesh.py) holds per-silo trainable state as (N, T)
rows plus (2E, T) edge buffers. For the multi-billion-parameter
`configs/` architectures that layout is intractable: one silo row of a
27B model exceeds a card's memory, and every directed edge buffers a full
copy. This module shrinks T to a LoRA footprint:

  * every matrix-shaped leaf (ndim >= 2) of the model tree trains a
    low-rank delta  A @ B  with  A (.., d1, r), B (.., r, d2)  -- leading
    batch/stack dims (e.g. a stacked layer axis) are kept;
  * vector/scalar leaves (norm scales, biases) train DENSE deltas --
    they are tiny and low-rank would be degenerate;
  * the BASE tree is frozen and shared: the loss closes over it, so it
    lives once per device, not once per silo.

`B` starts at zero, so every silo starts at exactly the base model
(delta = 0) and the DPASGD aggregation stays well-posed: mixing deltas
row-wise mixes `base + A@B` because the base term is common to every
silo. `A` is drawn from an explicit `torch.Generator` (the reference
draws from `jax.random`, which torch cannot reproduce), so the same
generator seed gives the same start on the CPU and on the card when the
generator is the CPU's.

Usage with the flat/mesh runtime:

    ad    = make_lora_adapter(base_params, rank=8)
    delta = ad.init(torch.Generator().manual_seed(0))
    rt    = make_flat_runtime(plan, delta, n)
    state = init_mesh_state(ravel(rt.spec, delta), opt, mrt)
    cycle = make_cycle_fn(mrt, loss_fn=ad.wrap_loss(loss_fn), opt=opt)

so T becomes `lora_size(base, rank)` and the runtime is unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.launch.mesh import tree_leaves, tree_map
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

Params = dict

# Leaf-delta containers: a dict {"A": .., "B": ..} marks a low-rank delta;
# a bare tensor marks a dense delta. Both are plain nested dicts, so the
# flat runtime ravels them without knowing about LoRA at all.


def _is_lowrank(shape: tuple[int, ...], rank: int) -> bool:
    """Low-rank only pays when r(d1+d2) < d1*d2; degenerate dims opt out."""
    if len(shape) < 2:
        return False
    d1, d2 = shape[-2], shape[-1]
    return rank * (d1 + d2) < d1 * d2


def delta_template(template: Params, rank: int) -> Params:
    """The trainable delta's tree for ``template`` params (any tree whose
    leaves have ``.shape``): fp32 tensors on the meta device, which carry
    shapes and types and no storage."""

    def leaf(x):
        shape = tuple(x.shape)
        meta = lambda s: torch.empty(s, dtype=torch.float32, device="meta")
        if _is_lowrank(shape, rank):
            lead = shape[:-2]
            return {"A": meta(lead + (shape[-2], rank)),
                    "B": meta(lead + (rank, shape[-1]))}
        return meta(shape)

    return tree_map(leaf, template)


def lora_size(template: Params, rank: int) -> int:
    """T_lora: flat trainable floats per silo (vs full T = sum sizes)."""
    total = 0
    for x in tree_leaves(template):
        shape = tuple(x.shape)
        if _is_lowrank(shape, rank):
            total += math.prod(shape[:-2]) * rank * (shape[-2] + shape[-1])
        else:
            total += math.prod(shape)
    return total


def init_delta(template: Params, rank: int, generator: torch.Generator,
               device=None) -> Params:
    """delta_0: A ~ N(0, 1) / sqrt(d1) (fan-in scaled), B = 0, dense = 0.

    A is drawn leaf by leaf, in the tree's sorted-key order, from
    ``generator`` on its own device, then moved to ``device`` (the
    generator's when None). A@B = 0 everywhere, so apply(base, delta_0)
    == base bit for bit.
    """
    device = generator.device if device is None else torch.device(device)

    def leaf(x):
        shape = tuple(x.shape)
        if _is_lowrank(shape, rank):
            lead = shape[:-2]
            a = torch.randn(lead + (shape[-2], rank), generator=generator,
                            device=generator.device) / math.sqrt(shape[-2])
            return {"A": a.to(device),
                    "B": torch.zeros(lead + (rank, shape[-1]),
                                     device=device)}
        return torch.zeros(shape, device=device)

    return tree_map(leaf, template)


def apply_delta(base: Params, delta: Params) -> Params:
    """Materialise effective params: base + A@B (or base + dense delta),
    each added in the base leaf's type."""
    if isinstance(base, dict):
        return {k: apply_delta(base[k], delta[k]) for k in sorted(base)}
    if isinstance(delta, dict):
        return base + (delta["A"] @ delta["B"]).to(base.dtype)
    return base + delta.to(base.dtype)


@dataclasses.dataclass(frozen=True)
class LoRAAdapter:
    """Bundle the flat runtime needs: init / apply / loss wrapper."""

    base: Params
    rank: int
    init: Callable[[torch.Generator], Params]
    apply: Callable[[Params], Params]

    def wrap_loss(self, loss_fn):
        """loss over deltas: loss_fn(base + A@B, batch). The base is
        closed over: one copy per device, shared by every silo row."""
        base = self.base

        def delta_loss(delta, batch):
            return loss_fn(apply_delta(base, delta), batch)

        return delta_loss


def make_lora_adapter(base: Params, rank: int) -> LoRAAdapter:
    """An adapter over ``base``; its ``init(generator)`` draws delta_0
    onto the base's device."""
    device = tree_leaves(base)[0].device
    return LoRAAdapter(
        base=base, rank=rank,
        init=lambda generator: init_delta(base, rank, generator, device),
        apply=lambda delta: apply_delta(base, delta))


#: The checkpoint metadata value of ``base_init`` that names `lora_base`'s
#: draw: what the serving fleet needs to rebuild a `lora_delta` base.
BASE_INIT = "torch-cpu"


def lora_base(mcfg: ModelConfig, seed: int, device) -> dict:
    """The frozen base of LoRA training: `init_params` from a CPU generator
    seeded with ``seed + 1``, moved to ``device``. A generator on the card
    draws other weights than one on the host, so drawing on the host keeps
    card and CPU runs (and the fleet that serves their checkpoints) on one
    base."""
    base = tf.init_params(mcfg, torch.Generator().manual_seed(seed + 1),
                          device="cpu")
    return tree_map(lambda x: x.to(device), base)
