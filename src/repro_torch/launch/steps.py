"""Step builders for training, prefill and decode (counterpart of
`repro.launch.steps`, one device).

* train_step    -- AdamW over a remat'd forward/backward, with gradient
  accumulation over micro batches.
* fl_train_step -- the silo axis leads every leaf: each silo's local
  step, then the DPASGD consensus over the silos (a dense consensus
  einsum, the strong-round form). The paper's technique at model scale.
* prefill_step  -- forward, last-position logits only.
* serve_step    -- one-token decode against the caches (KV caches, and the
  recurrent SSM and conv states of the ssm and hybrid families).

They serve every family: dense (yi-9b, qwen2, gemma3), moe (granite,
phi3.5), vlm (paligemma), audio (musicgen), ssm (mamba2) and hybrid
(zamba2).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.consensus import metropolis_weights
from repro_torch.core.graph import make_graph
from repro_torch.launch.mesh import tree_leaves, tree_map
from repro_torch.models import shard_ctx
from repro_torch.models import transformer as tf
from repro_torch.models.attention import check_impl
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params  # noqa: F401
from repro_torch.optim import Optimizer, adamw

#: Prefill and serving: on the card this is the CUDA `ssd_scan` kernel in
#: every Mamba2 layer and the CUDA flash attention kernel in every
#: attention layer (zamba2's shared block included) in prefill, and the
#: flash-decode kernel in decode; the Mamba2 decode step is plain
#: PyTorch. (The reference defaults to "chunked", its XLA lowering path;
#: the port's counterpart of the TPU kernel path is "kernel".)
DEFAULT_IMPL = "kernel"
#: Training: the plain O(S * block) attention and chunked SSD, the
#: reference's default for its train-step builders. No hand-written
#: kernel has a backward pass (nor has the reference's flash kernel).
TRAIN_IMPL = "chunked"


def make_loss_fn(cfg: ModelConfig, *, impl: str = TRAIN_IMPL,
                 remat: bool = True, ce_block: int = 256):
    """(params, batch) -> loss, through `transformer.loss_fn` with the
    streamed cross entropy."""
    check_impl(impl)
    if impl == "kernel":
        raise ValueError("make_loss_fn: impl='kernel' has no backward pass "
                         "(the CUDA flash attention and SSD kernels are "
                         "forward only, as the reference's Pallas kernels "
                         "are); train with 'chunked' or 'reference'")

    def loss_fn(params, batch):
        loss, _ = tf.loss_fn(params, cfg, batch, impl=impl, remat=remat,
                             ce_block=ce_block)
        return loss

    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)`` by autograd; grads in
    each parameter's type (DTensor grads as autograd lays them out, a
    partial sum where the parameter was used split). The returned loss
    is detached."""
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(p, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(p)))
    return loss.detach(), tree_map(lambda _: next(grads), p)


def _like(g, p):
    """A DTensor gradient laid out as its parameter (the gradient sync:
    a partial sum is reduced, a replica sliced); a tensor as it is."""
    if shard_ctx.is_dtensor(g) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _accumulate_grads(loss_fn, params, batch, microbatch: int,
                      grad_dtype: str | None = None):
    """Gradient accumulation over ``microbatch`` slices of the batch dim:
    the activations live for one slice at a time. With accumulation the
    grads come back in fp32 (summed in fp32, then scaled by 1 /
    microbatch), and the loss is the slices' mean; ``grad_dtype`` casts
    them. DTensor grads are synced to their parameters' layout once, at
    the end, after the cast (so a bf16 cast halves the sync's bytes)."""
    if microbatch <= 1:
        loss, grads = _value_and_grad(loss_fn, params, batch)
    else:
        b = batch["tokens"].shape[0]
        if b % microbatch:
            raise ValueError(f"batch {b} is not a multiple of microbatch "
                             f"{microbatch}")
        g_acc = None
        l_acc = torch.zeros((), dtype=torch.float32,
                            device=batch["tokens"].device)
        for i in range(microbatch):
            part = {k: shard_ctx.row_slice(v, i, microbatch)
                    for k, v in batch.items()}
            loss, grads = _value_and_grad(loss_fn, params, part)
            if g_acc is None:  # laid out as the grads: no sync per slice
                g_acc = tree_map(
                    lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
            g_acc = tree_map(lambda a, g: a + g.float(), g_acc, grads)
            l_acc = l_acc + loss
        inv = 1.0 / microbatch
        loss, grads = l_acc * inv, tree_map(lambda x: x * inv, g_acc)
    if grad_dtype:
        grads = tree_map(lambda x: x.to(getattr(torch, grad_dtype)), grads)
    return loss, tree_map(_like, grads, params)


def make_train_step(cfg: ModelConfig, opt: Optimizer | None = None, *,
                    impl: str = TRAIN_IMPL, remat: bool = True,
                    microbatch: int = 1):
    """(params, opt_state, batch) -> (loss, params, opt_state)."""
    opt = opt or adamw(1e-4)
    loss_fn = make_loss_fn(cfg, impl=impl, remat=remat)

    def train_step(params, opt_state, batch):
        loss, grads = _accumulate_grads(loss_fn, params, batch, microbatch)
        with torch.no_grad():
            params, opt_state = opt.update(params, grads, opt_state)
        return loss, params, opt_state

    return train_step


def ring_consensus(num_silos: int) -> np.ndarray:
    """The default consensus: the 2-silo average, else the Metropolis
    weights of the ring 0-1-...-(n-1)-0."""
    if num_silos == 2:
        return np.array([[0.5, 0.5], [0.5, 0.5]], np.float32)
    ring = make_graph(num_silos, [(i, (i + 1) % num_silos)
                                  for i in range(num_silos)])
    return metropolis_weights(ring).astype(np.float32)


def make_fl_train_step(cfg: ModelConfig, num_silos: int,
                       opt: Optimizer | None = None, *,
                       impl: str = TRAIN_IMPL, remat: bool = True,
                       consensus: np.ndarray | None = None,
                       gossip: bool = True, microbatch: int = 1,
                       gossip_dtype: str = "float32",
                       grad_dtype: str | None = None):
    """One DPASGD communication round over a silo axis that leads every
    leaf of params, opt_state (the optimizer's state of the stacked tree:
    its step is shared) and batch: each silo's local step on its own
    batch (a Python loop over the silos), then, with ``gossip``, the
    consensus w_i <- sum_j A[i, j] w_j over the silos (`gossip=False` is
    a weak, isolated round). ``gossip_dtype`` is the type the weights
    cross the silo links in (the products accumulate in fp32, then cast
    back to each leaf's type); ``grad_dtype`` casts the grads before the
    update. Returns (mean loss over silos, params, opt_state)."""
    opt = opt or adamw(1e-4)
    loss_fn = make_loss_fn(cfg, impl=impl, remat=remat)
    a_mat = torch.as_tensor(consensus if consensus is not None
                            else ring_consensus(num_silos))
    gdt = getattr(torch, gossip_dtype)

    def agg(w, rows=slice(None)):
        if shard_ctx.is_dtensor(w):
            return _agg_over_pods(w)
        a = a_mat[rows].to(w.device, gdt).float()
        return torch.einsum("ij,j...->i...", a, w.to(gdt).float()).to(w.dtype)

    def _agg_over_pods(w):
        """Every rank gathers the silos over "pod" in ``gossip_dtype``
        (the reference's all-gather over the pod axis) and mixes its own
        silos' rows of the consensus."""
        from torch.distributed.tensor import Replicate

        mesh = w.device_mesh
        pod = mesh.mesh_dim_names.index("pod")
        size, off = shard_ctx.local_box(tuple(w.shape), mesh, w.placements)
        whole = list(w.placements)
        whole[pod] = Replicate()
        rows = slice(off[0], off[0] + size[0])
        return shard_ctx.run_local(
            lambda wl: agg(wl, rows).to(w.dtype), (w.to(gdt),), (whole,),
            w.placements, tuple(w.shape))

    def fl_train_step(params, opt_state, batch):
        silos = SiloSplit(params)
        losses, grads = [], []
        for s in silos.local:
            loss, g = _accumulate_grads(
                loss_fn, silos.take(params, s),
                {k: silos.take(v, s) for k, v in batch.items()}, microbatch,
                grad_dtype)
            losses.append(loss)
            grads.append(g)
        with torch.no_grad():
            grads = tree_map(lambda *gs: silos.stack(gs), *grads)
            params, opt_state = opt.update(params, grads, opt_state)
            if gossip:
                params = tree_map(agg, params)
        return silos.mean(losses), params, opt_state

    return fl_train_step


class SiloSplit:
    """The silos of a stacked tree that this process steps, and how to
    take one and stack them back.

    Plain tensors: every silo, row s of each leaf. DTensors whose leading
    silo axis is sharded over the mesh dim "pod" (`param_specs(...,
    pod_stacked=True)`): only this pod's silos, each a DTensor on the
    sub-mesh of the other axes (the reference's `shard_map` with "pod"
    manual, "data" and "model" left to the partitioner), so the local
    step moves nothing across pods; `stack` puts the silos back on the
    pod-sharded axis."""

    def __init__(self, params):
        leaf = tree_leaves(params)[0]
        self.mesh = None
        if (shard_ctx.is_dtensor(leaf)
                and "pod" in leaf.device_mesh.mesh_dim_names):
            self.mesh = leaf.device_mesh
            names = self.mesh.mesh_dim_names
            self.pod = names.index("pod")
            rest = tuple(n for n in names if n != "pod")
            self.sub = self.mesh[rest] if len(rest) > 1 else self.mesh[rest[0]]
            self.local = range(leaf.to_local().shape[0])
            self.n = leaf.shape[0]
        else:
            self.local = range(leaf.shape[0])

    def take(self, tree, s: int):
        if self.mesh is None:
            return tree_map(lambda x: x[s], tree)

        def one(x):
            from torch.distributed.tensor import Shard

            pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
                  for i, p in enumerate(x.placements) if i != self.pod]
            return shard_ctx.wrap(x.to_local()[s], self.sub, pl,
                                  tuple(x.shape[1:]))

        return tree_map(one, tree)

    def mean(self, losses):
        """The mean of the silos' losses. Over pods it stays a partial sum
        over "pod" (a DTensor the caller reduces when it reads it), so that
        the step itself moves nothing across pods unless it gossips."""
        if self.mesh is None:
            return torch.stack(losses).mean()
        from torch.distributed.tensor import Partial

        local = torch.stack([x.to_local() for x in losses]).sum() / self.n
        pl = list(losses[0].placements)
        pl.insert(self.pod, Partial())
        return shard_ctx.wrap(local, self.mesh, pl, ())

    def stack(self, xs):
        if self.mesh is None:
            return torch.stack(list(xs))
        from torch.distributed.tensor import Shard

        x0 = xs[0]
        local = torch.stack([x.to_local() for x in xs])
        pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p
              for p in x0.placements]
        pl.insert(self.pod, Shard(0))
        return shard_ctx.wrap(local, self.mesh, pl,
                              (self.n,) + tuple(x0.shape))


def make_prefill_step(cfg: ModelConfig, *, impl: str = DEFAULT_IMPL):
    def prefill_step(params, batch):
        # serving prefill: only the last position's logits are unembedded
        logits, _ = tf.forward(params, cfg, batch["tokens"],
                               prefix_embeds=batch.get("prefix_embeds"),
                               impl=impl, last_only=True)
        return logits[:, -1, :]

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, device_positions: bool = False,
                    impl: str = DEFAULT_IMPL):
    """One-token decode through ``impl``, by default DEFAULT_IMPL: on the
    card, the CUDA flash-decode kernel for every attention layer. (The
    reference's serve step decodes with its plain attention and never
    reaches its decode kernel; the dry run decodes with "chunked", whose
    attention reads no lengths on the host.) `device_positions` is
    `decode_step`'s: the serving engine's positions stay on the card,
    range-checked by the engine."""
    check_impl(impl)

    def serve_step(params, tokens, state):
        return tf.decode_step(params, cfg, tokens, state, impl=impl,
                              device_positions=device_positions)

    return serve_step
