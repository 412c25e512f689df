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
from repro_torch.models import transformer as tf
from repro_torch.models.attention import check_impl
from repro_torch.models.config import ModelConfig
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
    each parameter's type. The returned loss is detached."""
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(p, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(p)))
    return loss.detach(), tree_map(lambda _: next(grads), p)


def _accumulate_grads(loss_fn, params, batch, microbatch: int):
    """Gradient accumulation over ``microbatch`` slices of the batch dim:
    the activations live for one slice at a time. The grads come back in
    fp32 (summed in fp32, then scaled by 1 / microbatch), and the loss is
    the slices' mean."""
    if microbatch <= 1:
        return _value_and_grad(loss_fn, params, batch)
    b = batch["tokens"].shape[0]
    if b % microbatch:
        raise ValueError(f"batch {b} is not a multiple of microbatch "
                         f"{microbatch}")
    size = b // microbatch
    g_acc = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                     params)
    l_acc = torch.zeros((), dtype=torch.float32,
                        device=batch["tokens"].device)
    for i in range(microbatch):
        part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, grads = _value_and_grad(loss_fn, params, part)
        g_acc = tree_map(lambda a, g: a + g.float(), g_acc, grads)
        l_acc = l_acc + loss
    inv = 1.0 / microbatch
    return l_acc * inv, tree_map(lambda x: x * inv, g_acc)


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

    def agg(w):
        a = a_mat.to(w.device, gdt).float()
        return torch.einsum("ij,j...->i...", a, w.to(gdt).float()).to(w.dtype)

    def fl_train_step(params, opt_state, batch):
        losses, grads = [], []
        for s in range(num_silos):
            loss, g = _accumulate_grads(
                loss_fn, tree_map(lambda x: x[s], params),
                {k: v[s] for k, v in batch.items()}, microbatch)
            if grad_dtype:
                g = tree_map(lambda x: x.to(getattr(torch, grad_dtype)), g)
            losses.append(loss)
            grads.append(g)
        with torch.no_grad():
            grads = tree_map(lambda *gs: torch.stack(gs), *grads)
            params, opt_state = opt.update(params, grads, opt_state)
            if gossip:
                params = tree_map(agg, params)
        return torch.stack(losses).mean(), params, opt_state

    return fl_train_step


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
