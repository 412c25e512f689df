"""Model assembler (counterpart of `repro.models.transformer`).

Parameters are a nested dict of tensors with the reference's names and
shapes: `(in, out)` matrices, and `blocks` stacked on a leading layer
axis. The forward runs a Python loop over the layers (`remat=True`
checkpoints each layer, `torch.utils.checkpoint`, non-reentrant); the
caches of `decode_step` (KV caches, SSM and conv states) are updated in
place.

Families, prefill, decode and training loss:
  dense / vlm / audio -- pre-norm attention + gated-MLP blocks (yi-9b,
      qwen2, gemma3's mixed local/global stack with each layer's own
      window; paligemma and musicgen prepend frontend embeddings, a
      bidirectional prefix for vlm only);
  moe    -- attention + top-k MoE blocks (`models/moe.py`), the aux
      load-balance loss summed over the layers;
  ssm    -- Mamba2 (SSD) blocks (mamba2-370m);
  hybrid -- a Mamba2 backbone and ONE shared attention/MLP block applied
      after every `attn_every` layers (zamba2): shared weights, a KV
      cache of its own per application at decode.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import mamba2
from repro_torch.models import moe as moe_mod
from repro_torch.models import shard_ctx
from repro_torch.models.attention import (NEG_INF, _project_qkv, attention,
                                          attn_init, check_impl,
                                          init_kv_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Params, apply_rope, cross_entropy,
                                       embed, embed_init, label_logits,
                                       logsumexp_last, mlp, mlp_init,
                                       rmsnorm, rmsnorm_init, unembed)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def set_activation_sharding(spec) -> None:
    """Back-compat shim: sets only the block-boundary act spec
    (`shard_ctx.set_specs(act=spec)`)."""
    shard_ctx.set_specs(act=spec)


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = full/global)."""
    if cfg.global_every:
        # gemma3 pattern: one global layer every `global_every` layers.
        return np.array([0 if (i + 1) % cfg.global_every == 0
                         else cfg.sliding_window
                         for i in range(cfg.num_layers)], np.int32)
    return np.full((cfg.num_layers,), cfg.sliding_window, np.int32)


def num_shared_attn_apps(cfg: ModelConfig) -> int:
    """Hybrid: how many times the shared attention block is applied."""
    if cfg.family != "hybrid":
        return 0
    return cfg.num_layers // cfg.attn_every


def kv_group_spec(cfg: ModelConfig, max_seq: int):
    """Decode KV caches grouped by cache length: a list of
    (layer_indices, cache_len, window), at most two groups. Local
    (sliding-window) layers keep window-sized ring buffers."""
    wins = layer_windows(cfg)
    cache_len = [max_seq if w == 0 else min(int(w), max_seq) for w in wins]
    groups = []
    for ln in sorted(set(cache_len)):
        idx = tuple(i for i, cl in enumerate(cache_len) if cl == ln)
        groups.append((idx, ln, int(wins[idx[0]])))
    return groups


# ---------------------------------------------------------------------------
# init and weights carried across
# ---------------------------------------------------------------------------


def _attn_mlp_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = _dtype(cfg)
    return {
        "ln1": rmsnorm_init(cfg.d_model, device=device),
        "attn": attn_init(gen, cfg, dt, device=device),
        "ln2": rmsnorm_init(cfg.d_model, device=device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dt, device=device),
    }


def _init_block(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """One layer's params."""
    if cfg.family in ("dense", "vlm", "audio"):
        return _attn_mlp_init(gen, cfg, device)
    if cfg.family == "moe":
        dt = _dtype(cfg)
        return {
            "ln1": rmsnorm_init(cfg.d_model, device=device),
            "attn": attn_init(gen, cfg, dt, device=device),
            "ln2": rmsnorm_init(cfg.d_model, device=device),
            "moe": moe_mod.moe_init(gen, cfg, dt, device=device),
        }
    if cfg.family in ("ssm", "hybrid"):
        return {
            "ln": rmsnorm_init(cfg.d_model, device=device),
            "mamba": mamba2.mamba_init(gen, cfg, _dtype(cfg), device=device),
        }
    raise ValueError(cfg.family)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_set(dst, src, i: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _tree_set(dst[k], v, i)
        else:
            dst[k][i] = v


def _layer(blocks: Params, i: int) -> Params:
    """Layer i's params: views into the stacked blocks (DTensor blocks
    FSDP-sharded over "data" are gathered over it, layer by layer)."""
    return _tree_map(lambda a: shard_ctx.unshard(a[i]), blocks)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random weights in the reference's distribution: normal * 1/sqrt
    (fan_in) matrices, embedding * 0.02, norm scales 1, biases 0, cast to
    `cfg.dtype` (norm scales and the Mamba2 A_log, D and dt_bias stay
    fp32, and so does the MoE router). Drawn layer by layer from
    ``generator`` on ``device`` (the card by default), so the full model
    never passes through the host; the generator must live there. A
    hybrid model also gets its one `shared_attn` block."""
    cfg.validate()
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"init_params: generator on {generator.device}, "
                         f"weights on {device}")
    blocks = None
    for i in range(cfg.num_layers):
        bp = _init_block(generator, cfg, device)
        if blocks is None:
            blocks = _tree_map(
                lambda a: torch.empty((cfg.num_layers,) + tuple(a.shape),
                                      dtype=a.dtype, device=device), bp)
        _tree_set(blocks, bp, i)
        del bp
    params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                            _dtype(cfg), cfg.tie_embeddings, device=device),
        "blocks": blocks,
        "ln_f": rmsnorm_init(cfg.d_model, device=device),
    }
    if cfg.family == "hybrid":
        params["shared_attn"] = _attn_mlp_init(generator, cfg, device)
    return params


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: jax hands out read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(params, device="cpu") -> Params:
    """Carry the reference's parameters across: the nested dict of numpy
    arrays of a `repro` transformer (``jax.device_get`` of its params)
    -> this package's nested dict of tensors, with the same names,
    nesting, shapes, types and bits (the MoE leaves too: the fp32
    `router` and the experts' `w_gate`/`w_up`/`w_down`)."""
    if isinstance(params, dict):
        return {k: params_from_reference(v, device) for k, v in params.items()}
    return _to_tensor(np.asarray(params), device)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


# The block boundaries are anchored (`shard_ctx.constrain_act`, a no-op
# unless the launch layer set its specs and x is a DTensor), and each
# mixer's output too before its residual add: GSPMD propagates the
# block-boundary anchor back through the add, where DTensor decides op by
# op and would keep the row-parallel product's partial sums sharded on
# d_model.


def _attn_mlp_block(bp: Params, cfg: ModelConfig, x, *, window, prefix,
                    impl):
    h = x + shard_ctx.constrain_act(attention(
        bp["attn"], cfg, rmsnorm(bp["ln1"], x, cfg.norm_eps), window=window,
        prefix=prefix, impl=impl))
    h = h + shard_ctx.constrain_act(mlp(
        bp["mlp"], rmsnorm(bp["ln2"], h, cfg.norm_eps), cfg.mlp_act))
    return h


def _attn_moe_block(bp: Params, cfg: ModelConfig, x, *, impl, moe_impl):
    h = x + shard_ctx.constrain_act(attention(
        bp["attn"], cfg, rmsnorm(bp["ln1"], x, cfg.norm_eps),
        window=cfg.sliding_window, impl=impl))
    y, aux = moe_mod.moe(bp["moe"], cfg, rmsnorm(bp["ln2"], h, cfg.norm_eps),
                         impl=moe_impl)
    return h + shard_ctx.constrain_act(y), aux


def _mamba_block(bp: Params, cfg: ModelConfig, x, *, impl):
    return x + shard_ctx.constrain_act(mamba2.mamba_forward(
        bp["mamba"], cfg, rmsnorm(bp["ln"], x, cfg.norm_eps), impl=impl))


def _remat(fn, remat: bool):
    """fn, or fn recomputed in the backward pass (the reference's
    `jax.checkpoint` of the scanned layer body) when ``remat`` and
    gradients are being recorded."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _hybrid_forward(params, cfg, x, *, impl, remat):
    """Mamba2 backbone (ssm, hybrid). In a hybrid the shared attention
    block runs after each segment of attn_every layers (weights shared
    across applications), then the tail segment, if any, runs without it;
    an ssm model is all tail. ``remat`` checkpoints the Mamba2 layers, as
    the reference's does."""
    k = cfg.attn_every
    blocks = params["blocks"]
    shared = _tree_map(shard_ctx.unshard, params.get("shared_attn", {}))

    def mamba_layer(i):
        return _remat(lambda h: shard_ctx.constrain_act(_mamba_block(
            _layer(blocks, i), cfg, h, impl=impl)), remat)

    done = 0
    for _ in range(num_shared_attn_apps(cfg)):
        for i in range(done, done + k):
            x = mamba_layer(i)(x)
        done += k
        x = _attn_mlp_block(shared, cfg, x, window=cfg.sliding_window,
                            prefix=0, impl=impl)
    for i in range(done, cfg.num_layers):
        x = mamba_layer(i)(x)
    return x


def _backbone(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
              prefix_embeds: torch.Tensor | None = None,
              impl: str = "reference", moe_impl: str = "gather",
              remat: bool = False):
    check_impl(impl)
    x = shard_ctx.constrain_act(embed(params["embed"], tokens))
    prefix = 0
    if prefix_embeds is not None:
        x = shard_ctx.constrain_act(
            torch.cat([prefix_embeds.to(x.dtype), x], dim=1))
        # bidirectional over the image patches; audio's prefix is causal
        prefix = prefix_embeds.shape[1] if cfg.family == "vlm" else 0
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = params["blocks"]
    if cfg.family in ("dense", "vlm", "audio"):
        # gemma3's mixed stack: each layer with its own window (1024 local,
        # 0 global), which the reference's `_dyn_window_block` masks
        for i, win in enumerate(layer_windows(cfg)):
            x = _remat(lambda h, bp=_layer(blocks, i), w=int(win):
                       shard_ctx.constrain_act(_attn_mlp_block(
                           bp, cfg, h, window=w, prefix=prefix, impl=impl)),
                       remat)(x)
    elif cfg.family == "moe":
        for i in range(cfg.num_layers):
            x, a = _remat(lambda h, bp=_layer(blocks, i): _attn_moe_block(
                bp, cfg, h, impl=impl, moe_impl=moe_impl), remat)(x)
            x = shard_ctx.constrain_act(x)
            aux = aux + a
    elif cfg.family in ("ssm", "hybrid"):
        x = _hybrid_forward(params, cfg, x, impl=impl, remat=remat)
    else:
        raise ValueError(cfg.family)
    return x, aux


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   prefix_embeds: torch.Tensor | None = None,
                   impl: str = "reference", moe_impl: str = "gather",
                   remat: bool = False):
    """Backbone only: tokens -> (final hidden (B,S,D) pre-unembed, aux)."""
    return _backbone(params, cfg, tokens, prefix_embeds=prefix_embeds,
                     impl=impl, moe_impl=moe_impl, remat=remat)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embeds: torch.Tensor | None = None,
            impl: str = "reference", moe_impl: str = "gather",
            remat: bool = False, last_only: bool = False):
    """tokens (B,S) [+ prefix (B,P,D)] -> (logits, aux_loss).

    last_only=True unembeds just the final position (serving prefill),
    so no (B, S, V) logits tensor is made."""
    x, aux = _backbone(params, cfg, tokens, prefix_embeds=prefix_embeds,
                       impl=impl, moe_impl=moe_impl, remat=remat)
    if last_only:
        x = x[:, -1:, :]
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params["embed"], x), aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def streamed_cross_entropy(params: Params, cfg: ModelConfig, x: torch.Tensor,
                           labels: torch.Tensor,
                           block: int = 256) -> torch.Tensor:
    """Blockwise unembed + softmax cross entropy over the sequence: no
    (B, S, V) logits tensor is made, and with gradients on each block is
    checkpointed, so the backward recomputes its logits instead of
    keeping (B, block, V) fp32 per block.

    x is the PRE-ln_f hidden (B,S,D); labels (B,S)."""
    b, s, _ = x.shape
    block = min(block, s)
    labels = labels.long()

    def nll_sum(xc, lc):
        h = rmsnorm(params["ln_f"], xc, cfg.norm_eps)
        logits = unembed(params["embed"], h).float()
        return torch.sum(logsumexp_last(logits) - label_logits(logits, lc))

    part = _remat(nll_sum, True)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, block):
        total = total + part(x[:, i:i + block], labels[:, i:i + block])
    return total / (b * s)


def loss_fn(params: Params, cfg: ModelConfig, batch: dict, *,
            impl: str = "reference", moe_impl: str = "gather",
            remat: bool = False, ce_block: int | None = None):
    """batch: {tokens (B,S), labels (B,S), [prefix_embeds (B,P,D)],
    [mask (B,S)]} -> (loss, {"ce", "aux"}): the next-token cross entropy
    over the token positions plus router_aux_coef * the MoE aux loss.

    ce_block: if set, the streamed cross entropy (launch-scale steps)."""
    prefix_embeds = batch.get("prefix_embeds")
    if ce_block:
        x, aux = forward_hidden(params, cfg, batch["tokens"],
                                prefix_embeds=prefix_embeds, impl=impl,
                                moe_impl=moe_impl, remat=remat)
        if prefix_embeds is not None:
            x = x[:, prefix_embeds.shape[1]:]
        ce = streamed_cross_entropy(params, cfg, x, batch["labels"],
                                    block=ce_block)
    else:
        logits, aux = forward(params, cfg, batch["tokens"],
                              prefix_embeds=prefix_embeds, impl=impl,
                              moe_impl=moe_impl, remat=remat)
        if prefix_embeds is not None:
            logits = logits[:, prefix_embeds.shape[1]:]
        ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    ce, aux = shard_ctx.replicated(ce), shard_ctx.replicated(aux)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodeState:
    """Decode caches and position counter.

    caches, by family, on the model's device, updated in place by
    `decode_step`:
      dense/vlm/audio/moe: {"kv": [{"k", "v"} per kv group]}, each
              (L_g, B, S, Hkv, hd);
      ssm:    {"ssm": {"ssm" (L, B, nh, hp, ns), "conv" (L, B, K-1, C)}};
      hybrid: {"ssm": ..., "shared_kv": {"k", "v"}}, one (B, S, Hkv, hd)
              cache per application of the shared block.
    position: an int or 0-d tensor (every slot at the same position) or
    a (B,) integer tensor (per-slot positions, continuous batching), read
    on the host unless `decode_step(device_positions=True)` keeps it on
    the model's device. Group metadata comes from kv_group_spec(cfg,
    max_seq).
    """

    caches: Params
    position: torch.Tensor | int


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device=None) -> DecodeState:
    """Zeroed caches: KV caches in ``dtype``; the SSM and conv states in
    fp32, as the reference makes them."""
    device = resolve_device(device)
    caches: Params = {}
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        caches["kv"] = [
            init_kv_cache(cfg, batch, clen, dtype, layers=len(idx),
                          device=device)
            for idx, clen, _ in kv_group_spec(cfg, max_seq)]
    if cfg.family in ("ssm", "hybrid"):
        caches["ssm"] = mamba2.init_ssm_cache(cfg, batch, device=device)
    if cfg.family == "hybrid":
        clen = max_seq if cfg.sliding_window == 0 else min(
            cfg.sliding_window, max_seq)
        caches["shared_kv"] = init_kv_cache(
            cfg, batch, clen, dtype, layers=num_shared_attn_apps(cfg),
            device=device)
    return DecodeState(caches=caches,
                       position=torch.zeros((), dtype=torch.int64))


@dataclasses.dataclass(frozen=True)
class SlotIndex:
    """One step's per-slot index tensors for caches of one length, made
    once per step and shared by that group's layers."""

    rope_pos: torch.Tensor     # (B, 1) positions, on the model's device
    rows: torch.Tensor         # (B,) slot rows
    wpos: torch.Tensor         # (B,) ring-buffer write index, pos % len
    lengths: torch.Tensor | None  # (B,) int32 valid rows on the host, or None
    lengths_dev: torch.Tensor  # the same, int32 on the model's device


def slot_index(pos: torch.Tensor, cache_len: int, device) -> SlotIndex:
    """pos: (B,) int64 positions, on the host or on ``device``.

    Host positions on a card are staged in pinned memory and copied over
    once a step. Positions already on the card (`decode_step`'s
    device_positions=True) stay there: every index is derived on the
    card, nothing is read back and `lengths` is None, so the attention
    checks no range and the step can be captured in a CUDA graph that
    reads its positions from a static buffer."""
    rows = torch.arange(pos.shape[0], device=device)
    lengths = torch.clamp(pos + 1, max=cache_len).to(torch.int32)
    if pos.device == device:
        return SlotIndex(rope_pos=pos[:, None], rows=rows,
                         wpos=pos % cache_len,
                         lengths=lengths if device.type == "cpu" else None,
                         lengths_dev=lengths)
    host = torch.stack([pos, pos % cache_len, lengths.long()])
    dev = host.pin_memory().to(device, non_blocking=True)
    return SlotIndex(rope_pos=dev[0][:, None], rows=rows, wpos=dev[1],
                     lengths=lengths, lengths_dev=dev[2].to(torch.int32))


def _decode_attn(bp, cfg, x, k_cache, v_cache, idx: SlotIndex,
                 impl: str = "reference"):
    """One-token GQA attention against a (ring-buffer) KV cache.

    A window is realised by the ring overwrite itself: a cache of length
    min(window, max_seq) holds exactly the last that many keys; the ring
    buffer's valid rows are `idx.lengths`. impl="kernel" routes through
    the flash-decode op, which reads the cache in place; the others
    through its plain version, on a transposed view.
    """
    q, k, v = _project_qkv(bp["attn"], cfg, x)
    q = apply_rope(q, idx.rope_pos, cfg.rope_theta)
    k = apply_rope(k, idx.rope_pos, cfg.rope_theta)
    out = cache_attend(q[:, 0], k[:, 0], v[:, 0], k_cache, v_cache, idx,
                       impl=impl)
    out = shard_ctx.merge_last(out)[:, None]
    return out @ bp["attn"]["wo"], k_cache, v_cache


def cache_attend(q, k, v, k_cache, v_cache, idx: SlotIndex, *,
                 impl: str = "reference"):
    """Write this token's k/v (B,Hkv,hd) into the caches (B,S,Hkv,hd) at
    the slots' ring positions, then attend q (B,Hq,hd) against them ->
    (B,Hq,hd): the flash-decode kernel (impl="kernel"), which reads the
    cache in place, or its plain version on a transposed view.

    DTensor caches stay as they lie: each rank writes and reads its own
    (batch, sequence, head) shard, q/k/v laid out to match. Where the
    layout splits the SEQUENCE over mesh axes (`decode_cache_specs`'
    fallback when Hkv does not divide the model axis, kv_seq_shard, or a
    batch of 1), each rank attends over its own keys and the partial
    softmax is combined over those axes (flash decoding); the kernel
    reads whole sequences, so it refuses such a layout."""
    if shard_ctx.is_dtensor(k_cache):
        return _cache_attend_sharded(q, k, v, k_cache, v_cache, idx, impl)
    k_cache[idx.rows, idx.wpos] = k
    v_cache[idx.rows, idx.wpos] = v
    if impl == "kernel":
        return da_ops.decode_attention(q, k_cache, v_cache, idx.lengths,
                                       lengths_dev=idx.lengths_dev)
    return decode_attention_ref(q, k_cache.transpose(1, 2),
                                v_cache.transpose(1, 2), idx.lengths_dev)


def _cache_attend_sharded(q, k, v, k_cache, v_cache, idx: SlotIndex, impl):
    from torch.distributed.tensor import Replicate, Shard

    mesh, cpl = k_cache.device_mesh, tuple(k_cache.placements)
    # (B,S,Hkv,hd) cache dims -> (B,H,hd) token dims: batch 0, heads 1
    tpl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
           else Replicate() for p in cpl]
    seq_dims = [i for i, p in enumerate(cpl) if p == Shard(1)]
    if seq_dims and impl == "kernel":
        names = [mesh.mesh_dim_names[i] for i in seq_dims]
        raise ValueError(
            f"decode_attention kernel: this KV cache layout ({cpl} on mesh "
            f"axes {mesh.mesh_dim_names}) shards the sequence over {names}; "
            f"the kernel reads whole sequences: decode this layout with "
            f"impl='chunked' or 'reference'")
    size, off = shard_ctx.local_box(tuple(k_cache.shape), mesh, cpl)
    rows = slice(off[0], off[0] + size[0])

    def local(ql, kl, vl, kc, vc):
        lidx = SlotIndex(
            rope_pos=idx.rope_pos[rows], wpos=idx.wpos[rows],
            rows=torch.arange(kc.shape[0], device=kc.device),
            lengths=None if idx.lengths is None else idx.lengths[rows],
            lengths_dev=idx.lengths_dev[rows])
        if not seq_dims:
            return cache_attend(ql, kl, vl, kc, vc, lidx, impl=impl)
        return _seq_partial_attend(ql, kl, vl, kc, vc, lidx, off[1],
                                   [(mesh, i) for i in seq_dims])

    return shard_ctx.run_local(local, (q, k, v, k_cache, v_cache),
                               (tpl, tpl, tpl, None, None), tpl,
                               tuple(q.shape))


def _seq_partial_attend(q, k, v, kc, vc, idx: SlotIndex, s0: int, groups):
    """Flash decoding over a cache shard holding keys [s0, s0 + S_l): the
    owning rank writes each slot's token, every rank scores its own keys,
    and the softmax's max, sum and weighted values are all-reduced over
    the ``groups`` (mesh, dim) that split the sequence. The products run
    in the cache's type, as `decode_attention_ref`'s do (scores, then
    probabilities cast to v's type); the softmax and the sums over ranks
    in fp32."""
    from torch.distributed import _functional_collectives as funcol

    b, s_l = kc.shape[0], kc.shape[1]
    w = idx.wpos - s0
    mine = ((w >= 0) & (w < s_l))[:, None, None]
    w = w.clamp(0, max(s_l - 1, 0))
    kc[idx.rows, w] = torch.where(mine, k, kc[idx.rows, w])
    vc[idx.rows, w] = torch.where(mine, v, vc[idx.rows, w])
    hq, hd = q.shape[1], q.shape[2]
    hkv = kc.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd)
    sc = torch.einsum("bhgd,bkhd->bhgk", qg, kc).float() / math.sqrt(hd)
    j = s0 + torch.arange(s_l, device=kc.device)
    ok = (j[None, :] < idx.lengths_dev[:, None])[:, None, None, :]
    sc = torch.where(ok, sc, NEG_INF)
    m = sc.amax(-1)
    for g in groups:
        m = funcol.all_reduce(m, "max", g)
    p = torch.where(ok, torch.exp(sc - m[..., None]), 0.0)
    den = p.sum(-1)
    acc = torch.einsum("bhgk,bkhd->bhgd", p.to(vc.dtype), vc).float()
    for g in groups:
        den = funcol.all_reduce(den, "sum", g)
        acc = funcol.all_reduce(acc, "sum", g)
    return (acc / den[..., None]).reshape(b, hq, hd).to(v.dtype)


def _decode_attn_ffn_block(bp, cfg, x, k_cache, v_cache, idx: SlotIndex,
                           impl: str = "reference",
                           moe_impl: str = "gather"):
    xn = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    y, k_cache, v_cache = _decode_attn(bp, cfg, xn, k_cache, v_cache, idx,
                                       impl=impl)
    h = x + y
    if "moe" in bp:
        # (B, 1, D): each slot routes its one token (capacity 1 a row)
        y2, _ = moe_mod.moe(bp["moe"], cfg,
                            rmsnorm(bp["ln2"], h, cfg.norm_eps),
                            impl=moe_impl)
    else:
        y2 = mlp(bp["mlp"], rmsnorm(bp["ln2"], h, cfg.norm_eps),
                 cfg.mlp_act)
    return h + y2, k_cache, v_cache


def _mamba_decode_block(bp, cfg, x, caches, layer: int):
    """One Mamba2 layer at decode; its SSM and conv states (rows of the
    stacked caches) are updated in place."""
    xn = rmsnorm(bp["ln"], x, cfg.norm_eps)
    y, _, _ = mamba2.mamba_decode(bp["mamba"], cfg, xn,
                                  caches["ssm"]["ssm"][layer],
                                  caches["ssm"]["conv"][layer])
    return x + y


def _hybrid_decode(params, cfg, x, caches, pos, impl="reference"):
    """`_hybrid_forward`'s order at decode: each application of the shared
    block has its own KV cache and shares the block's weights."""
    k, apps = cfg.attn_every, num_shared_attn_apps(cfg)
    shared = _tree_map(shard_ctx.unshard, params.get("shared_attn", {}))
    if apps:
        kc, vc = caches["shared_kv"]["k"], caches["shared_kv"]["v"]
        idx = slot_index(pos, kc.shape[2], x.device)
    done = 0
    for app in range(apps):
        for i in range(done, done + k):
            x = _mamba_decode_block(_layer(params["blocks"], i), cfg, x,
                                    caches, i)
        done += k
        x, _, _ = _decode_attn_ffn_block(shared, cfg, x, kc[app], vc[app],
                                         idx, impl=impl)
    for i in range(done, cfg.num_layers):
        x = _mamba_decode_block(_layer(params["blocks"], i), cfg, x, caches,
                                i)
    return x


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                state: DecodeState, *, impl: str = "reference",
                moe_impl: str = "gather", device_positions: bool = False):
    """tokens (B,1) -> (logits (B,1,V), new state). impl="kernel" uses
    the flash-decode kernel for the attention-vs-cache step (every
    attention layer, and the hybrid's shared block; the Mamba2 layers'
    recurrent step is plain PyTorch for every impl, as in the reference).
    A moe layer routes each slot's token through ``moe_impl``.

    `state.position` may be a scalar (synchronized batch decode) or a
    (B,) vector (continuous batching: per-slot positions). It is read on
    the host, where the attention op (impl="kernel") refuses a negative
    one. With `device_positions` it must lie on the model's device and
    stays there: on the card the step then reads nothing back, and the
    serving engine captures it as one CUDA graph (`slot_index`); no
    range is checked, so the caller checks its positions first, as
    `ServingEngine` does before every step. The caches are written in
    place; the returned state holds the same cache tensors and position +
    1 (of the same shape)."""
    check_impl(impl)
    x = embed(params["embed"], tokens)
    b = tokens.shape[0]
    pos = torch.as_tensor(state.position)
    if not device_positions:
        pos = pos.cpu()
    elif pos.device != x.device:
        raise ValueError(f"decode_step: device_positions needs the "
                         f"positions on {x.device}, not {pos.device}")
    pos = torch.broadcast_to(torch.atleast_1d(pos.long()), (b,)).contiguous()
    caches = state.caches

    if cfg.family in ("ssm", "hybrid"):
        x = _hybrid_decode(params, cfg, x, caches, pos, impl=impl)
    else:
        # Recover max_seq from the largest cache: a window==0 group holds
        # the full sequence; in all-local stacks every cache is
        # min(window, max_seq) long and the spec is length-stable. As in
        # the reference, the layers run group by group.
        max_len = max(g["k"].shape[2] for g in caches["kv"])
        for gi, (layers, clen, _win) in enumerate(
                kv_group_spec(cfg, max_len)):
            idx = slot_index(pos, clen, x.device)
            kc, vc = caches["kv"][gi]["k"], caches["kv"][gi]["v"]
            for li, layer in enumerate(layers):
                x, _, _ = _decode_attn_ffn_block(
                    _layer(params["blocks"], layer), cfg, x, kc[li], vc[li],
                    idx, impl=impl, moe_impl=moe_impl)

    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x)
    return logits, DecodeState(caches=caches, position=state.position + 1)
