"""Model assembler (counterpart of `repro.models.transformer`).

Parameters are a nested dict of tensors with the reference's names and
shapes: `(in, out)` matrices, and `blocks` stacked on a leading layer
axis. The forward runs a Python loop over the layers; the caches of
`decode_step` (KV caches, SSM and conv states) are updated in place.

Families in this port so far, prefill and decode:
  dense  -- pre-norm attention + gated-MLP blocks (yi-9b, qwen2, qwen2.5);
  ssm    -- Mamba2 (SSD) blocks (mamba2-370m);
  hybrid -- a Mamba2 backbone and ONE shared attention/MLP block applied
      after every `attn_every` layers (zamba2): shared weights, a KV
      cache of its own per application at decode.
Each other family raises NotImplementedError naming its ROADMAP item:
moe, vlm, audio, and gemma3's mixed local/global stack in the prefill
forward.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import mamba2
from repro_torch.models.attention import (_project_qkv, attention, attn_init,
                                          check_impl, init_kv_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Params, apply_rope, embed, embed_init,
                                       mlp, mlp_init, rmsnorm, rmsnorm_init,
                                       unembed)

_TODO = {
    "moe": "ROADMAP queue 1 #7 (MoE blocks, models/moe.py)",
    "vlm": "ROADMAP queue 1 #7 (vision/audio frontends)",
    "audio": "ROADMAP queue 1 #7 (vision/audio frontends)",
}


def _unported(cfg: ModelConfig, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{cfg.name}: {what} of the {cfg.family} family is not ported yet; "
        f"see {_TODO.get(cfg.family, 'ROADMAP queue 1 #7')}")


_PORTED = ("dense", "ssm", "hybrid")


def _check_ported(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in _PORTED:
        raise _unported(cfg, what)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


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
    if cfg.family == "dense":
        return _attn_mlp_init(gen, cfg, device)
    return {  # ssm, hybrid
        "ln": rmsnorm_init(cfg.d_model, device=device),
        "mamba": mamba2.mamba_init(gen, cfg, _dtype(cfg), device=device),
    }


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
    """Layer i's params: views into the stacked blocks."""
    return _tree_map(lambda a: a[i], blocks)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random weights in the reference's distribution: normal * 1/sqrt
    (fan_in) matrices, embedding * 0.02, norm scales 1, biases 0, cast to
    `cfg.dtype` (norm scales and the Mamba2 A_log, D and dt_bias stay
    fp32). Drawn layer by layer from ``generator`` on ``device`` (the
    card by default), so the full model never passes through the host;
    the generator must live there. A hybrid model also gets its one
    `shared_attn` block."""
    cfg.validate()
    _check_ported(cfg, "init_params")
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
    nesting, shapes, types and bits."""
    if isinstance(params, dict):
        return {k: params_from_reference(v, device) for k, v in params.items()}
    return _to_tensor(np.asarray(params), device)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _attn_mlp_block(bp: Params, cfg: ModelConfig, x, *, window, prefix,
                    impl):
    h = x + attention(bp["attn"], cfg, rmsnorm(bp["ln1"], x, cfg.norm_eps),
                      window=window, prefix=prefix, impl=impl)
    h = h + mlp(bp["mlp"], rmsnorm(bp["ln2"], h, cfg.norm_eps), cfg.mlp_act)
    return h


def _mamba_block(bp: Params, cfg: ModelConfig, x, *, impl):
    return x + mamba2.mamba_forward(
        bp["mamba"], cfg, rmsnorm(bp["ln"], x, cfg.norm_eps), impl=impl)


def _hybrid_forward(params, cfg, x, *, impl):
    """Mamba2 backbone (ssm, hybrid). In a hybrid the shared attention
    block runs after each segment of attn_every layers (weights shared
    across applications), then the tail segment, if any, runs without it;
    an ssm model is all tail."""
    k = cfg.attn_every
    done = 0
    for _ in range(num_shared_attn_apps(cfg)):
        for i in range(done, done + k):
            x = _mamba_block(_layer(params["blocks"], i), cfg, x, impl=impl)
        done += k
        x = _attn_mlp_block(params["shared_attn"], cfg, x,
                            window=cfg.sliding_window, prefix=0, impl=impl)
    for i in range(done, cfg.num_layers):
        x = _mamba_block(_layer(params["blocks"], i), cfg, x, impl=impl)
    return x


def _backbone(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
              prefix_embeds: torch.Tensor | None = None,
              impl: str = "reference"):
    check_impl(impl)
    _check_ported(cfg, "the forward")
    x = embed(params["embed"], tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    if cfg.family in ("ssm", "hybrid"):
        x = _hybrid_forward(params, cfg, x, impl=impl)
    else:
        wins = layer_windows(cfg)
        if not (wins == wins[0]).all():
            raise NotImplementedError(
                f"{cfg.name}: the mixed local/global stack "
                "(_dyn_window_block) is not ported yet; see ROADMAP queue 1 "
                "#7")
        w0 = int(wins[0])
        for i in range(cfg.num_layers):
            x = _attn_mlp_block(_layer(params["blocks"], i), cfg, x,
                                window=w0, prefix=0, impl=impl)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   prefix_embeds: torch.Tensor | None = None,
                   impl: str = "reference"):
    """Backbone only: tokens -> (final hidden (B,S,D) pre-unembed, aux)."""
    return _backbone(params, cfg, tokens, prefix_embeds=prefix_embeds,
                     impl=impl)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embeds: torch.Tensor | None = None,
            impl: str = "reference", last_only: bool = False):
    """tokens (B,S) [+ prefix (B,P,D)] -> (logits, aux_loss).

    last_only=True unembeds just the final position (serving prefill),
    so no (B, S, V) logits tensor is made."""
    x, aux = _backbone(params, cfg, tokens, prefix_embeds=prefix_embeds,
                       impl=impl)
    if last_only:
        x = x[:, -1:, :]
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params["embed"], x), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodeState:
    """Decode caches and position counter.

    caches, by family, on the model's device, updated in place by
    `decode_step`:
      dense:  {"kv": [{"k", "v"} per kv group]}, each (L_g, B, S, Hkv, hd);
      ssm:    {"ssm": {"ssm" (L, B, nh, hp, ns), "conv" (L, B, K-1, C)}};
      hybrid: {"ssm": ..., "shared_kv": {"k", "v"}}, one (B, S, Hkv, hd)
              cache per application of the shared block.
    position: an int or 0-d tensor (every slot at the same position) or
    a (B,) integer tensor (per-slot positions, continuous batching),
    kept on the host. Group metadata comes from kv_group_spec(cfg,
    max_seq).
    """

    caches: Params
    position: torch.Tensor | int


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device=None) -> DecodeState:
    """Zeroed caches: KV caches in ``dtype``; the SSM and conv states in
    fp32, as the reference makes them."""
    if cfg.family not in ("dense", "vlm", "audio", "ssm", "hybrid"):
        raise _unported(cfg, "init_decode_state")
    device = resolve_device(device)
    caches: Params = {}
    if cfg.family in ("dense", "vlm", "audio"):
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
    lengths: torch.Tensor      # (B,) int32 valid rows, on the host
    lengths_dev: torch.Tensor  # the same, int32 on the model's device


def slot_index(pos: torch.Tensor, cache_len: int, device) -> SlotIndex:
    """pos: (B,) int64 positions on the host."""
    lengths = torch.clamp(pos + 1, max=cache_len).to(torch.int32)
    host = torch.stack([pos, pos % cache_len, lengths.long()])
    if device.type == "cuda":
        dev = host.pin_memory().to(device, non_blocking=True)
    else:
        dev = host.to(device)
    return SlotIndex(rope_pos=dev[0][:, None], rows=torch.arange(
        pos.shape[0], device=device), wpos=dev[1], lengths=lengths,
        lengths_dev=dev[2].to(torch.int32))


def _decode_attn(bp, cfg, x, k_cache, v_cache, idx: SlotIndex,
                 impl: str = "reference"):
    """One-token GQA attention against a (ring-buffer) KV cache.

    A window is realised by the ring overwrite itself: a cache of length
    min(window, max_seq) holds exactly the last that many keys; the ring
    buffer's valid rows are `idx.lengths`. impl="kernel" routes through
    the flash-decode op, which reads the cache in place; the others
    through its plain version, on a transposed view.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(bp["attn"], cfg, x)
    q = apply_rope(q, idx.rope_pos, cfg.rope_theta)
    k = apply_rope(k, idx.rope_pos, cfg.rope_theta)
    k_cache[idx.rows, idx.wpos] = k[:, 0]
    v_cache[idx.rows, idx.wpos] = v[:, 0]

    if impl == "kernel":
        out = da_ops.decode_attention(q[:, 0], k_cache, v_cache, idx.lengths,
                                      lengths_dev=idx.lengths_dev)
    else:
        out = decode_attention_ref(q[:, 0], k_cache.transpose(1, 2),
                                   v_cache.transpose(1, 2), idx.lengths_dev)
    return out.reshape(b, 1, cfg.q_dim) @ bp["attn"]["wo"], k_cache, v_cache


def _decode_attn_ffn_block(bp, cfg, x, k_cache, v_cache, idx: SlotIndex,
                           impl: str = "reference"):
    xn = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    y, k_cache, v_cache = _decode_attn(bp, cfg, xn, k_cache, v_cache, idx,
                                       impl=impl)
    h = x + y
    y2 = mlp(bp["mlp"], rmsnorm(bp["ln2"], h, cfg.norm_eps), cfg.mlp_act)
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
    if apps:
        kc, vc = caches["shared_kv"]["k"], caches["shared_kv"]["v"]
        idx = slot_index(pos, kc.shape[2], x.device)
    done = 0
    for app in range(apps):
        for i in range(done, done + k):
            x = _mamba_decode_block(_layer(params["blocks"], i), cfg, x,
                                    caches, i)
        done += k
        x, _, _ = _decode_attn_ffn_block(params["shared_attn"], cfg, x,
                                         kc[app], vc[app], idx, impl=impl)
    for i in range(done, cfg.num_layers):
        x = _mamba_decode_block(_layer(params["blocks"], i), cfg, x, caches,
                                i)
    return x


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                state: DecodeState, *, impl: str = "reference"):
    """tokens (B,1) -> (logits (B,1,V), new state). impl="kernel" uses
    the flash-decode kernel for the attention-vs-cache step (the dense
    layers and the hybrid's shared block; the Mamba2 layers' recurrent
    step is plain PyTorch for every impl, as in the reference).

    `state.position` may be a scalar (synchronized batch decode) or a
    (B,) vector (continuous batching: per-slot positions). The caches are
    written in place; the returned state holds the same cache tensors and
    position + 1 (of the same shape)."""
    check_impl(impl)
    _check_ported(cfg, "decode_step")
    x = embed(params["embed"], tokens)
    b = tokens.shape[0]
    pos = torch.as_tensor(state.position).cpu().long()
    pos = torch.broadcast_to(torch.atleast_1d(pos), (b,)).contiguous()
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
                    idx, impl=impl)

    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x)
    return logits, DecodeState(caches=caches, position=state.position + 1)
