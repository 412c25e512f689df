"""Grouped-query attention: prefill forward and single-token decode
(counterpart of `repro.models.attention`).

Three implementations, selected by `impl`:
  * "reference" -- einsum + masked softmax over the full (S, S) scores.
  * "chunked"   -- online softmax over key blocks in plain PyTorch,
    O(S * block) memory.
  * "kernel"    -- `repro_torch.kernels.flash_attention`: the CUDA kernel
    on a card, its plain version on the CPU (the reference's
    impl="pallas").

Masking supports causal, sliding-window and a bidirectional prefix.
Layouts are the reference's: q (B, S, Hq, hd), k/v (B, S, Hkv, hd).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import shard_ctx
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _dense_init, apply_rope

NEG_INF = -1e30
IMPLS = ("reference", "chunked", "kernel")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; have {IMPLS}")


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype,
              device=None) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": _dense_init(gen, (d, qd), dtype=dtype, device=device),
        "wk": _dense_init(gen, (d, kvd), dtype=dtype, device=device),
        "wv": _dense_init(gen, (d, kvd), dtype=dtype, device=device),
        "wo": _dense_init(gen, (qd, d), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        device = gen.device if device is None else device
        for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = shard_ctx.constrain_heads(
        shard_ctx.split_last(q, (cfg.num_heads, cfg.head_dim)))
    k = shard_ctx.constrain_heads(
        shard_ctx.split_last(k, (cfg.num_kv_heads, cfg.head_dim)))
    v = shard_ctx.constrain_heads(
        shard_ctx.split_last(v, (cfg.num_kv_heads, cfg.head_dim)))
    return q, k, v


def build_mask(seq: int, *, window: int = 0, prefix: int = 0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """(seq, seq) additive mask: causal, optional window, optional prefix."""
    i = torch.arange(seq, device=device)[:, None]
    j = torch.arange(seq, device=device)[None, :]
    ok = j <= i
    if window > 0:
        ok = ok & ((i - j) < window)
    if prefix > 0:
        ok = ok | ((i < prefix) & (j < prefix))
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def reference_attention(q, k, v, mask: torch.Tensor | None) -> torch.Tensor:
    """q (B,S,Hq,hd), k/v (B,S,Hkv,hd) -> (B,S,Hq,hd). Plain oracle."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, s, hkv, group, hd)
    # the reference divides by a numpy scalar, i.e. in fp32
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, s, hq, hd)


def chunked_attention(q, k, v, *, window: int = 0, prefix: int = 0,
                      block: int = 512) -> torch.Tensor:
    """Online softmax over key blocks of `block`: O(S * block) memory.
    Layout: q (B,S,Hq,hd), k/v (B,S,Hkv,hd)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    block = min(block, s)
    dev = q.device
    qg = q.reshape(b, s, hkv, g, hd).float()
    scale = 1.0 / math.sqrt(hd)
    ipos = torch.arange(s, device=dev)
    m = torch.full((b, hkv, g, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, s, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, s, block):
        kc = k[:, k0:k0 + block].float()
        vc = v[:, k0:k0 + block].float()
        jpos = torch.arange(k0, k0 + kc.shape[1], device=dev)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc) * scale
        ok = jpos[None, :] <= ipos[:, None]
        if window > 0:
            ok = ok & ((ipos[:, None] - jpos[None, :]) < window)
        if prefix > 0:
            ok = ok | ((ipos[:, None] < prefix) & (jpos[None, :] < prefix))
        sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        safe = m_new > NEG_INF / 2
        alpha = torch.where(safe, torch.exp(m - m_new), 0.0)
        pmat = torch.exp(sc - torch.where(safe, m_new, 0.0)[..., None])
        pmat = torch.where(ok, pmat, 0.0)
        l = alpha * l + pmat.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                    pmat, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd).to(q.dtype)


def attention(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              window: int = 0, prefix: int = 0,
              impl: str = "reference") -> torch.Tensor:
    """Full-sequence (prefill) attention."""
    check_impl(impl)
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    pos = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = attend(q, k, v, window=window, prefix=prefix, impl=impl)
    return shard_ctx.merge_last(out) @ p["wo"]


def attend(q, k, v, *, window: int = 0, prefix: int = 0,
           impl: str = "reference") -> torch.Tensor:
    """The attention core through ``impl``: q (B,S,Hq,hd), k/v
    (B,S,Hkv,hd) -> (B,S,Hq,hd). DTensors run on each rank's head shard
    (`head_local`)."""
    if shard_ctx.is_dtensor(q):
        return head_local(lambda a, b_, c: attend(
            a, b_, c, window=window, prefix=prefix, impl=impl), q, k, v)
    if impl == "kernel":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                      prefix=prefix)
    if impl == "chunked":
        return chunked_attention(q, k, v, window=window, prefix=prefix)
    mask = build_mask(q.shape[1], window=window, prefix=prefix,
                      device=q.device)
    return reference_attention(q, k, v, mask)


def _head_placements(q, k):
    """(q's, k/v's) placements for `head_local`: q heads (dim 2) over the
    mesh dim named "model", and k/v heads too where Hkv divides it
    (replicated otherwise); on every other mesh dim the batch (dim 0)
    stays sharded where q has it so, else replicated."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    qpl, kvpl = [], []
    for i, name in enumerate(mesh.mesh_dim_names):
        if name == "model":
            qpl.append(Shard(2))
            kvpl.append(Shard(2) if k.shape[2] % mesh.size(i) == 0
                        else Replicate())
        else:
            qpl.append(shard_ctx.batch_or_replicate(q, i))
            kvpl.append(qpl[-1])
    return tuple(qpl), tuple(kvpl)


def kv_heads_for(q0: int, nq: int, hq: int, hkv: int) -> torch.Tensor | slice:
    """The KV heads that q heads [q0, q0 + nq) read, as a slice when they
    keep the GQA layout (each contiguous run of q heads on one KV head),
    else as an index per q head (a group of 1)."""
    g = hq // hkv
    lo, hi = q0 // g, (q0 + nq - 1) // g + 1
    if nq % (hi - lo) == 0 and all(
            (q0 + i) // g - lo == i // (nq // (hi - lo)) for i in range(nq)):
        return slice(lo, hi)
    return torch.tensor([(q0 + i) // g for i in range(nq)])


def head_local(fn, q, k, v):
    """``fn(q, k, v)`` on each rank's head shard of DTensors q, k, v (the
    attention kernels' `local_map`): q's heads are split over "model";
    k/v's too where Hkv divides the axis, else each rank reads the KV
    heads of its own q heads from a replicated k/v. Returns the (B, S,
    Hq, hd) DTensor, heads sharded as q's."""
    qpl, kvpl = _head_placements(q, k)
    hq, hkv = q.shape[2], k.shape[2]
    size, off = shard_ctx.local_box(tuple(q.shape), q.device_mesh, qpl)
    kv_size, _ = shard_ctx.local_box(tuple(k.shape), q.device_mesh, kvpl)
    sel = slice(None)
    if size[2] and size[2] != hq and kv_size[2] == hkv:
        sel = kv_heads_for(off[2], size[2], hq, hkv)

    def local(ql, kl, vl):
        if not ql.shape[2]:
            return torch.zeros_like(ql)
        if isinstance(sel, torch.Tensor):
            kl = kl.index_select(2, sel.to(kl.device))
            vl = vl.index_select(2, sel.to(vl.device))
        elif sel != slice(None):
            kl, vl = kl[:, :, sel], vl[:, :, sel]
        return fn(ql, kl, vl)

    return shard_ctx.run_local(local, (q, k, v), (qpl, kvpl, kvpl), qpl,
                               tuple(q.shape))


# ---------------------------------------------------------------------------
# Decode (single token against a KV cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16, layers: int | None = None,
                  device=None) -> Params:
    """Stacked per-layer KV cache (L, B, S, Hkv, hd), zeros."""
    n = layers if layers is not None else cfg.num_layers
    shape = (n, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     position: int, *, window: int = 0,
                     lengths: torch.Tensor | None = None):
    """One-token decode. x (B,1,D); caches (B,S,Hkv,hd); position an int.

    Writes this token's k/v into the caches in place at `position` and
    returns (out (B,1,D), k_cache, v_cache).
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)  # (B,1,H,hd)
    pos = torch.full((1, 1), position, dtype=torch.int64, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    k_cache[:, position] = k[:, 0]
    v_cache[:, position] = v[:, 0]

    s = k_cache.shape[1]
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    group = hq // hkv
    qg = q.reshape(b, hkv, group, cfg.head_dim)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg,
                          k_cache).float() / math.sqrt(cfg.head_dim)
    j = torch.arange(s, device=x.device)
    ok = j <= position
    if window > 0:
        ok = ok & ((position - j) < window)
    if lengths is not None:
        ok = ok[None, :] & (j[None, :] < lengths.to(x.device)[:, None])
        scores = torch.where(ok[:, None, None, :], scores, NEG_INF)
    else:
        scores = torch.where(ok[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache)
    out = out.reshape(b, 1, cfg.q_dim) @ p["wo"]
    return out, k_cache, v_cache
