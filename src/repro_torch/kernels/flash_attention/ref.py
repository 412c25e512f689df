"""Plain PyTorch version of the flash attention kernel (counterpart of
`repro.kernels.flash_attention.ref`).

Layout matches the reference's oracle: q (B, Hq, Sq, hd), k/v
(B, Hkv, Sk, hd). Supports GQA (Hq a multiple of Hkv), causal masking,
a sliding window and a bidirectional prefix. It materialises the
(Sq, Sk) scores; the CPU tests and the card's comparisons use it, the
card's model path never does.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(sq: int, sk: int, *, causal: bool = True, window: int = 0,
                   prefix: int = 0, device=None) -> torch.Tensor:
    """(sq, sk) boolean mask; query i is at absolute position i+(sk-sq)."""
    off = sk - sq
    i = torch.arange(sq, device=device)[:, None] + off
    j = torch.arange(sk, device=device)[None, :]
    ok = (j <= i) if causal else torch.ones((sq, sk), dtype=torch.bool,
                                            device=device)
    if window > 0:
        ok = ok & ((i - j) < window)
    if prefix > 0:
        ok = ok | ((i < prefix) & (j < prefix))
    return ok


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        prefix: int = 0) -> torch.Tensor:
    b, hq, sq, hd = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    qg = q.reshape(b, hkv, group, sq, hd)
    # the reference divides by a numpy scalar, i.e. in fp32
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k).float() / math.sqrt(hd)
    ok = attention_mask(sq, sk, causal=causal, window=window, prefix=prefix,
                        device=q.device)
    scores = torch.where(ok[None, None, None], scores,
                         NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v)
    return out.reshape(b, hq, sq, hd)
