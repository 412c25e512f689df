"""Plain PyTorch version of the flash-decode kernel (counterpart of
`repro.kernels.decode_attention.ref`).

One query token per sequence against a KV cache, in the reference
oracle's layout: q (B, Hq, hd), k/v cache (B, Hkv, S, hd), lengths (B,)
valid prefix. `ops.decode_attention` hands it a transposed view of the
transformer's (B, S, Hkv, hd) cache; einsum reads it through its
strides.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, lengths) -> torch.Tensor:
    b, hq, hd = q.shape
    _, hkv, s, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd)
    # the reference divides by a numpy scalar, i.e. in fp32
    scores = torch.einsum("bhgd,bhkd->bhgk", qg, k).float() / math.sqrt(hd)
    ok = (torch.arange(s, device=q.device)[None, :]
          < lengths.to(q.device)[:, None])  # (B, S)
    scores = torch.where(ok[:, None, None, :], scores,
                         NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgk,bhkd->bhgd", probs, v)
    return out.reshape(b, hq, hd)
