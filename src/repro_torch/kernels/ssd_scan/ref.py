"""Plain PyTorch SSD (Mamba-2) chunked scan: the counterpart of
`repro.kernels.ssd_scan.ref` and of `repro.models.mamba2.ssd_reference`,
and the one copy of that function in the port. `models.mamba2` calls it
on its reference path and `ops.ssd_scan` on CPU tensors.

A Python loop over chunks. Per chunk, the within-chunk dual form
`(C·Bᵀ ⊙ exp(segsum)) @ (dt·x)` with the causal mask applied before
`exp` (masked entries are exactly 0), plus the carried state's term
`(C @ stateᵀ)·exp(cumsum)`; then the (p, n) state decays over the chunk
and takes the chunk's dt-weighted inputs. Everything, the state
included, is computed in the inputs' one type, as the reference does
when its inputs share one.
"""

from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, A, B, C, *, chunk: int) -> torch.Tensor:
    """x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n) -> y (b,s,h,p).

    ``chunk`` must divide s (the reference's oracle asserts it; the op
    pads first)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = chunk
    if q <= 0 or s % q:
        # the reference asserts this (mamba2.py:93)
        raise ValueError(f"seq {s} not divisible by chunk {q}")

    iq = torch.arange(q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]  # (1,q,k,1)
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for c in range(s // q):
        sl = slice(c * q, (c + 1) * q)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        a = dtc * A                                  # (b,q,h) negative
        acs = torch.cumsum(a, dim=1)                  # (b,q,h)
        dtx = xc * dtc[..., None]                     # (b,q,h,p)

        # within-chunk dual form; mask BEFORE exp
        gap = acs[:, :, None, :] - acs[:, None, :, :]  # (b,q,k,h)
        decay = torch.exp(torch.where(causal, gap, -torch.inf))
        scores = torch.einsum("bqn,bkn->bqk", Cc, Bc)
        y_diag = torch.einsum("bqk,bqkh,bkhp->bqhp", scores, decay, dtx)

        # contribution of the carried state
        y_inter = torch.einsum("bqn,bqh,bhpn->bqhp", Cc, torch.exp(acs),
                               state)

        # state update: decay the whole chunk, inject dt-weighted inputs
        to_end = torch.exp(acs[:, -1:, :] - acs)      # (b,q,h)
        inj = torch.einsum("bkn,bkh,bkhp->bhpn", Bc, to_end, dtx)
        state = state * torch.exp(acs[:, -1, :])[..., None, None] + inj
        ys.append(y_diag + y_inter)
    if not ys:
        return torch.zeros((b, 0, h, p), dtype=x.dtype, device=x.device)
    return torch.cat(ys, dim=1)
