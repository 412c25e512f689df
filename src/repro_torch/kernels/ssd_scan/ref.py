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


# ---------------------------------------------------------------------------
# The same scan as three chunk-parallel passes (Mamba-2's SSD decomposition,
# Dao & Gu 2024, §6-7), the order in which the CUDA kernel's bf16 route
# computes it: (a) each chunk's own end state from zero, (b) the states
# passed from chunk to chunk, (c) each chunk's outputs from its inputs and
# the state entering it. fp32, on inputs whose length the chunk divides.
# With ``operands`` (e.g. torch.bfloat16) every operand the kernel forms
# in fp32 before a product enters it as the kernel's pair of that type, hi
# (rounded) + lo (the rest, rounded): the decayed, dt-weighted scores, the
# dt-weighted x of the state update and the state entering a chunk; x, B
# and C enter the products as they are. The main path never calls these:
# the tests hold the composition against `ssd_scan_ref` and the rounding
# against fp32.


def _round(t, dtype):
    return t if dtype is None else t.to(dtype).to(t.dtype)


def _round_hi_lo(t, dtype):
    """t as the sum of its rounding to ``dtype`` and the rounding of the
    rest."""
    if dtype is None:
        return t
    hi = _round(t, dtype)
    return hi + _round(t - hi, dtype)


def _split(x, dt, A, chunk):
    """x (b, nc, q, h, p), dt (b, nc, q, h) and acs = cumsum(dt * A) over
    each chunk."""
    b, s, h, p = x.shape
    if chunk <= 0 or s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    dtc = dt.reshape(b, nc, chunk, h)
    return (x.reshape(b, nc, chunk, h, p), dtc,
            torch.cumsum(dtc * A, dim=2))


def ssd_chunk_states(x, dt, A, B, *, chunk: int, operands=None):
    """Pass (a): per chunk, its end state from a zero start, inj_c =
    Σ_k (dt_k·exp(acs_end − acs_k)·x_k)ᵀ B_k, (b, nc, h, p, n), and its
    decay exp(acs_end), (b, nc, h)."""
    xc, dtc, acs = _split(x, dt, A, chunk)
    b, nc = xc.shape[:2]
    Bc = B.reshape(b, nc, chunk, B.shape[-1])
    w = dtc * torch.exp(acs[:, :, -1:] - acs)           # (b,nc,q,h)
    xw = _round_hi_lo(xc * w[..., None], operands)
    return (torch.einsum("bcqhp,bcqn->bchpn", xw, Bc),
            torch.exp(acs[:, :, -1]))


def ssd_state_passing(inj, decay):
    """Pass (b): the state entering each chunk, state_0 = 0 and
    state_{c+1} = state_c·decay_c + inj_c, (b, nc, h, p, n), in fp32."""
    states = torch.zeros_like(inj)
    run = torch.zeros_like(inj[:, 0])
    for c in range(inj.shape[1] - 1):
        run = run * decay[:, c, :, None, None] + inj[:, c]
        states[:, c + 1] = run
    return states


def ssd_chunk_scan(x, dt, A, B, C, states, *, chunk: int, operands=None):
    """Pass (c): y = (C·Bᵀ ⊙ exp(mask(acs_q − acs_k)) ⊙ dt_k) @ x
    + (C @ state_inᵀ)·exp(acs_q), chunk by chunk, the mask applied before
    exp."""
    xc, dtc, acs = _split(x, dt, A, chunk)
    b, nc, q, h, p = xc.shape
    n = B.shape[-1]
    Bc, Cc = B.reshape(b, nc, q, n), C.reshape(b, nc, q, n)
    iq = torch.arange(q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[:, :, None]   # (q,k,1)
    gap = acs[:, :, :, None, :] - acs[:, :, None, :, :]  # (b,nc,q,k,h)
    decay = torch.exp(torch.where(causal, gap, -torch.inf))
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    pm = _round_hi_lo(scores[..., None] * decay * dtc[:, :, None], operands)
    y = torch.einsum("bcqkh,bckhp->bcqhp", pm, xc)
    y = y + torch.einsum("bcqn,bchpn->bcqhp", Cc,
                         _round_hi_lo(states, operands)) \
        * torch.exp(acs)[..., None]
    return y.reshape(b, nc * q, h, p)


def ssd_scan_passes(x, dt, A, B, C, *, chunk: int, operands=None):
    """Passes (a), (b) and (c) in turn: `ssd_scan_ref`'s result."""
    inj, decay = ssd_chunk_states(x, dt, A, B, chunk=chunk,
                                  operands=operands)
    return ssd_chunk_scan(x, dt, A, B, C, ssd_state_passing(inj, decay),
                          chunk=chunk, operands=operands)
