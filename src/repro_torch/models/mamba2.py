"""Mamba2 (SSD, state-space duality) layer (counterpart of
`repro.models.mamba2`). [arXiv:2405.21060]

The forward runs the chunked SSD scan: the within-chunk dual form plus
the state carried from chunk to chunk. impl="kernel" hands it to
`kernels.ssd_scan.ops.ssd_scan` (the CUDA kernel on a card, its plain
version on the CPU), as the reference's impl="pallas" does; "reference"
and "chunked" run the plain scan in x's type, as the reference's other
branch does, with its limit that the chunk divide the sequence. Decode
keeps a constant-size recurrent state, updated in place.

Shapes: d_inner = expand * d_model, heads nh = d_inner / head_dim (hp),
one B/C group shared across heads, state size ns.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import shard_ctx
from repro_torch.models.attention import check_impl
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _dense_init


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype,
               device=None) -> Params:
    """The reference's distributions: `_dense_init` matrices, conv
    weights normal * 0.1, dt_bias 0, A_log = log(linspace(1, 16, nh)),
    D = 1, the last three in fp32. (The reference draws w_dt and out_proj
    from one key; here each matrix takes its own draws.)"""
    di, ns, nh = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    d = cfg.d_model
    device = gen.device if device is None else device

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_zx": _dense_init(gen, (d, 2 * di), dtype=dtype, device=device),
        "w_bc": _dense_init(gen, (d, 2 * ns), dtype=dtype, device=device),
        "w_dt": _dense_init(gen, (d, nh), dtype=dtype, device=device),
        "conv_x": normal((cfg.ssm_conv, di), 0.1),
        "conv_bc": normal((cfg.ssm_conv, 2 * ns), 0.1),
        "dt_bias": torch.zeros((nh,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "out_proj": _dense_init(gen, (di, d), dtype=dtype, device=device),
    }


def _project(cfg: ModelConfig, p: Params, xres: torch.Tensor):
    """-> z (…,di), xbc (…,di+2ns), dt (…,nh)."""
    di = cfg.ssm_inner
    zx = xres @ p["w_zx"]
    z, xin = zx[..., :di], zx[..., di:]
    bc = xres @ p["w_bc"]
    dt = xres @ p["w_dt"]
    return z, torch.cat([xin, bc], dim=-1), dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv over seq, K taps, then SiLU. xbc (B,S,C),
    w (K,C). With `state` (B,K-1,C) (decode) returns (out, new_state),
    the new state in xbc's type as in the reference."""
    k = w.shape[0]
    s = xbc.shape[1]
    if state is None:
        full = F.pad(xbc, (0, 0, k - 1, 0))
    else:
        full = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    out = full[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + full[:, i:i + s] * w[i]
    return F.silu(out), full[:, -(k - 1):]


def scan_inputs(p: Params, cfg: ModelConfig, xres: torch.Tensor):
    """The full-sequence front of the mixer: xres (B,S,D) -> z and the
    SSD scan's inputs xin (B,S,nh,hp), dt (B,S,nh) fp32, A (nh,) fp32,
    B and C (B,S,ns). xin, B and C are views into the conv output (no
    copies); the kernel reads them through their strides."""
    b, s, _ = xres.shape
    di, ns, nh, hp = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xbc, dt = _project(cfg, p, xres)
    z = shard_ctx.constrain_channels(z)
    dt = shard_ctx.constrain_channels(dt)
    conv_w = torch.cat([p["conv_x"], p["conv_bc"]], dim=-1)
    xbc, _ = _causal_conv(xbc, conv_w)
    xin = shard_ctx.constrain_heads(xbc[..., :di].reshape(b, s, nh, hp))
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return z, (xin, dt, A, xbc[..., di:di + ns], xbc[..., di + ns:])


def ssd_reference(x, dt, A, B, C, chunk: int):
    """The plain chunked SSD scan under the reference's name and
    signature (`kernels.ssd_scan.ref.ssd_scan_ref`): x (b,s,h,p),
    dt (b,s,h), A (h,), B/C (b,s,n) -> y (b,s,h,p)."""
    return ssd_scan_ref(x, dt, A, B, C, chunk=chunk)


def ssd(xin, dt, A, B, C, *, chunk: int, impl: str):
    """The SSD scan through ``impl``: the CUDA kernel ("kernel") or the
    reference's plain branch (dt and A in x's type; the chunk must divide
    s, its `s % chunk` assertion, mamba2.py:93). DTensors run on each
    rank's head shard: heads over "model", B and C replicated there."""
    if shard_ctx.is_dtensor(xin):
        return _ssd_head_local(xin, dt, A, B, C, chunk=chunk, impl=impl)
    if impl == "kernel":
        return ssd_ops.ssd_scan(xin, dt, A, B, C, chunk=chunk)
    return ssd_scan_ref(xin, dt.to(xin.dtype), A.to(xin.dtype), B, C,
                        chunk=min(chunk, xin.shape[1]))


def _ssd_head_local(xin, dt, A, B, C, *, chunk, impl):
    from torch.distributed.tensor import Replicate, Shard

    mesh = xin.device_mesh
    heads, row, a_pl = [], [], []
    for i, name in enumerate(mesh.mesh_dim_names):
        bpl = shard_ctx.batch_or_replicate(xin, i)
        heads.append(Shard(2) if name == "model" else bpl)
        row.append(Replicate() if name == "model" else bpl)
        a_pl.append(Shard(0) if name == "model" else Replicate())
    return shard_ctx.run_local(
        lambda *a: ssd(*a, chunk=chunk, impl=impl), (xin, dt, A, B, C),
        (heads, heads, a_pl, row, row), heads, tuple(xin.shape))


def mamba_forward(p: Params, cfg: ModelConfig, xres: torch.Tensor, *,
                  impl: str = "reference") -> torch.Tensor:
    """Full-sequence Mamba2 mixer. xres (B,S,D) -> (B,S,D)."""
    check_impl(impl)
    b, s, _ = xres.shape
    z, (xin, dt, A, B, C) = scan_inputs(p, cfg, xres)
    y = ssd(xin, dt, A, B, C, chunk=cfg.ssm_chunk, impl=impl)
    y = y + xin * p["D"][None, None, :, None].to(xin.dtype)
    y = shard_ctx.constrain_channels(y.reshape(b, s, cfg.ssm_inner)) * \
        F.silu(z)
    return y @ p["out_proj"]


# ---------------------------------------------------------------------------
# Decode: constant-size recurrent state
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   layers: int | None = None, device=None) -> Params:
    """{"ssm": (L,B,nh,hp,ns), "conv": (L,B,K-1,conv_dim)}, zeros, fp32
    by default. `mamba_decode` writes both in place; the conv state holds
    values of x's type (the reference's comes back in x's type after a
    step), which an fp32 buffer stores exactly."""
    l = layers if layers is not None else cfg.num_layers
    nh, hp, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.ssm_inner + 2 * ns
    return {
        "ssm": torch.zeros((l, batch, nh, hp, ns), dtype=dtype,
                           device=device),
        "conv": torch.zeros((l, batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def mamba_decode(p: Params, cfg: ModelConfig, xres: torch.Tensor,
                 ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One-token decode. xres (B,1,D); ssm_state (B,nh,hp,ns);
    conv_state (B,K-1,conv_dim). Both states are updated in place and
    returned: (out, ssm_state, conv_state)."""
    di, ns, nh, hp = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xbc, dt = _project(cfg, p, xres)
    conv_w = torch.cat([p["conv_x"], p["conv_bc"]], dim=-1)
    xbc = conv_step(xbc, conv_w, conv_state)
    xin = shard_ctx.split_last(xbc[..., :di], (nh, hp))[:, 0]
    B = xbc[:, 0, di:di + ns]
    C = xbc[:, 0, di + ns:]
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])          # (B,nh)
    A = -torch.exp(p["A_log"])
    y = ssm_step(xin, B, C, dt, A, ssm_state)
    y = y.to(xres.dtype) + xin * p["D"][None, :, None].to(xin.dtype)
    y = shard_ctx.merge_last(y)[:, None] * F.silu(z)
    return y @ p["out_proj"], ssm_state, conv_state


def conv_step(xbc, conv_w, conv_state):
    """One token through the causal conv: xbc (B,1,C), conv_w (K,C);
    conv_state (B,K-1,C) is advanced in place. A DTensor state is
    advanced on each rank's own (batch, channel) shard."""
    if shard_ctx.is_dtensor(conv_state):
        from torch.distributed.tensor import Replicate, Shard

        pl = conv_state.placements
        w_pl = [Shard(1) if x == Shard(2) else Replicate() for x in pl]
        return shard_ctx.run_local(conv_step, (xbc, conv_w, conv_state),
                                   (pl, w_pl, None), pl, tuple(xbc.shape))
    out, new_conv = _causal_conv(xbc, conv_w, state=conv_state)
    conv_state.copy_(new_conv)
    return out


def ssm_step(xin, B, C, dt, A, ssm_state):
    """The recurrence for one token: xin (B,nh,hp), B/C (B,ns), dt (B,nh)
    fp32, A (nh,); ssm_state (B,nh,hp,ns) is advanced in place. Returns
    y = state . C (B,nh,hp) in fp32. A DTensor state is advanced on each
    rank's own (batch, head) shard."""
    if shard_ctx.is_dtensor(ssm_state):
        from torch.distributed.tensor import Replicate, Shard

        pl = ssm_state.placements
        row = [x if x == Shard(0) else Replicate() for x in pl]
        a_pl = [Shard(0) if x == Shard(1) else Replicate() for x in pl]
        return shard_ctx.run_local(ssm_step, (xin, B, C, dt, A, ssm_state),
                                   (pl, row, row, pl, a_pl, None), pl,
                                   tuple(xin.shape))
    decay = torch.exp(dt * A)                                 # (B,nh)
    upd = torch.einsum("bhp,bn,bh->bhpn", xin.float(), B.float(), dt)
    ssm_state.mul_(decay[..., None, None]).add_(upd)
    return torch.einsum("bhpn,bn->bhp", ssm_state.float(), C.float())
