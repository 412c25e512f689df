"""The dispatching flash-decode op (counterpart of
`repro.kernels.decode_attention.ops`).

`decode_attention` takes q (B, Hq, hd), the transformer's k/v caches in
their own (B, S, Hkv, hd) layout, and lengths (B,). Tensors on the CPU go
to the plain PyTorch version (`ref.py`, handed a transposed view);
tensors on a card go to the CUDA kernel (`csrc/decode_attention.cu`),
which reads the caches through their strides and never copies them. It
never falls back from one to the other, and any other device raises.
`decode_attention.launches` counts kernel launches: one per call, a
single kernel whose `num_splits` CTAs per (sequence, KV head) form a
thread-block cluster and combine their parts inside it, with no
workspace in device memory.

`lengths` must lie in 1..S. It may be a CPU tensor even when the caches
are on the card: it is then checked on the host and copied over
asynchronously, unless the caller hands the same values already on the
card as `lengths_dev` (int32), which the kernel then reads as they are;
the transformer's decode step does that, so no layer uploads them. A
lengths tensor on the card is checked with one device-to-host read,
which waits for the card. `lengths` may be None when `lengths_dev` is
given: nothing is then read back or copied, so the call can be captured
in a CUDA graph, and keeping the values in 1..S is the caller's (the
decode step's clamp(pos + 1, max=S) of positions >= 0).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_KERNEL = "decode_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
#: cache rows per TMA tile; a split's rows are a whole number of tiles
TILE = 64
#: largest portable thread-block cluster, so at most this many splits
MAX_SPLITS = 8
_CU_RESULT_BASE = 10000  # the kernel's code for a failed tensor-map encode


def num_splits(b: int, hkv: int, s: int, sms: int) -> int:
    """CTAs per (sequence, KV head), from the shapes alone: enough for
    about two per SM over the B*Hkv clusters, at most MAX_SPLITS, and no
    more than the cache has tiles. Each CTA then takes ceil(len / nsplit)
    rows of its sequence, rounded up to the tile."""
    return min(MAX_SPLITS, max(1, -(-2 * sms // (b * hkv))), -(-s // TILE))


_SMS: dict[int, int] = {}


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _library() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, lengths, *, values: bool = True) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention: q must be (B, Hq, hd) and the "
                         "caches (B, S, Hkv, hd)")
    b, hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if hq % k.shape[2]:
        raise ValueError(f"decode_attention: Hq={hq} is not a multiple of "
                         f"Hkv={k.shape[2]}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"decode_attention: lengths {tuple(lengths.shape)}"
                         f" is not ({b},)")
    if lengths.dtype.is_floating_point or lengths.dtype == torch.bool:
        raise TypeError(f"decode_attention: lengths is {lengths.dtype}")
    if b == 0 or not values:
        return
    lo, hi = (int(x) for x in torch.aminmax(lengths))
    if lo < 1 or hi > k.shape[1]:
        # At 0 the TPU kernel returns 0 and its oracle the mean of v; the
        # model always passes lengths >= 1, so the port takes only that.
        raise ValueError(f"decode_attention: lengths must lie in "
                         f"1..{k.shape[1]}, got {lo}..{hi}")


def _check_cuda(q, k, v) -> None:
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {x.device}, "
                             f"q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"decode_attention: {name} is {x.dtype}, q is "
                            f"{q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention: no kernel for {q.dtype}")
    hd = q.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.stride(2) != 1:
        raise ValueError("decode_attention: q's head_dim axis is not "
                         "contiguous")
    vec = 16 // q.element_size()  # elements per 16-byte load
    for name, x in (("k", k), ("v", v)):
        if (x.stride(3) != 1 or x.data_ptr() % 16
                or any(st % vec for st in x.stride()[:3])):
            raise ValueError(f"decode_attention: {name}'s cache rows are "
                             "not contiguous and 16-byte aligned")
    if q.shape[0] * k.shape[2] > 65535:
        raise ValueError("decode_attention: B*Hkv outside the grid")


def _check_lengths_dev(lengths_dev, q) -> None:
    if (lengths_dev.dtype != torch.int32 or lengths_dev.device != q.device
            or tuple(lengths_dev.shape) != (q.shape[0],)
            or not lengths_dev.is_contiguous()):
        raise ValueError(
            f"decode_attention: lengths_dev must be contiguous int32 of "
            f"shape ({q.shape[0]},) on {q.device}, got {lengths_dev.dtype} "
            f"{tuple(lengths_dev.shape)} on {lengths_dev.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor | None, *,
                     lengths_dev: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, Hq, hd), k/v (B, S, Hkv, hd), lengths (B,) in 1..S ->
    (B, Hq, hd) in q's type, fp32 accumulation. ``lengths_dev``, if
    given, holds the same values as ``lengths`` on q's card (int32); the
    kernel reads it in place of a copy of ``lengths``. The plain version
    on the CPU ignores it. With ``lengths`` None the values of
    ``lengths_dev`` are taken unchecked (module docstring)."""
    if lengths is None:
        if lengths_dev is None:
            raise ValueError("decode_attention: give lengths or lengths_dev")
        _check(q, k, v, lengths_dev, values=False)
        lengths = lengths_dev
    else:
        _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                    lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    _check_cuda(q, k, v)
    b, hq, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if lengths_dev is not None:
        _check_lengths_dev(lengths_dev, q)
        lengths = lengths_dev
    elif lengths.device.type == "cpu":
        lengths = lengths.to(torch.int32).pin_memory().to(
            q.device, non_blocking=True)
    else:
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    nsplit = num_splits(b, hkv, s, _sms(q.device))
    dims = (ctypes.c_int64 * 13)(
        b, s, hkv, group, *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
        nsplit)
    with torch.cuda.device(q.device):
        rc = _library().decode_attention_fwd(
            _DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            ctypes.cast(dims, ctypes.c_void_p), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc >= _CU_RESULT_BASE:
        raise RuntimeError(f"decode_attention: tensor-map encoding failed, "
                           f"CUresult {rc - _CU_RESULT_BASE}")
    if rc != 0:
        raise RuntimeError(f"decode_attention: launch failed, cudaError {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
