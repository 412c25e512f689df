"""The dispatching SSD scan op (counterpart of
`repro.kernels.ssd_scan.ops`).

`ssd_scan` takes x (b, s, h, p), dt (b, s, h), A (h,) and one group of
B/C (b, s, n). The chunk follows the reference's rule: a sequence that
is not a multiple of ``chunk`` takes ``min(chunk, s)`` and is padded to a
multiple of it with dt = 0 (and x = B = C = 0), which leaves the carried
state exact and the valid rows unchanged. dt and A are upcast to fp32,
as the TPU kernel does, and y comes back in x's type.

Tensors on the CPU go to the plain PyTorch version (`ref.py`), run in
fp32 on the padded inputs. Tensors on a card go to the CUDA kernels
(`csrc/ssd_scan.cu`), which read x, B and C through their strides (the
model hands them slices of its conv output, uncopied) and take the ragged
last chunk as that padding without making it. bf16 inputs take three
launches on the tensor cores, Mamba-2's chunk-parallel passes (chunk
states, state passing, chunk scan; `ref.ssd_scan_passes` is their plain
form) through an fp32 workspace the op allocates; a one-chunk sequence
takes the last pass alone. fp32 inputs take one launch of a CUDA-core
kernel, one CTA per (batch, head). The route follows the dtype alone: it
never falls back from one to another or to the plain version, and any
other device raises. `ssd_scan.launches` counts calls of the op that
launched (one per Mamba2 layer), whatever the number of kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

_KERNEL = "ssd_scan"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CU_RESULT_BASE = 10000  # csrc/ssd_scan.cu: a failed encode's CUresult
#: what the kernel takes: head_dim p a multiple of 4 up to MAX_P, state
#: n a multiple of 8 up to MAX_N, chunks of up to MAX_CHUNK rows
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256


def _library() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9
        fn.restype = ctypes.c_int
    return lib


def chunk_for(s: int, chunk: int) -> int:
    """The reference's chunk rule (`repro/kernels/ssd_scan/ops.py`)."""
    if chunk <= 0:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    return min(chunk, s) if s % chunk else chunk


def _check(x, dt, A, B, C) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 \
            or C.dim() != 3:
        raise ValueError("ssd_scan: x must be (b, s, h, p), dt (b, s, h), "
                         "A (h,), B and C (b, s, n)")
    b, s, h, _ = x.shape
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or B.shape[:2] != (b, s) or B.shape != C.shape):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} do not fit")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not t.dtype.is_floating_point:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}")


def _check_cuda(x, dt, A, B, C, chunk: int) -> None:
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: no kernel for {x.dtype}")
    for name, t in (("B", B), ("C", C)):
        if t.dtype != x.dtype:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}, x is {x.dtype}")
    p, n = x.shape[3], B.shape[2]
    if p % 4 or p > MAX_P:
        raise ValueError(f"ssd_scan: head_dim {p} is not a multiple of 4 "
                         f"up to {MAX_P}")
    if n % 8 or n > MAX_N:
        raise ValueError(f"ssd_scan: state size {n} is not a multiple of 8 "
                         f"up to {MAX_N}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} > {MAX_CHUNK}")
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("ssd_scan: the last axis of x, B and C must be "
                         "contiguous")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             chunk: int = 256) -> torch.Tensor:
    """x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n) -> y (b,s,h,p) in x's
    type, computed in fp32."""
    _check(x, dt, A, B, C)
    b, s, h, p = x.shape
    chunk = chunk_for(s, chunk)
    dt, A = dt.float(), A.float()
    if x.device.type == "cpu":
        pad = (-s) % chunk
        xf, dtf, Bf, Cf = x.float(), dt, B.float(), C.float()
        if pad:
            xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
            dtf = F.pad(dtf, (0, 0, 0, pad))
            Bf = F.pad(Bf, (0, 0, 0, pad))
            Cf = F.pad(Cf, (0, 0, 0, pad))
        y = ssd_scan_ref(xf, dtf, A, Bf, Cf, chunk=chunk)
        return y[:, :s].to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    _check_cuda(x, dt, A, B, C, chunk)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    A = A.contiguous()
    n = B.shape[2]
    vals = (b, s, h, p, n, chunk, *x.stride()[:3], *dt.stride(),
            *B.stride()[:2], *C.stride()[:2], *y.stride()[:3])
    dims = (ctypes.c_int64 * len(vals))(*vals)
    nc1 = -(-s // chunk) - 1
    ws = (torch.empty(b * nc1 * h * (2 * p * n + 1), dtype=torch.float32,
                      device=x.device)
          if x.dtype == torch.bfloat16 and nc1 else None)
    with torch.cuda.device(x.device):
        rc = _library().ssd_scan_fwd(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(),
            ctypes.cast(dims, ctypes.c_void_p),
            torch.cuda.current_stream(x.device).cuda_stream)
    ssd_scan.launches += 1
    if rc >= _CU_RESULT_BASE:
        raise RuntimeError("ssd_scan: tensor map encoding failed, CUresult "
                           f"{rc - _CU_RESULT_BASE}")
    if rc != 0:
        raise RuntimeError(f"ssd_scan: launch failed, cudaError {rc}")
    return y


ssd_scan.launches = 0
