"""The dispatching flash attention op (counterpart of
`repro.kernels.flash_attention.ops`).

`flash_attention` takes the model layout q (B, S, Hq, hd), k/v
(B, S, Hkv, hd). Tensors on the CPU go to the plain PyTorch version
(`ref.py`); tensors on a card go to the CUDA kernel
(`csrc/flash_attention.cu`), which reads them through their strides.

It replaces the TPU kernel `_flash_kernel` of
`repro.kernels.flash_attention.kernel`. On the card it is bound by
operations: at the yi-9b prefill shape (B 4, S 2048, Hq 32, Hkv 4, hd
128, causal) 137.4 GFLOP, 0.139 ms at the bf16 tensor-core peak. So bf16
inputs at head_dim 64, 128 or 256, with a group Hq / Hkv of at most 128
and 16-byte aligned base and strides, take the `wgmma` route (`route`):
TMA loads of K/V tiles (64 keys at hd 256, else 128) into a ring of
shared-memory stages, one producer warp and two consumer warpgroups on
wgmma. Every other input (fp32, hd 32, bf16 off the 16-byte grid, a
group over 128) takes the `cuda_core` route. The choice depends on
dtype, head dim, group and alignment alone. A failed launch or
tensor-map encoding raises with its CUDA or CU result code: the op never
falls back from the kernel to the plain version or to the other route,
and any other device raises.
`flash_attention.launches` counts kernel launches, and
`flash_attention.launches_by_route` counts them by route.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_KERNEL = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
WGMMA_MAX_GROUP = 128  # a CTA holds 128 rows: at least one query position
#: The C entry point returns this plus the CUresult of a failed encoding.
_CU_RESULT_BASE = 10000


def _library() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, H, hd)")
    b, s, hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if k.shape[1] != s:
        # The TPU kernel masks kpos <= qpos with no offset while its
        # oracle offsets the query by Sk - Sq; the model only calls with
        # Sq == Sk, so the port takes only that.
        raise ValueError(f"flash_attention: Sq={s} != Sk={k.shape[1]} is "
                         "not supported")
    if hq % k.shape[2]:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={k.shape[2]}")


def _check_cuda(q, k, v) -> None:
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {x.device}, "
                             f"q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {x.dtype}, q is "
                            f"{q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: no kernel for {q.dtype}")
    hd = q.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head_dim axis is "
                             "not contiguous")
    b, s, _, _ = q.shape
    if b * k.shape[2] > 65535 or s >= 2 ** 31 // max(q.shape[2], 1):
        raise ValueError(f"flash_attention: B*Hkv={b * k.shape[2]} or "
                         f"S={s} outside the grid")


def tensor_core_route(q, k, v) -> bool:
    """Whether the kernel takes its tensor-core (wgmma) route for these
    inputs: bf16, head_dim 64/128/256, group Hq / Hkv <= 128, every base
    address and stride on 16 bytes (TMA's rule)."""
    return (q.dtype == torch.bfloat16 and q.shape[3] in WGMMA_HEAD_DIMS
            and q.shape[2] // k.shape[2] <= WGMMA_MAX_GROUP
            and all(x.data_ptr() % 16 == 0
                    and all(st % 8 == 0 for st in x.stride()[:3])
                    for x in (q, k, v)))


def route(q, k, v) -> str:
    """The kernel's route for these inputs: "wgmma" or "cuda_core"."""
    return "wgmma" if tensor_core_route(q, k, v) else "cuda_core"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix: int = 0) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, S, Hkv, hd) -> (B, S, Hq, hd), in q's
    type, fp32 accumulation."""
    _check(q, k, v)
    if q.device.type == "cpu":
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, prefix=prefix)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check_cuda(q, k, v)
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    out = torch.empty((b, s, hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    wgmma = tensor_core_route(q, k, v)
    dims = (ctypes.c_int64 * 17)(
        b, s, hkv, hq // hkv, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(bool(causal)), int(window), int(prefix),
        int(wgmma))
    with torch.cuda.device(q.device):
        rc = _library().flash_attention_fwd(
            _DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), ctypes.cast(dims, ctypes.c_void_p),
            1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    flash_attention.launches_by_route["wgmma" if wgmma else "cuda_core"] += 1
    if rc >= _CU_RESULT_BASE:
        raise RuntimeError("flash_attention: tensor map encoding failed, "
                           f"CUresult {rc - _CU_RESULT_BASE}")
    if rc != 0:
        raise RuntimeError(f"flash_attention: launch failed, cudaError {rc}")
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "cuda_core": 0}
