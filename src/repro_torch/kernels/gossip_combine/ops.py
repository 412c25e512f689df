"""The gossip kernels' dispatching ops and the host-side CSR plan
(counterpart of `repro.kernels.gossip_combine.ops`).

* `gossip_combine` -- the fixed-K stacked combine (`csrc/gossip_combine.cu`),
  and `combine_pytree`, the same leaf by leaf over a stacked tree;
* `edge_aggregate` -- the CSR edge aggregation (`csrc/edge_aggregate.cu`),
  over the plan `csr_sort` builds.

Each op takes the plain PyTorch version (`ref.py`) for tensors on the
CPU and launches its CUDA kernel for tensors on a card; it never falls
back from one to the other. `<op>.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.gossip_combine.ref import (edge_aggregate_ref,
                                                    gossip_combine_ref)

_KERNEL = "edge_aggregate"
_COMBINE = "gossip_combine"
#: Largest K the CUDA combine is compiled for.
MAX_K = 8
_COMBINE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _combine_library() -> ctypes.CDLL:
    lib = build.load(_COMBINE)
    fn = lib.gossip_combine
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                               ctypes.c_int32, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_combine(weights: torch.Tensor, coeffs: torch.Tensor) -> None:
    if coeffs.device != weights.device:
        raise ValueError(f"gossip_combine: coeffs is on {coeffs.device}, "
                         f"weights on {weights.device}")
    if weights.dtype not in _COMBINE_DTYPES:
        raise TypeError(f"gossip_combine: weights are {weights.dtype}, "
                        f"needs float32 or bfloat16")
    if coeffs.dtype != torch.float32:
        raise TypeError(f"gossip_combine: coeffs are {coeffs.dtype}, "
                        f"needs float32")
    for name, x in (("weights", weights), ("coeffs", coeffs)):
        if not x.is_contiguous():
            raise ValueError(f"gossip_combine: {name} is not contiguous")
    if weights.dim() != 2 or tuple(coeffs.shape) != weights.shape[:1]:
        raise ValueError(f"gossip_combine: weights {tuple(weights.shape)} "
                         f"and coeffs {tuple(coeffs.shape)} are not (K, T) "
                         f"and (K,)")
    if not 1 <= weights.shape[0] <= MAX_K:
        raise ValueError(f"gossip_combine: K={weights.shape[0]} outside the "
                         f"kernel's 1..{MAX_K}")


def gossip_combine(weights: torch.Tensor,
                   coeffs: torch.Tensor) -> torch.Tensor:
    """weights (K, T) fp32 or bf16, coeffs (K,) fp32 -> (T,) in the
    weights' type: out[t] = sum_k coeffs[k] * weights[k, t], accumulated
    in fp32 in ascending k. T = 0 gives an empty output and no launch."""
    if weights.device.type == "cpu":
        return gossip_combine_ref(weights, coeffs)
    if weights.device.type != "cuda":
        raise ValueError(f"gossip_combine: no kernel for device "
                         f"{weights.device}")
    _check_combine(weights, coeffs)
    k, t = weights.shape
    out = torch.empty((t,), dtype=weights.dtype, device=weights.device)
    if t == 0:
        return out
    with torch.cuda.device(weights.device):
        rc = _combine_library().gossip_combine(
            weights.data_ptr(), coeffs.data_ptr(), out.data_ptr(), k, t,
            _COMBINE_DTYPES[weights.dtype],
            torch.cuda.current_stream(weights.device).cuda_stream)
    gossip_combine.launches += 1
    if rc != 0:
        raise RuntimeError(f"gossip_combine: launch failed, cudaError {rc}")
    return out


gossip_combine.launches = 0


def combine_pytree(stacked, coeffs: torch.Tensor):
    """`gossip_combine` leaf by leaf over a (nested) dict whose every leaf
    has the leading axis K; each leaf keeps its type (bf16 stays bf16)."""
    if isinstance(stacked, dict):
        return {key: combine_pytree(v, coeffs) for key, v in stacked.items()}
    w = stacked.reshape(stacked.shape[0], -1)
    return gossip_combine(w, coeffs).reshape(stacked.shape[1:])


def csr_sort(dst: np.ndarray, num_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side CSR plan for a directed edge list.

    Returns (order, row_ptr): `order` permutes edge-indexed arrays into
    dst-sorted layout (stable, so within a destination the original edge
    order, and with it the accumulation order, is kept);
    `row_ptr[i]:row_ptr[i+1]` spans destination i's incoming edges.
    Isolated destinations get an empty span.
    """
    dst = np.asarray(dst)
    order = np.argsort(dst, kind="stable").astype(np.int32)
    counts = np.bincount(dst, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, np.int32)
    row_ptr[1:] = np.cumsum(counts).astype(np.int32)
    return order, row_ptr


def _library() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    fn = lib.edge_aggregate_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(w, buf, coeffs, row_ptr, diag) -> None:
    dev = w.device
    for name, x, dt in (("w", w, torch.float32), ("buf", buf, torch.float32),
                        ("coeffs", coeffs, torch.float32),
                        ("row_ptr", row_ptr, torch.int32),
                        ("diag", diag, torch.float32)):
        if x.device != dev:
            raise ValueError(f"edge_aggregate: {name} is on {x.device}, "
                             f"w on {dev}")
        if x.dtype != dt:
            raise TypeError(f"edge_aggregate: {name} is {x.dtype}, "
                            f"needs {dt}")
        if not x.is_contiguous():
            raise ValueError(f"edge_aggregate: {name} is not contiguous")
    if w.dim() != 2 or buf.dim() != 2:
        raise ValueError("edge_aggregate: w and buf must be 2-D")
    n, t = w.shape
    e2 = buf.shape[0]
    if buf.shape[1] != t:
        raise ValueError(f"edge_aggregate: buf {tuple(buf.shape)} vs "
                         f"w {tuple(w.shape)}")
    if (tuple(coeffs.shape) != (e2,) or tuple(row_ptr.shape) != (n + 1,)
            or tuple(diag.shape) != (n,)):
        raise ValueError(
            f"edge_aggregate: coeffs {tuple(coeffs.shape)}, row_ptr "
            f"{tuple(row_ptr.shape)}, diag {tuple(diag.shape)} do not fit "
            f"N={n}, 2E={e2}")
    if not 1 <= n <= 65535:
        raise ValueError(f"edge_aggregate: N={n} outside the grid's 1..65535")


def edge_aggregate(w: torch.Tensor, buf: torch.Tensor, coeffs: torch.Tensor,
                   row_ptr: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """CSR aggregation over dst-sorted edges.

    w (N, T) f32; buf (2E, T) f32 sorted by destination; coeffs (2E,) f32
    in the same order; row_ptr (N+1,) int32; diag (N,) f32. Returns
    (N, T): out[i] = diag[i] * w[i] + sum_{row_ptr[i] <= e < row_ptr[i+1]}
    coeffs[e] * buf[e], in fp32, ascending edges, diag*w last.
    """
    if w.device.type == "cpu":
        return edge_aggregate_ref(w, buf, coeffs, row_ptr, diag)
    if w.device.type != "cuda":
        raise ValueError(f"edge_aggregate: no kernel for device {w.device}")
    _check(w, buf, coeffs, row_ptr, diag)
    n, t = w.shape
    out = torch.empty_like(w)
    if t == 0:
        return out
    with torch.cuda.device(w.device):
        fn = _library().edge_aggregate_f32
        rc = fn(w.data_ptr(), buf.data_ptr(), coeffs.data_ptr(),
                row_ptr.data_ptr(), diag.data_ptr(), out.data_ptr(), n, t,
                torch.cuda.current_stream(w.device).cuda_stream)
    edge_aggregate.launches += 1
    if rc != 0:
        raise RuntimeError(f"edge_aggregate: launch failed, cudaError {rc}")
    return out


edge_aggregate.launches = 0
