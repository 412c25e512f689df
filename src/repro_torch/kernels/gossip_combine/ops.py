"""The gossip kernels' dispatching ops and the host-side CSR plan
(counterpart of `repro.kernels.gossip_combine.ops`).

* `gossip_combine` -- the fixed-K stacked combine (`csrc/gossip_combine.cu`),
  and `combine_pytree`, the same leaf by leaf over a stacked tree;
* `refresh_aggregate` -- the fused refresh-and-aggregate over CSR edges
  (`csrc/edge_aggregate.cu`): one launch for a list of `Segment`s (the
  flat matrix, every shard block, or every leaf), each refreshing its
  buffers in place on the strong edges and aggregating; and
  `edge_aggregate`, the same kernel on one segment that refreshes
  nothing (the CSR aggregation over the plan `csr_sort` builds).

Each op takes the plain PyTorch version (`ref.py`) for tensors on the
CPU and launches its CUDA kernel for tensors on a card; it never falls
back from one to the other. `<op>.launches` counts kernel launches;
`edge_aggregate.launches` counts every launch of
`csrc/edge_aggregate.cu`, whichever op made it.
"""

from __future__ import annotations

import array
import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.gossip_combine.ref import (Segment,
                                                    edge_aggregate_ref,
                                                    gossip_combine_ref,
                                                    refresh_aggregate_ref)

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


#: Segments one launch takes (the kernel's parameters stay under 4 KB);
#: a longer list launches once per MAX_SEGMENTS.
MAX_SEGMENTS = 32
#: 64-bit words of `csrc/edge_aggregate.cu`'s `Segment`: ten pointers,
#: t, then (n, vec) and (first, padding) as 32-bit pairs.
_RECORD_WORDS = 13


def _library() -> ctypes.CDLL:
    lib = build.load(_KERNEL)
    fn = lib.edge_aggregate_segments
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


#: each `Segment` field's type, in field order
_TYPES = (torch.float32, torch.float32, torch.float32, torch.int32,
          torch.float32, torch.float32, torch.int32, torch.bool, torch.int32,
          torch.float32)


def _refuse_tensor(name: str, x: torch.Tensor, dt, dev, what: str):
    if x.device != dev:
        raise ValueError(f"{what}: {name} is on {x.device}, w on {dev}")
    if x.dtype != dt:
        raise TypeError(f"{what}: {name} is {x.dtype}, needs {dt}")
    raise ValueError(f"{what}: {name} is not contiguous")


def _check(seg: Segment, dev: torch.device, what: str,
           seen: set | None = None) -> None:
    """Raise on what the kernel does not take. Tensors whose id is in
    ``seen`` (shared by the segments of one call) were checked already;
    the ids checked here are added."""
    index = -1 if dev.type == "cpu" else dev.index
    for name, x, dt in zip(Segment._fields, seg, _TYPES):
        if x is None or (seen is not None and id(x) in seen):
            continue
        if (x.dtype is not dt or x.get_device() != index
                or not x.is_contiguous()):
            _refuse_tensor(name, x, dt, dev, what)
        if seen is not None:
            seen.add(id(x))
    w, buf, coeffs = seg.w, seg.buf, seg.coeffs
    if w.dim() != 2 or buf.dim() != 2 or coeffs.dim() != 1:
        raise ValueError(f"{what}: w and buf must be 2-D, coeffs 1-D")
    (n, t), e = w.shape, coeffs.shape[0]
    if n < 1:
        raise ValueError(f"{what}: N={n}, needs at least one row")
    shapes = {"buf": (buf.shape[1], t), "row_ptr": (seg.row_ptr.shape,
                                                    (n + 1,)),
              "diag": (seg.diag.shape, (n,))}
    for name in ("src", "strong", "edge_row"):
        x = getattr(seg, name)
        if x is not None:
            shapes[name] = (x.shape, (e,))
    if seg.fresh is not None:
        shapes["fresh"] = (seg.fresh.shape[1:], (t,))
    if seg.out is not None:
        shapes["out"] = (seg.out.shape, (n, t))
    for name, (got, want) in shapes.items():
        if got != want:
            raise ValueError(f"{what}: {name} has {got} where w "
                             f"{tuple(w.shape)} and {e} edges need {want}")
    if seg.edge_row is None and buf.shape[0] < e:
        raise ValueError(f"{what}: {buf.shape[0]} buffer rows for {e} "
                         f"edges")


def _record(seg: Segment, out: torch.Tensor) -> list[int]:
    """The segment's words of the kernel's `Segment` record."""
    n, t = seg.w.shape
    ptr = lambda x: 0 if x is None else x.data_ptr()
    return [seg.w.data_ptr(), ptr(seg.fresh) or seg.w.data_ptr(),
            seg.buf.data_ptr(), out.data_ptr(), seg.coeffs.data_ptr(),
            seg.row_ptr.data_ptr(), seg.diag.data_ptr(), ptr(seg.src),
            ptr(seg.strong), ptr(seg.edge_row), t, n, 0]


def _launch(records: list, dev: torch.device) -> None:
    """One kernel launch per MAX_SEGMENTS records, on the current stream
    of ``dev``, each counted in `edge_aggregate.launches`."""
    fn = _library().edge_aggregate_segments
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i in range(0, len(records), MAX_SEGMENTS):
            part = records[i:i + MAX_SEGMENTS]
            words = array.array("q", [x for rec in part for x in rec])
            rc = fn(words.buffer_info()[0], len(part), stream)
            edge_aggregate.launches += 1
            if rc != 0:
                raise RuntimeError(f"edge_aggregate: launch failed, "
                                   f"cudaError {rc}")


def refresh_aggregate(segments) -> list[torch.Tensor]:
    """Fused refresh-and-aggregate over a list of `Segment`s, one kernel
    launch for all of them (one per MAX_SEGMENTS).

    For each segment and dst-sorted edge e of destination i:
    v[e] = fresh[src[e]] if strong[e] else buf[edge_row[e]]; on strong
    edges buf[edge_row[e]] = v[e], in place; out[i] = diag[i] * w[i] +
    sum_{row_ptr[i] <= e < row_ptr[i+1]} coeffs[e] * v[e], in fp32,
    ascending edges, diag*w last. Returns each segment's (N, T) output
    (``seg.out`` where given).
    """
    segments = list(segments)
    if not segments:
        return []
    dev = segments[0].w.device
    if dev.type == "cpu":
        return refresh_aggregate_ref(segments)
    if dev.type != "cuda":
        raise ValueError(f"refresh_aggregate: no kernel for device {dev}")
    outs, records, seen = [], [], set()
    for g, seg in enumerate(segments):
        _check(seg, dev, f"refresh_aggregate: segment {g}", seen)
        out = seg.out if seg.out is not None else torch.empty_like(seg.w)
        outs.append(out)
        if seg.w.shape[1] > 0:
            records.append(_record(seg, out))
    if records:
        _launch(records, dev)
    return outs


def edge_aggregate(w: torch.Tensor, buf: torch.Tensor, coeffs: torch.Tensor,
                   row_ptr: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """CSR aggregation over dst-sorted edges: `refresh_aggregate` of one
    segment that refreshes nothing.

    w (N, T) f32; buf (2E, T) f32 sorted by destination; coeffs (2E,) f32
    in the same order; row_ptr (N+1,) int32; diag (N,) f32. Returns
    (N, T): out[i] = diag[i] * w[i] + sum_{row_ptr[i] <= e < row_ptr[i+1]}
    coeffs[e] * buf[e], in fp32, ascending edges, diag*w last.
    """
    if w.device.type == "cpu":
        return edge_aggregate_ref(w, buf, coeffs, row_ptr, diag)
    if w.device.type != "cuda":
        raise ValueError(f"edge_aggregate: no kernel for device {w.device}")
    seg = Segment(w, buf, coeffs, row_ptr, diag)
    _check(seg, w.device, "edge_aggregate")
    if tuple(coeffs.shape) != (buf.shape[0],):
        raise ValueError(f"edge_aggregate: coeffs {tuple(coeffs.shape)} vs "
                         f"buf {tuple(buf.shape)}")
    out = torch.empty_like(w)
    if w.shape[1] > 0:
        _launch([_record(seg, out)], w.device)
    return out


edge_aggregate.launches = 0
