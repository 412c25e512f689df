"""Plain PyTorch versions of the gossip kernels.

`gossip_combine_ref`: out[t] = sum_k a[k] * w[k, t], the fixed-K stacked
combine. The sum starts from zero and adds the products in ascending k,
each product its own fp32 op and rounded before the add, then casts to
the weights' type: the arithmetic the CUDA kernel pins with __fmul_rn /
__fadd_rn, so the two agree bit for bit.

`edge_aggregate_ref`, the CSR edge aggregation:

    out[i] = diag[i] * w[i] + sum_{row_ptr[i] <= e < row_ptr[i+1]} coeffs[e] * buf[e]

over dst-sorted edges, in fp32: the sum starts from zero, adds the
products in ascending edge order, and ``diag*w`` comes last. Each
product is its own tensor op and is rounded before the add, the same
arithmetic the CUDA kernel pins with __fmul_rn / __fadd_rn, so the two
agree bit for bit. It is also bit-equal to the reference's
`segment_sum` oracle on XLA:CPU. No `index_add_`: on CUDA its atomics
would add in a varying order.

`dense_edge_aggregate`, the same sum for a uniform in-degree, over the
buffers viewed as (N, d, T).

`refresh_aggregate_ref`, the fused refresh-and-aggregate over a list of
`Segment`s (flat matrices, shard blocks or leaves): for each segment, the
strong edges' buffer rows take their fresh rows in place (what
``buf = where(strong, fresh[src], buf)`` computes), then
`edge_aggregate_ref` over the refreshed buffers in dst-sorted order.
`refresh_buffers` is its first half. `prepare_refresh_aggregate` splits
it into its host reads and a function of device work alone, which a
CUDA graph can capture.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Segment(NamedTuple):
    """One flat matrix of a grouped refresh-and-aggregate.

    w (N, T) fp32 rows; buf (B, T) fp32 edge buffers, refreshed in place
    on strong edges; coeffs (E,), row_ptr (N+1,) int32 and diag (N,) of
    the dst-sorted edges; fresh: the rows strong edges read (None: w);
    src (E,) int32: each edge's row of fresh (None: the edge's index);
    strong (E,) bool (None: nothing is refreshed); edge_row (E,) int32:
    each edge's row of buf (None: the edge's index); out (N, T): where
    the result goes (None: a new tensor). Edges outside [row_ptr[0],
    row_ptr[N]) are neither read nor written."""

    w: torch.Tensor
    buf: torch.Tensor
    coeffs: torch.Tensor
    row_ptr: torch.Tensor
    diag: torch.Tensor
    fresh: torch.Tensor | None = None
    src: torch.Tensor | None = None
    strong: torch.Tensor | None = None
    edge_row: torch.Tensor | None = None
    out: torch.Tensor | None = None


def gossip_combine_ref(weights: torch.Tensor,
                       coeffs: torch.Tensor) -> torch.Tensor:
    """weights (K, T), coeffs (K,) -> (T,) in the weights' type."""
    a = coeffs.to(torch.float32)
    acc = torch.zeros(weights.shape[1:], dtype=torch.float32,
                      device=weights.device)
    for k in range(weights.shape[0]):
        acc = acc + a[k] * weights[k].to(torch.float32)
    return acc.to(weights.dtype)


def _steps(rp: list[int], device) -> list[tuple[torch.Tensor, ...]]:
    """The aggregation's steps over the row pointer ``rp``: step j holds
    the rows that have a j-th incoming edge and those edges."""
    n = len(rp) - 1
    deg = [rp[i + 1] - rp[i] for i in range(n)]
    steps = []
    for j in range(max(deg, default=0)):
        rows = [i for i in range(n) if deg[i] > j]
        steps.append((torch.tensor(rows, device=device),
                      torch.tensor([rp[i] + j for i in rows], device=device)))
    return steps


def _aggregate(w, buf, coeffs, diag, steps) -> torch.Tensor:
    acc = torch.zeros_like(w)
    # Step j adds every row's j-th incoming edge at once; within a row
    # the edges still arrive in ascending order.
    for rows_t, edges in steps:
        acc[rows_t] = acc[rows_t] + coeffs[edges, None] * buf[edges]
    return diag[:, None] * w + acc


def edge_aggregate_ref(w: torch.Tensor, buf: torch.Tensor,
                       coeffs: torch.Tensor, row_ptr: torch.Tensor,
                       diag: torch.Tensor) -> torch.Tensor:
    """w (N, T), buf (2E, T) dst-sorted, coeffs (2E,), row_ptr (N+1,)
    integer offsets, diag (N,) -> (N, T). Reads row_ptr on the host."""
    return _aggregate(w, buf, coeffs, diag,
                      _steps(row_ptr.tolist(), w.device))


def dense_edge_aggregate(w: torch.Tensor, buf: torch.Tensor,
                         cmat: torch.Tensor,
                         diag: torch.Tensor) -> torch.Tensor:
    """Uniform in-degree lowering of `edge_aggregate_ref`: buf (N*d, T)
    dst-sorted, cmat (N, d). The sorted buffers are viewed as (N, d, T)
    and summed densely, no gather: from zero, the products in ascending
    edge order, each rounded before its add, then ``diag*w``: the same
    adds as `edge_aggregate_ref` and the CUDA kernel, bit for bit. Only
    valid when every destination has exactly d incoming edges (any ring
    overlay: d=2)."""
    n, d = cmat.shape
    bm = buf.reshape(n, d, -1)
    acc = torch.zeros_like(w)
    for j in range(d):
        acc = acc + cmat[:, j, None] * bm[:, j]
    return diag[:, None] * w + acc


def _refresh_plan(seg: Segment):
    """What a segment's refresh reads on the host: the edges [lo, hi)
    its row pointer spans, their buffer rows (None: the edges' own), and
    the strong edges' (buffer rows, fresh rows) (None: no strong mask)."""
    rp = seg.row_ptr
    lo, hi = int(rp[0]), int(rp[-1])
    rows = None if seg.edge_row is None else seg.edge_row[lo:hi].long()
    put = None
    if seg.strong is not None:
        sel = torch.nonzero(seg.strong[lo:hi]).squeeze(1)
        src = sel + lo if seg.src is None else seg.src[lo:hi][sel].long()
        put = (sel + lo if rows is None else rows[sel], src)
    return lo, hi, rows, put


def _refresh(seg: Segment, lo: int, hi: int, rows, put) -> torch.Tensor:
    if put is not None:
        fresh = seg.w if seg.fresh is None else seg.fresh
        seg.buf[put[0]] = fresh[put[1]]
    return seg.buf[lo:hi] if rows is None else seg.buf[rows]


def refresh_buffers(seg: Segment) -> tuple[torch.Tensor, int, int]:
    """Refresh ``seg.buf`` in place on the strong edges and return its
    rows in dst-sorted order over the edges [lo, hi) that the row pointer
    spans (a view where edge_row is None), with lo and hi. Reads row_ptr
    and the strong mask on the host."""
    lo, hi, rows, put = _refresh_plan(seg)
    return _refresh(seg, lo, hi, rows, put), lo, hi


def prepare_refresh_aggregate(segments):
    """`refresh_aggregate_ref` in two halves: this call reads the row
    pointers and strong masks on the host, and the function it returns
    (no arguments) does the rest on the device alone, with no host read,
    so a CUDA graph can capture it. Each call of that function refreshes
    and aggregates the segments' current rows and returns the outputs."""
    plans = []
    for seg in segments:
        lo, hi, rows, put = _refresh_plan(seg)
        steps = _steps([x - lo for x in seg.row_ptr.tolist()], seg.w.device)
        plans.append((seg, lo, hi, rows, put, steps))

    def run() -> list[torch.Tensor]:
        outs = []
        for seg, lo, hi, rows, put, steps in plans:
            v = _refresh(seg, lo, hi, rows, put)
            out = _aggregate(seg.w, v, seg.coeffs[lo:hi], seg.diag, steps)
            if seg.out is not None:
                out = seg.out.copy_(out)
            outs.append(out)
        return outs

    return run


def refresh_aggregate_ref(segments) -> list[torch.Tensor]:
    """The plain version of `ops.refresh_aggregate`: for each segment,
    `refresh_buffers`, then `edge_aggregate_ref` over the refreshed rows.
    Returns each segment's (N, T) output."""
    return prepare_refresh_aggregate(segments)()
