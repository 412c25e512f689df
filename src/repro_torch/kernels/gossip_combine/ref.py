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
"""

from __future__ import annotations

import torch


def gossip_combine_ref(weights: torch.Tensor,
                       coeffs: torch.Tensor) -> torch.Tensor:
    """weights (K, T), coeffs (K,) -> (T,) in the weights' type."""
    a = coeffs.to(torch.float32)
    acc = torch.zeros(weights.shape[1:], dtype=torch.float32,
                      device=weights.device)
    for k in range(weights.shape[0]):
        acc = acc + a[k] * weights[k].to(torch.float32)
    return acc.to(weights.dtype)


def edge_aggregate_ref(w: torch.Tensor, buf: torch.Tensor,
                       coeffs: torch.Tensor, row_ptr: torch.Tensor,
                       diag: torch.Tensor) -> torch.Tensor:
    """w (N, T), buf (2E, T) dst-sorted, coeffs (2E,), row_ptr (N+1,)
    integer offsets, diag (N,) -> (N, T). Reads row_ptr on the host."""
    n = w.shape[0]
    rp = row_ptr.tolist()
    deg = [rp[i + 1] - rp[i] for i in range(n)]
    acc = torch.zeros_like(w)
    # Step j adds every row's j-th incoming edge at once; within a row
    # the edges still arrive in ascending order.
    for j in range(max(deg, default=0)):
        rows = [i for i in range(n) if deg[i] > j]
        edges = torch.tensor([rp[i] + j for i in rows], device=w.device)
        rows_t = torch.tensor(rows, device=w.device)
        acc[rows_t] = acc[rows_t] + coeffs[edges, None] * buf[edges]
    return diag[:, None] * w + acc


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
