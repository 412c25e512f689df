"""Gossip over the silo axis: the paper's aggregation across silos
(counterpart of `repro.fl.gossip`).

Each silo holds a full model replica. One DPASGD aggregation is

    w_i <- A[i,i] w_i + sum_j A[i,j] what_j

with what_j fresh over strong edges and a stale buffer over weak edges.
Two lowerings:

  * `gossip_dense` -- all_gather over the silo axis and a weighted sum:
    moves (n - 1) replicas into every silo whatever the state; the
    baseline.
  * `gossip_ring_ppermute` -- the overlay is a ring, so a silo only ever
    exchanges with its two ring neighbours: one `ppermute` per active
    direction moves one replica per silo. A state with inactive
    directions moves fewer bytes, and an isolated silo none at all.

Both take the axis as an object (`repro_torch.launch.mesh`): all silos
stacked in one process, or one silo per rank of a process group. Weak-
edge staleness is carried by `buffers` (the last replicas received from
the left and right neighbours), as in the reference.

The mesh runtime (fl/mesh.py) generalizes these two lowerings from the
ring overlay to ANY CSR edge structure: `csr_gather_all` is the
all_gather backend and `csr_gather_halo` the ppermute backend. Both
fetch, for each local shard, the (e_per, T) source rows of its block of
dst-sorted edges over a shard axis (`launch/mesh.StackedShards` or
`GroupShards`); they only index and copy, so every row a shard receives
is bit for bit the flat runtime's ``w[src]``. Everything downstream of
the fetch (the fused buffer refresh and aggregation) is shard-local.
"""

from __future__ import annotations

import torch

from repro_torch.fl.flat import make_flat_spec, ravel, unravel
from repro_torch.kernels.gossip_combine.ops import gossip_combine
from repro_torch.launch.mesh import tree_leaves, tree_map

Params = dict


def gossip_dense(params: Params, a_matrix: torch.Tensor, axis) -> Params:
    """w_i <- sum_j A[i,j] w_j via all_gather along ``axis``, in fp32,
    cast back to each leaf's type. a_matrix: (n, n) consensus matrix."""
    gathered = axis.all_gather(params)                  # leaves (n, ...)
    a = a_matrix.to(device=tree_leaves(params)[0].device,
                    dtype=torch.float32)

    def silo(s):
        return tree_map(lambda allw: torch.tensordot(
            a[s], allw.to(torch.float32), dims=1).to(allw.dtype), gathered)

    return axis.from_silos(silo)


def _ring_perms(n: int):
    right = [(i, (i + 1) % n) for i in range(n)]
    left = [(i, (i - 1) % n) for i in range(n)]
    return left, right


def gossip_ring_ppermute(params: Params, buffers: dict, *,
                         coeff_self: torch.Tensor, coeff_left: torch.Tensor,
                         coeff_right: torch.Tensor, axis, active_left: bool,
                         active_right: bool, use_kernel: bool = False):
    """Ring-overlay gossip with per-edge ppermute and stale buffers.

    buffers: {"left": tree, "right": tree}, the last replicas received
    from the left / right ring neighbour. An inactive direction issues no
    exchange at all (the axis's byte counter does not move) and the
    aggregation reads the stale buffer instead.

    coeff_*: (n,) per-silo aggregation coefficients (the silo's row of
    the overlay's Metropolis matrix).

    The combine is self*w + left*lw + right*rw in fp32, multiplied and
    then added in that order, cast to each leaf's type. With
    ``use_kernel`` each silo packs its three replicas flat into one
    (3, T) fp32 stack and combines it with one `gossip_combine` call
    (n calls a round on the stacked binding); without, it runs leaf by
    leaf in PyTorch. The two agree bit for bit.

    Returns (new_params, new_buffers).
    """
    n = axis.size
    left_perm, right_perm = _ring_perms(n)
    # the right perm sends my replica to my right neighbour, so I receive
    # my LEFT neighbour's
    recv_from_left = (axis.ppermute(params, right_perm) if active_right
                      else buffers["left"])
    recv_from_right = (axis.ppermute(params, left_perm) if active_left
                       else buffers["right"])
    coeffs = torch.stack([coeff_self, coeff_left, coeff_right], dim=1).to(
        device=tree_leaves(params)[0].device, dtype=torch.float32)  # (n, 3)

    def silo(s):
        trees = [axis.silo(t, s) for t in (params, recv_from_left,
                                           recv_from_right)]
        a = coeffs[s]
        if use_kernel:
            spec = make_flat_spec(trees[0])
            stacked = torch.empty((3, spec.size), dtype=spec.dtype,
                                  device=a.device)
            for row, tree in zip(stacked, trees):
                ravel(spec, tree, out=row)
            return unravel(spec, gossip_combine(stacked, a))
        return tree_map(lambda w, lw, rw: (
            a[0] * w.to(torch.float32) + a[1] * lw.to(torch.float32)
            + a[2] * rw.to(torch.float32)).to(w.dtype), *trees)

    new = axis.from_silos(silo)
    return new, {"left": recv_from_left, "right": recv_from_right}


def ring_coefficients(n: int):
    """Overlay Metropolis coefficients of an n-ring, (self, left, right),
    each (n,) fp32: every node has degree 2, so every weight is 1/3. For
    n == 2 the ring degenerates to a single pair (degree 1): 1/2, 1/2, 0."""
    if n == 2:
        return (torch.full((n,), 0.5), torch.full((n,), 0.5), torch.zeros(n))
    third = torch.full((n,), 1.0 / 3.0)
    return third, third.clone(), third.clone()


def ring_matrix(n: int) -> torch.Tensor:
    """(n, n) consensus matrix of `ring_coefficients`: row i holds self at
    i, left at i - 1 and right at i + 1 (added where they coincide)."""
    cs, cl, cr = ring_coefficients(n)
    a = torch.zeros((n, n))
    for i in range(n):
        a[i, i] += cs[i]
        a[i, (i - 1) % n] += cl[i]
        a[i, (i + 1) % n] += cr[i]
    return a


def init_ring_buffers(params: Params) -> dict:
    """Stale buffers start as the silo's own weights."""
    return {"left": tree_map(torch.clone, params),
            "right": tree_map(torch.clone, params)}


# ---------------------------------------------------------------------------
# CSR cross-shard edge-source gather (the mesh runtime's collectives)
# ---------------------------------------------------------------------------
#
# Shard p holds rows [p*per, (p+1)*per) of the global (Np, T) param matrix
# and the contiguous block of dst-sorted edges whose destinations it owns.
# Each backend takes the local shards' (per, T) blocks and returns, for
# each, the (e_per, T) matrix of SOURCE rows of its edges. Index tables are
# the (D, ...) tables of fl/mesh.py; each local shard reads its own row.


def csr_gather_all(axis, w_blocks, src_global):
    """all_gather backend: materialize the full (Np, T) matrix, then a
    static row gather. Moves Np*T elements per shard however few edges
    cross shard boundaries -- the baseline.

    src_global: per local shard, the (e_per,) GLOBAL source row of each of
    its edges (pad edges may point at any valid row).
    """
    full = axis.all_gather(w_blocks)
    return [f[s] for f, s in zip(full, src_global)]


def csr_gather_halo(axis, w_blocks, send_idx, perms, gather_idx):
    """ppermute halo backend: move ONLY the rows that cross a shard
    boundary. One exchange per active shard offset o: every shard q sends
    its ``send_idx[k][q]`` rows to shard (q+o) % D at once, then each
    shard picks its edges' rows out of the concat

        [ my rows (per) | halo from offset o1 | halo from offset o2 | ... ]

    by its static ``gather_idx`` row (derived once from the CSR structure,
    fl/mesh.py). States whose strong edges stay within shards move fewer
    bytes, as `gossip_ring_ppermute` does for the ring.

    send_idx[k]: (D, H_k) LOCAL rows each shard contributes to offset k's
    exchange; perms[k]: the offset's (src, dst) shard pairs; gather_idx:
    per local shard, (e_per,) indices into its concat.
    """
    parts = [[w] for w in w_blocks]
    for tbl, perm in zip(send_idx, perms):
        for part, got in zip(parts, axis.ppermute(w_blocks, perm, tbl)):
            part.append(got)
    return [(p[0] if len(p) == 1 else torch.cat(p))[g]
            for p, g in zip(parts, gather_idx)]


def fabric_rows_per_round(backend: str, *, halo_rows: int, num_shards: int,
                          rows_padded: int) -> int:
    """Total param rows the gather backend moves across the fabric per
    round, summed over all shards -- the obs layer's `fabric_bytes`
    column is this times the flat row size.

    "halo" ships each shard's boundary-crossing rows only (`halo_rows`
    per shard, from `HaloPlan`); "all_gather" materializes the full
    padded matrix on every shard.
    """
    if backend == "halo":
        return num_shards * halo_rows
    if backend == "all_gather":
        return num_shards * rows_padded
    raise ValueError(f"unknown gossip backend {backend!r}")
