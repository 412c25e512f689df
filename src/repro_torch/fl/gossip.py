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

The mesh runtime's gathers (`csr_gather_all`, `csr_gather_halo`,
`fabric_rows_per_round`) come with the port of `fl/mesh.py`.
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
