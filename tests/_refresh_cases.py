"""Cases of the fused refresh-and-aggregate (`ops.refresh_aggregate`),
drawn by numpy from a seed: shared by its CPU test against the reference
(`test_torch_refresh_aggregate.py`) and its card test against its plain
version (`test_torch_kernel_cuda.py`). Imports no jax and no torch."""

import numpy as np

# name -> keyword arguments of `segment_case`
CASES = {
    "isolated": dict(n=5, e2=12, t=33),
    "no_edges": dict(n=4, e2=0, t=17),
    "all_strong": dict(n=6, e2=14, t=65, strong="all"),
    "all_weak": dict(n=6, e2=14, t=65, strong="none"),
    "mixed": dict(n=6, e2=14, t=66, isolated=False),
    "nan_weak_zero_coeff": dict(n=5, e2=10, t=40, nan_row=True),
    "pads_past_row_ptr": dict(n=4, e2=9, t=35, pads=3),
    "edge_row_permutation": dict(n=6, e2=13, t=38, permuted=True),
    "fresh_rows_apart": dict(n=3, e2=7, t=36, fresh_apart=True, pads=2),
}
#: one call over several segments of different T: T = 1, 3, 4,099, and
#: T % 4 = 0, 1, 2, 3
MULTI_T = (1, 3, 4099, 4096, 4097, 4098)


def segment_case(seed, *, n, e2, t, strong="mixed", isolated=True,
                 nan_row=False, pads=0, permuted=False, fresh_apart=False):
    """One segment's arrays: w (n, t), buf, coeffs, row_ptr, diag, src,
    strong, edge_row (None: identity), fresh (None: w), and dst (the
    real edges' destinations, sorted). The e2 real edges are dst-sorted,
    destination 0 has none when ``isolated``; ``pads`` pad edges follow
    past the row pointer, strong, with non-zero coefficients and NaN
    buffer rows, so a pad that were read or written would show.
    ``nan_row`` puts NaN in a weak edge's buffer row and gives it
    coefficient 0; ``permuted`` keeps the buffers in a random row order
    (``edge_row``); ``fresh_apart`` makes strong edges read their own
    row of a separate ``fresh`` matrix (src None), as a mesh shard
    does."""
    rng = np.random.default_rng(seed)
    lo = 1 if isolated and n > 1 else 0
    dst = np.sort(rng.integers(lo, n, size=e2)).astype(np.int32)
    row_ptr = np.zeros(n + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.bincount(dst, minlength=n))
    e = e2 + pads
    w = rng.normal(size=(n, t)).astype(np.float32)
    buf = rng.normal(size=(e, t)).astype(np.float32)
    coeffs = rng.random(e).astype(np.float32)
    diag = rng.random(n).astype(np.float32)
    src = rng.integers(0, n, size=e).astype(np.int32)
    if strong == "all":
        mask = np.ones(e, bool)
    elif strong == "none":
        mask = np.zeros(e, bool)
    else:
        mask = rng.random(e) < 0.5
    mask[e2:] = True
    buf[e2:] = np.nan
    if nan_row:
        mask[e2 // 2] = False
        coeffs[e2 // 2] = 0.0
        buf[e2 // 2] = np.nan
    edge_row = None
    if permuted:
        edge_row = rng.permutation(e).astype(np.int32)
        unsorted = np.empty_like(buf)
        unsorted[edge_row] = buf
        buf = unsorted
    fresh = None
    if fresh_apart:
        fresh = rng.normal(size=(e, t)).astype(np.float32)
        src = None
    return dict(w=w, buf=buf, coeffs=coeffs, row_ptr=row_ptr, diag=diag,
                src=src, strong=mask, edge_row=edge_row, fresh=fresh,
                dst=dst)


def multi_t_cases(seed):
    """A call's worth of segments of MULTI_T's widths, mixed strong
    masks, the second with its buffers permuted."""
    return [segment_case(seed + k, n=4 + k % 3, e2=7 + k, t=t,
                         permuted=k == 1)
            for k, t in enumerate(MULTI_T)]

