// Fused refresh-and-aggregate over CSR edges for the FL runtimes,
// hand-written for Hopper (sm_90a), grouped: one launch for any number of
// segments.
//
// Replaces the Pallas TPU kernel `edge_aggregate` in
// src/repro/kernels/gossip_combine/kernel.py (`_edge_agg_kernel`), and
// folds into it the buffer refresh that the TPU runtime did beside it
// (`jnp.where(strong, w[src], buf)`). A segment is one flat matrix: the
// flat runtime's (N, T) rows, one shard block of the mesh runtime, or one
// leaf of the per-leaf runtime. For each segment and each dst-sorted edge
// e with destination i,
//
//   v[e]               = fresh[src[e]]   if strong[e]   else   buf[edge_row[e]]
//   buf[edge_row[e]]   = v[e]            on strong edges only (in place)
//   out[i]             = diag[i]*w[i] + sum_{row_ptr[i] <= e < row_ptr[i+1]} coeffs[e]*v[e]
//
// The sum runs in fp32 in ascending edge order, from zero, and diag*w is
// added last; an empty row (an isolated silo) gives diag*w alone. src and
// edge_row default to the edge's own index, and a segment without a
// strong mask refreshes nothing (the plain CSR aggregation). Weak edges
// are read whatever their coefficient, so a NaN in a stale buffer shows
// in the sum. Edges outside [row_ptr[0], row_ptr[N]) (the mesh's pad
// edges) are neither read nor written.
//
// Bound. Each of the N rows of w is read once, each weak buffer row once,
// each strong buffer row written once and the N output rows written once:
// (2N + 2E)*T*4 bytes when fresh is w, plus the strong edges' fresh rows
// when it is not (the mesh's gathered rows). At the main path's shape
// (N = 11, 2E = 22, T = 1,280,478) that is 225.4 MB, about 67 us at the
// H100 SXM's 3.35 TB/s, against about 1 us of fp32 arithmetic: memory
// bound. The refresh done apart from the aggregation (a gather of w[src],
// a where over two (2E, T) matrices, then the aggregation reading the
// result) moves about 3.5 times as many bytes.
//
// Design. A CTA owns one destination row of one column tile of one
// segment, as the unfused kernel did: the grid is every segment's
// (tile, row) pairs, numbered segment after segment and, within a
// segment, row fastest, so that the N CTAs of a tile run together and a
// strong edge's read of its source's row of w finds it in L2, where that
// row's own CTA brings it (w comes from device memory once). One launch
// covers all segments: a CTA finds its segment by the segments' first
// CTA numbers, held in the kernel's parameters. A thread owns kCols
// columns of the tile in VEC-wide vectors, kThreads*VEC apart, so that a
// warp's access is one contiguous run. It walks its row's edges kBatch at
// a time: first every edge's coefficient, flag and both candidate rows
// (loads that do not wait on each other), then every edge's row (fresh
// or buffer), then the strong edges' stores into their buffer rows, then
// the sum in edge order; last diag*w and the output row. Vectors are 16
// bytes when T % 4 == 0 and every row pointer of the segment is 16-byte
// aligned, 8 bytes when T is even and they are 8-byte aligned (the
// paper's models: T % 4 == 2), else 4; the choice is made per segment on
// the host. A CTA per tile across all N rows, with w's tile (or every
// input row of it, by cp.async) staged in shared memory, was built and
// timed against this layout and lost at every shape of the paper's
// models: a slab of N or N + E rows a CTA leaves too few CTAs on an SM to
// keep device memory busy. tools/edge_aggregate_probe/probe.py builds
// those designs and times them beside this kernel.
//
// Rounding. Every product and sum goes through __fmul_rn / __fadd_rn, so
// nvcc cannot contract them into FMAs. That pins the arithmetic to the
// plain PyTorch version's (a multiply, then an add, in the same order),
// and the two agree bit for bit.
//
// Interface. A plain C entry point, loaded with ctypes, taking a host
// array of up to kMaxSegments segment records (passed to the kernel by
// value, under 4 KB). It launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(), or cudaErrorInvalidValue for
// a segment count it does not take or a grid past 2^31 - 1 CTAs. The
// caller guarantees contiguous fp32 rows, int32 indices, uint8 strong
// flags, T >= 1, N >= 1, an injective edge_row, and out aliasing neither
// w, fresh nor buf.

#include <cuda_runtime.h>
#include <stdint.h>

// One segment. The wrapper fills the pointers, t and n; the entry point
// fills vec and first.
struct Segment {
  const float* w;           // (n, t)
  const float* fresh;       // rows strong edges read; == w when fresh is w
  float* buf;               // buffer rows, refreshed in place
  float* out;               // (n, t)
  const float* coeffs;      // per edge
  const int32_t* row_ptr;   // (n + 1)
  const float* diag;        // (n)
  const int32_t* src;       // per edge: row of fresh; null = the edge
  const uint8_t* strong;    // per edge; null = nothing refreshed
  const int32_t* edge_row;  // per edge: row of buf; null = the edge
  int64_t t;
  int32_t n;
  int32_t vec;              // 1, 2 or 4 floats a load
  int32_t first;            // the segment's first CTA
};

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                 // columns a thread owns
constexpr int kTile = kThreads * kCols;  // columns a CTA owns
constexpr int kBatch = 2;                // edges whose loads are in flight together
constexpr int kMinCtas = 8;              // CTAs an SM holds: 32 registers a thread
constexpr int kMaxSegments = 32;         // keeps the parameters under 4 KB

struct Params {
  Segment seg[kMaxSegments];
  int32_t nseg;
};

template <int VEC>
__device__ __forceinline__ void load(float (&x)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (VEC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// Destination row i of the tile at column c0 of segment s.
template <int VEC>
__device__ __forceinline__ void run_row(const Segment& s, int64_t c0,
                                        int i) {
  constexpr int kVecs = kCols / VEC;  // vectors a thread owns
  const int64_t t = s.t;
  int lc[kVecs];                      // the vectors' columns in the tile
  bool ok[kVecs];                     // inside the segment (t % VEC == 0)
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    lc[k] = (k * kThreads + static_cast<int>(threadIdx.x)) * VEC;
    ok[k] = c0 + lc[k] < t;
  }
  const float* fresh = s.fresh + c0;
  float* buf = s.buf + c0;
  float acc[kVecs][VEC];
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[k][q] = 0.0f;

  const int e1 = s.row_ptr[i + 1];
  for (int e = s.row_ptr[i]; e < e1; e += kBatch) {
    float c[kBatch];
    bool strong[kBatch];
    int64_t brow[kBatch];
    const float* row[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int ee = e + j < e1 ? e + j : e;
      c[j] = s.coeffs[ee];
      strong[j] = s.strong != nullptr && s.strong[ee] != 0;
      const int64_t srow = s.src != nullptr ? s.src[ee] : ee;
      brow[j] = s.edge_row != nullptr ? s.edge_row[ee] : ee;
      row[j] = strong[j] ? fresh + srow * t : buf + brow[j] * t;
    }
    float v[kBatch][kVecs][VEC];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (e + j < e1 && ok[k]) load<VEC>(v[j][k], row[j] + lc[k]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (e + j < e1 && strong[j]) {
#pragma unroll
        for (int k = 0; k < kVecs; ++k)
          if (ok[k]) store<VEC>(buf + brow[j] * t + lc[k], v[j][k]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (e + j < e1) {
#pragma unroll
        for (int k = 0; k < kVecs; ++k)
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            acc[k][q] = __fadd_rn(acc[k][q], __fmul_rn(c[j], v[j][k][q]));
      }
    }
  }

  const float d = s.diag[i];
  const float* w_i = s.w + c0 + i * t;
  float* out_i = s.out + c0 + i * t;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (ok[k]) {
      float x[VEC];
      load<VEC>(x, w_i + lc[k]);
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        x[q] = __fadd_rn(__fmul_rn(d, x[q]), acc[k][q]);
      store<VEC>(out_i + lc[k], x);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
edge_aggregate_kernel(const __grid_constant__ Params p) {
  const int cta = static_cast<int>(blockIdx.x);
  int g = 0;
  while (g + 1 < p.nseg && p.seg[g + 1].first <= cta) ++g;
  const Segment& s = p.seg[g];
  const int local = cta - s.first;
  const int tile = local / s.n;
  const int i = local - tile * s.n;
  const int64_t c0 = static_cast<int64_t>(tile) * kTile;
  if (s.vec == 4)
    run_row<4>(s, c0, i);
  else if (s.vec == 2)
    run_row<2>(s, c0, i);
  else
    run_row<1>(s, c0, i);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Floats a load for segment s: its rows must all start on the boundary.
int32_t pick_vec(const Segment& s) {
  for (int vec : {4, 2}) {
    const uintptr_t b = vec * sizeof(float);
    if (s.t % vec == 0 && aligned(s.w, b) && aligned(s.fresh, b) &&
        aligned(s.buf, b) && aligned(s.out, b))
      return vec;
  }
  return 1;
}

}  // namespace

// Launches one grouped refresh-and-aggregate over ``nseg`` segments.
extern "C" int edge_aggregate_segments(const Segment* segs, int nseg,
                                       void* stream) {
  if (nseg < 1 || nseg > kMaxSegments)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.nseg = nseg;
  int64_t ctas = 0;
  for (int g = 0; g < nseg; ++g) {
    Segment s = segs[g];
    s.vec = pick_vec(s);
    s.first = static_cast<int32_t>(ctas);
    ctas += s.n * ((s.t + kTile - 1) / kTile);
    p.seg[g] = s;
    if (ctas >= (int64_t{1} << 31))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  edge_aggregate_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
