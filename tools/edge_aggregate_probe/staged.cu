// A design of the fused refresh-and-aggregate that was built, held bit
// for bit against the plain version and timed against the kept kernel
// (src/repro_torch/csrc/edge_aggregate.cu), and not kept: probe.py here
// builds it with the flags of each variant and prints the readings.
// The port never loads it.
//
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
// Design. Work items are (segment, column tile) pairs, numbered segment
// after segment, walked by a grid of as many CTAs as fit on the card at
// once, each taking every gridDim-th item. A thread owns COLS columns of
// its tile (in VEC-wide vectors, kThreads*VEC apart, so a warp's access
// is one contiguous run) across every row of the segment, and nothing it
// computes depends on another thread: no barrier. For an item it first
// puts every input row it needs in flight at once, each a cp.async of
// its own columns into shared memory: the N rows of w, each weak edge's
// buffer row and, when fresh is not w, each strong edge's fresh row (when
// it is, the strong edge reads its source's row of the staged w). So a
// thread has (N + 2E)*COLS*4 bytes in flight where a plain load loop would
// have a few dozen, and the loads of a tile cost one memory latency, not
// one a destination row. It waits for its own copies (cp.async.wait_all),
// then, destination by destination, adds up the edges in order from
// shared memory, writes each strong edge's value into its buffer row and
// the output row from registers. The slab takes (N + E)*kThreads*COLS*4
// bytes a CTA (E the segment's edge count, pad edges included): 67.6 KB
// at N = 11, 2E = 22 and 512 columns. COLS is the widest of 4, 2, 1 that
// keeps it under 113 KB, two CTAs an SM; a segment whose slab passes what
// a CTA can hold (N + E above 227 at 256 columns) is read with plain
// loads instead, edge by edge. Copies and loads are 16 bytes when
// T % 4 == 0 and every row pointer of the segment is 16-byte aligned, 8
// bytes when T is even and they are 8-byte aligned (the paper's models:
// T % 4 == 2), else 4; the choice is made per segment on the host.
//
// Rounding. Every product and sum goes through __fmul_rn / __fadd_rn, so
// nvcc cannot contract them into FMAs. That pins the arithmetic to the
// plain PyTorch version's (a multiply, then an add, in the same order),
// and the two agree bit for bit.
//
// Interface. A plain C entry point, loaded with ctypes, taking a host
// array of up to kMaxSegments segment records (passed to the kernel by
// value, under 4 KB). It launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a segment
// count it does not take. The caller guarantees contiguous fp32 rows,
// int32 indices, uint8 strong flags, T >= 1, N >= 1, an injective
// edge_row, and out aliasing neither w, fresh nor buf.

#include <cuda_runtime.h>
#include <stdint.h>

// One segment. The wrapper fills the pointers, t, n and edges; the entry
// point fills vec, staged and first.
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
  int32_t edges;            // length of the per-edge arrays, pads included
  int32_t vec;              // 1, 2 or 4 floats a copy or load
  int32_t staged;           // the tile's rows go through shared memory
  int32_t first;            // index of the segment's first work item
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 32;          // keeps the parameters under 4 KB
#ifndef EA_MIN_BLOCKS
#define EA_MIN_BLOCKS 2
#endif
#ifndef EA_SMEM_TARGET
#define EA_SMEM_TARGET (113 * 1024)
#endif
constexpr int kSmemTarget = EA_SMEM_TARGET;
constexpr int kMaxDevices = 64;

struct Params {
  Segment seg[kMaxSegments];
  int32_t nseg;
  int32_t items;
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

// VEC floats from device memory into shared memory, asynchronously.
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(VEC * 4));
  }
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool is_strong(const Segment& s, int e) {
  return s.strong != nullptr && s.strong[e] != 0;
}
__device__ __forceinline__ int64_t src_row(const Segment& s, int e) {
  return s.src != nullptr ? s.src[e] : e;
}
__device__ __forceinline__ int64_t buf_row(const Segment& s, int e) {
  return s.edge_row != nullptr ? s.edge_row[e] : e;
}

// One work item, columns [c0, c0 + kThreads*COLS) of segment s. STAGED:
// every input row of the tile goes through shared memory (slot r < n: w's
// row r; slot n + e: edge e's row); else each is loaded where it is used.
template <int VEC, int COLS, bool STAGED>
__device__ __forceinline__ void run_tile(const Segment& s, int64_t c0,
                                         float* smem) {
  constexpr int kVecs = COLS / VEC;   // vectors a thread owns
  constexpr int kTile = kThreads * COLS;
  const int64_t t = s.t;
  const int n = s.n;
  const bool fresh_is_w = s.fresh == s.w;
  int lc[kVecs];                      // local column of each vector
  bool ok[kVecs];                     // inside the segment (t % VEC == 0)
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    lc[k] = (k * kThreads + static_cast<int>(threadIdx.x)) * VEC;
    ok[k] = c0 + lc[k] < t;
  }
  const float* w = s.w + c0;
  float* buf = s.buf + c0;

  if constexpr (STAGED) {
    for (int r = 0; r < n; ++r) {
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (ok[k]) copy_async<VEC>(smem + r * kTile + lc[k], w + r * t + lc[k]);
    }
#ifndef EA_W_ONLY
    for (int e = s.row_ptr[0]; e < s.row_ptr[n]; ++e) {
      const bool strong = is_strong(s, e);
      if (strong && fresh_is_w) continue;
      const float* row = strong ? s.fresh + c0 + src_row(s, e) * t
                                : buf + buf_row(s, e) * t;
      float* slot = smem + (n + e) * kTile;
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (ok[k]) copy_async<VEC>(slot + lc[k], row + lc[k]);
    }
#endif
    wait_copies();
  }

  for (int i = 0; i < n; ++i) {
    float acc[kVecs][VEC];
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[k][q] = 0.0f;
    const int e1 = s.row_ptr[i + 1];
    for (int e = s.row_ptr[i]; e < e1; ++e) {
      const bool strong = is_strong(s, e);
      const float c = s.coeffs[e];
      const float* row;
      if constexpr (STAGED) {
#ifdef EA_W_ONLY
        row = strong && fresh_is_w ? smem + src_row(s, e) * kTile
              : strong ? s.fresh + c0 + src_row(s, e) * t : buf + buf_row(s, e) * t;
#else
        row = smem + (strong && fresh_is_w ? src_row(s, e) : n + e) * kTile;
#endif
      } else {
        row = strong ? s.fresh + c0 + src_row(s, e) * t
                     : buf + buf_row(s, e) * t;
      }
      float v[kVecs][VEC];
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
        if (ok[k]) load<VEC>(v[k], row + lc[k]);
      if (strong) {
        float* dst = buf + buf_row(s, e) * t;
#pragma unroll
        for (int k = 0; k < kVecs; ++k)
          if (ok[k]) store<VEC>(dst + lc[k], v[k]);
      }
#pragma unroll
      for (int k = 0; k < kVecs; ++k)
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          acc[k][q] = __fadd_rn(acc[k][q], __fmul_rn(c, v[k][q]));
    }
    const float d = s.diag[i];
    const float* w_i = STAGED ? smem + i * kTile : w + i * t;
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
}

template <int VEC, int COLS>
__device__ __forceinline__ void run_item(const Segment& s, int64_t c0,
                                         float* smem) {
  if (s.staged)
    run_tile<VEC, COLS, true>(s, c0, smem);
  else
    run_tile<VEC, COLS, false>(s, c0, smem);
}

template <int COLS>
__global__ void __launch_bounds__(kThreads, EA_MIN_BLOCKS)
edge_aggregate_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int g = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    // a CTA's items ascend, so its segment index only moves forward
    while (g + 1 < p.nseg && p.seg[g + 1].first <= item) ++g;
    const Segment& s = p.seg[g];
    const int64_t c0 = static_cast<int64_t>(item - s.first) * kThreads * COLS;
    if constexpr (COLS % 4 == 0) {
      if (s.vec == 4) { run_item<4, COLS>(s, c0, smem); continue; }
    }
    if constexpr (COLS % 2 == 0) {
      if (s.vec == 2) { run_item<2, COLS>(s, c0, smem); continue; }
    }
    run_item<1, COLS>(s, c0, smem);
  }
}

using KernelFn = void (*)(Params);

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Floats a copy or load for segment s: its rows must all start on the
// boundary.
int32_t pick_vec(const Segment& s, int cols) {
  for (int vec : {4, 2}) {
    const uintptr_t b = vec * sizeof(float);
    if (cols % vec == 0 && s.t % vec == 0 && aligned(s.w, b) &&
        aligned(s.fresh, b) && aligned(s.buf, b) && aligned(s.out, b))
      return vec;
  }
  return 1;
}

struct DeviceInfo {
  int sms = 0;
  int optin = 0;              // shared memory a CTA may opt into
  bool attr_set[3] = {};
  size_t smem[3] = {};
  int ctas[3] = {};           // CTAs an SM holds at smem[ci]
};

DeviceInfo& device_info(int dev) {
  static DeviceInfo info[kMaxDevices];
  DeviceInfo& d = info[dev];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return d;
}

int resident_ctas(DeviceInfo& d, int ci, KernelFn fn, size_t smem) {
  if (!d.attr_set[ci]) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         d.optin);
    d.attr_set[ci] = true;
    d.ctas[ci] = 0;
  }
  if (d.ctas[ci] == 0 || d.smem[ci] != smem) {
    int ctas = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kThreads, smem);
    d.ctas[ci] = ctas > 0 ? ctas : 1;
    d.smem[ci] = smem;
  }
  return d.ctas[ci];
}

}  // namespace

// Launches one grouped refresh-and-aggregate over ``nseg`` segments.
// ``cols`` is the columns a thread owns (4, 2 or 1), or 0 to pick the
// widest whose slab leaves room for two CTAs an SM.
extern "C" int edge_aggregate_segments(const Segment* segs, int nseg,
                                       int cols, void* stream) {
  int dev = 0;
  if (nseg < 1 || nseg > kMaxSegments ||
      (cols != 0 && cols != 1 && cols != 2 && cols != 4) ||
      cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo& info = device_info(dev);
  int64_t rows = 0;  // the most slab rows a segment needs
  for (int g = 0; g < nseg; ++g)
#ifdef EA_W_ONLY
    rows = rows > segs[g].n ? rows : segs[g].n;
#elif defined(EA_FORCE_DIRECT)
    rows = 0;
#else
    rows = rows > segs[g].n + segs[g].edges ? rows
                                            : segs[g].n + segs[g].edges;
#endif
  if (cols == 0) {
    cols = 4;
    while (cols > 1 && rows * kThreads * cols * 4 > kSmemTarget) cols /= 2;
  }
  const int64_t row_bytes = int64_t{kThreads} * cols * 4;

  Params p;
  p.nseg = nseg;
  int64_t items = 0, smem = 0;
  for (int g = 0; g < nseg; ++g) {
    Segment s = segs[g];
#ifdef EA_W_ONLY
    const int64_t need = int64_t{s.n} * row_bytes;
#else
    const int64_t need = (s.n + int64_t{s.edges}) * row_bytes;
#endif
    s.vec = pick_vec(s, cols);
#ifdef EA_FORCE_DIRECT
    s.staged = 0;
#else
    s.staged = need <= info.optin;
#endif
    if (s.staged && need > smem) smem = need;
    s.first = static_cast<int32_t>(items);
    items += (s.t + kThreads * cols - 1) / (kThreads * cols);
    p.seg[g] = s;
  }
  if (items >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  p.items = static_cast<int32_t>(items);

  const int ci = cols == 4 ? 0 : cols == 2 ? 1 : 2;
  const KernelFn fn = cols == 4   ? edge_aggregate_kernel<4>
                      : cols == 2 ? edge_aggregate_kernel<2>
                                  : edge_aggregate_kernel<1>;
  const int64_t resident =
      int64_t{resident_ctas(info, ci, fn, smem)} * info.sms;
  const unsigned grid =
      static_cast<unsigned>(items < resident ? items : resident);
  fn<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
