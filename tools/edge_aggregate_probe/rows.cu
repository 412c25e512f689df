// One CTA per (destination row, column tile) of any segment, EA_ROW_COLS
// columns a thread, not persistent: the layout the kept kernel
// (src/repro_torch/csrc/edge_aggregate.cu) grew from, before its
// two-edge table loads. probe.py here builds it with EA_ROW_COLS 4 and 2
// and times it beside the kept kernel. The port never loads it.
//
// Interface, Segment record and rounding as in staged.cu.
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


#ifndef EA_ROW_COLS
#define EA_ROW_COLS 4
#endif
#ifndef EA_ROW_MIN_BLOCKS
#define EA_ROW_MIN_BLOCKS 8
#endif
// One destination row i of one tile of segment s.
template <int VEC, int COLS>
__device__ __forceinline__ void run_row(const Segment& s, int64_t c0, int i) {
  constexpr int kVecs = COLS / VEC;
  const int64_t t = s.t;
  int lc[kVecs]; bool ok[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    lc[k] = (k * kThreads + static_cast<int>(threadIdx.x)) * VEC;
    ok[k] = c0 + lc[k] < t;
  }
  float* buf = s.buf + c0;
  float acc[kVecs][VEC];
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[k][q] = 0.0f;
  const int e1 = s.row_ptr[i + 1];
  for (int e = s.row_ptr[i]; e < e1; ++e) {
    const bool strong = is_strong(s, e);
    const float c = s.coeffs[e];
    const float* row = strong ? s.fresh + c0 + src_row(s, e) * t : buf + buf_row(s, e) * t;
    float v[kVecs][VEC];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) if (ok[k]) load<VEC>(v[k], row + lc[k]);
    if (strong) {
      float* dst = buf + buf_row(s, e) * t;
#pragma unroll
      for (int k = 0; k < kVecs; ++k) if (ok[k]) store<VEC>(dst + lc[k], v[k]);
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[k][q] = __fadd_rn(acc[k][q], __fmul_rn(c, v[k][q]));
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
      for (int q = 0; q < VEC; ++q) x[q] = __fadd_rn(__fmul_rn(d, x[q]), acc[k][q]);
      store<VEC>(out_i + lc[k], x);
    }
  }
}

__global__ void __launch_bounds__(kThreads, EA_ROW_MIN_BLOCKS)
rows_kernel(const __grid_constant__ Params p) {
  constexpr int COLS = EA_ROW_COLS;
  const int item = blockIdx.x;
  int g = 0;
  while (g + 1 < p.nseg && p.seg[g + 1].first <= item) ++g;
  const Segment& s = p.seg[g];
  const int local = item - s.first;
  const int tile = local / s.n, i = local - tile * s.n;
  const int64_t c0 = static_cast<int64_t>(tile) * kThreads * COLS;
  if constexpr (COLS % 4 == 0) { if (s.vec == 4) { run_row<4, COLS>(s, c0, i); return; } }
  if constexpr (COLS % 2 == 0) { if (s.vec == 2) { run_row<2, COLS>(s, c0, i); return; } }
  run_row<1, COLS>(s, c0, i);
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }
int32_t pick_vec(const Segment& s, int cols) {
  for (int vec : {4, 2}) {
    const uintptr_t b = vec * sizeof(float);
    if (cols % vec == 0 && s.t % vec == 0 && aligned(s.w, b) && aligned(s.fresh, b) && aligned(s.buf, b) && aligned(s.out, b)) return vec;
  }
  return 1;
}
}  // namespace

extern "C" int edge_aggregate_segments(const Segment* segs, int nseg, int cols, void* stream) {
  if (nseg < 1 || nseg > kMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int COLS = EA_ROW_COLS;
  Params p; p.nseg = nseg;
  int64_t items = 0;
  for (int g = 0; g < nseg; ++g) {
    Segment s = segs[g];
    s.vec = pick_vec(s, COLS); s.staged = 0; s.first = static_cast<int32_t>(items);
    items += s.n * ((s.t + kThreads * COLS - 1) / (kThreads * COLS));
    p.seg[g] = s;
  }
  p.items = static_cast<int32_t>(items);
  rows_kernel<<<static_cast<unsigned>(items), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
