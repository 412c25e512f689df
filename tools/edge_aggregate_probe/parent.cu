// The CSR aggregation kernel as it stood before the refresh was fused
// into it (aggregation alone: out = diag*w + sum coeffs*buf over
// dst-sorted, already refreshed buffers), kept so that probe.py here
// times it beside the kept kernel under one method. The port never
// loads it.
//
// CSR edge aggregation for the flat FL runtime, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `edge_aggregate` in
// src/repro/kernels/gossip_combine/kernel.py (`_edge_agg_kernel`). It
// computes, for every destination silo i and column t,
//
//   out[i,t] = diag[i]*w[i,t] + sum_{row_ptr[i] <= e < row_ptr[i+1]} coeffs[e]*buf[e,t]
//
// over edge buffers sorted by destination. The sum runs in fp32 in
// ascending edge order and diag*w is added last; an empty row (an
// isolated silo) gives diag*w alone.
//
// Bound. The work is a stream: each of the (2E + N) input rows is read
// once and the N output rows are written once, (2E + 2N)*T*4 bytes, with
// two flops per element read. At the main path's shape (N=11, 2E=22,
// T=1,280,478) that is 225.4 MB, about 67 us at the H100 SXM's
// 3.35 TB/s, against about 1 us of fp32 arithmetic: memory bound.
//
// Design. The TPU kernel staged the whole (2E, block_t) slab in VMEM and
// refused graphs whose slab passed 16 MB. Here a block owns one
// destination row and a tile of kThreads*kCols columns and reads only its
// own edge rows, so no slab is staged and any edge count works. The grid
// is (column tiles) x (destination rows), 11 x 1,251 = 13,761 blocks at
// the main path's shape, enough to keep 132 SMs streaming. Loads are
// scalar and coalesced: neighbouring threads read neighbouring floats and
// each thread keeps kCols independent loads in flight per edge row. Rows
// of an (N, T) matrix start on a 16-byte boundary only when T % 4 == 0
// (the main path has T % 4 == 2), so there are no float4 loads. The
// ragged tail of the last column tile is masked.
//
// Rounding. Every product and sum goes through __fmul_rn / __fadd_rn, so
// nvcc cannot contract them into FMAs. That pins the arithmetic to the
// plain PyTorch version's (a multiply, then an add, in the same order),
// and the two agree bit for bit.
//
// Interface. A plain C entry point, loaded with ctypes. It launches on
// the stream it is given, allocates nothing, and returns
// cudaGetLastError(). The caller guarantees T > 0, N >= 1, N <= 65535 and
// contiguous fp32 / int32 device arrays.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // columns per thread, kThreads apart
constexpr int kTile = kThreads * kCols;

__global__ void __launch_bounds__(kThreads)
edge_aggregate_kernel(const float* __restrict__ w,
                      const float* __restrict__ buf,
                      const float* __restrict__ coeffs,
                      const int32_t* __restrict__ row_ptr,
                      const float* __restrict__ diag,
                      float* __restrict__ out, int64_t t_len) {
  const int64_t i = blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const int start = row_ptr[i];
  const int end = row_ptr[i + 1];

  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;

  for (int e = start; e < end; ++e) {
    const float c = coeffs[e];
    const float* row = buf + static_cast<int64_t>(e) * t_len;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int64_t t = base + k * kThreads;
      if (t < t_len) acc[k] = __fadd_rn(acc[k], __fmul_rn(c, row[t]));
    }
  }

  const float d = diag[i];
  const float* w_row = w + i * t_len;
  float* out_row = out + i * t_len;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int64_t t = base + k * kThreads;
    if (t < t_len) out_row[t] = __fadd_rn(__fmul_rn(d, w_row[t]), acc[k]);
  }
}

}  // namespace

extern "C" int edge_aggregate_f32(const float* w, const float* buf,
                                  const float* coeffs, const int32_t* row_ptr,
                                  const float* diag, float* out, int64_t n,
                                  int64_t t_len, void* stream) {
  const dim3 grid(static_cast<unsigned>((t_len + kTile - 1) / kTile),
                  static_cast<unsigned>(n));
  edge_aggregate_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      w, buf, coeffs, row_ptr, diag, out, t_len);
  return static_cast<int>(cudaGetLastError());
}
