// Fixed-K gossip combine for the ring gossip round, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gossip_combine` in
// src/repro/kernels/gossip_combine/kernel.py (`_combine_kernel`). For K
// stacked rows of weights and K coefficients it computes
//
//   out[t] = sum_k a[k] * w[k, t]
//
// in fp32, in ascending k, starting from zero, and writes the weights'
// type (fp32 or bf16). The ring round calls it with K = 3 (the silo's own
// replica and the two it received) on the whole replica packed flat.
//
// Bound. A stream: each of the K*T weights is read once and the T
// outputs written once, (K + 1)*T*4 bytes in fp32, against 2*K flops per
// output. At the ring's shape (K = 3, T = 368,226,304 fp32, mamba2-370m)
// that is 5.89 GB, 1.76 ms at the H100 SXM's 3.35 TB/s, against about
// 0.03 ms of fp32 arithmetic: memory bound.
//
// Design. The TPU kernel staged a (K, block_t) slab in VMEM per grid
// step. Here no staging is needed: a thread owns one 16-byte run of
// columns (4 fp32 or 8 bf16) at a time, in a grid-stride loop, and reads
// that run from each of the K rows with one 128-bit load, so a thread
// keeps K independent loads in flight. A row whose start is not on a
// 16-byte boundary (T not a multiple of the run, or a weights pointer
// into the middle of a buffer) is read with scalar loads instead; the
// choice is made per row on the host and is uniform across the grid. The
// T % run columns past the last whole run are done one per thread.
// Offsets are 64-bit: at the ring's width, k*T + t passes 2^31 from
// K = 6 on.
//
// K is a runtime argument, dispatched to a kernel compiled for each K in
// 1..8 (the accumulators and coefficients live in registers); a larger K
// is refused.
//
// Rounding. Every product and sum goes through __fmul_rn / __fadd_rn, so
// nvcc cannot contract them into FMAs, and the bf16 output is rounded to
// nearest even: the plain PyTorch version's arithmetic, bit for bit.
//
// Interface. A plain C entry point, loaded with ctypes. It launches on
// the stream it is given, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a K or type it does
// not take. The caller guarantees T > 0 and contiguous device arrays:
// weights (K, T), coeffs (K,) fp32, out (T,) of the weights' type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The 16-byte run as fp32 values. bf16 is the top half of an fp32, so
// the widening is a shift; element 0 is the low half of word 0.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[4], const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8],
                                      const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
    const uint32_t hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// aligned: bit k set if row k starts on a 16-byte boundary; bit kMaxK
// set if out does.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
gossip_combine_kernel(const T* __restrict__ w,
                      const float* __restrict__ coeffs, T* __restrict__ out,
                      int64_t t_len, uint32_t aligned) {
  constexpr int kRun = 16 / sizeof(T);
  float a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) a[k] = coeffs[k];

  const int64_t gid =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t runs = t_len / kRun;

  for (int64_t r = gid; r < runs; r += stride) {
    const int64_t t0 = r * kRun;
    float acc[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T* row = w + k * t_len + t0;
      float x[kRun];
      if (aligned >> k & 1u) {
        unpack(__ldg(reinterpret_cast<const uint4*>(row)), x);
      } else {
#pragma unroll
        for (int j = 0; j < kRun; ++j) x[j] = load_f32(row + j);
      }
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(a[k], x[j]));
    }
    if (aligned >> kMaxK & 1u) {
      *reinterpret_cast<uint4*>(out + t0) = pack(acc, out);
    } else {
#pragma unroll
      for (int j = 0; j < kRun; ++j) store_f32(out + t0 + j, acc[j]);
    }
  }

  // the T % kRun columns after the last whole run
  const int64_t t = runs * kRun + gid;
  if (t < t_len) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(a[k], load_f32(w + k * t_len + t)));
    store_f32(out + t, acc);
  }
}

template <typename T, int K>
void launch(const void* w, const float* coeffs, void* out, int64_t t_len,
            uint32_t aligned, int blocks, cudaStream_t stream) {
  gossip_combine_kernel<T, K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(w), coeffs, static_cast<T*>(out), t_len,
      aligned);
}

template <typename T>
int dispatch(const void* w, const float* coeffs, void* out, int64_t k,
             int64_t t_len, cudaStream_t stream) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(w);
  uint32_t aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0
                         ? 1u << kMaxK : 0u;
  for (int64_t i = 0; i < k; ++i)
    if ((base + static_cast<uintptr_t>(i * t_len) * sizeof(T)) % 16 == 0)
      aligned |= 1u << i;

  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  constexpr int64_t kRun = 16 / sizeof(T);
  const int64_t work = t_len / kRun > 0 ? t_len / kRun : 1;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int64_t need = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < cap ? need : cap);

  switch (k) {
    case 1: launch<T, 1>(w, coeffs, out, t_len, aligned, blocks, stream); break;
    case 2: launch<T, 2>(w, coeffs, out, t_len, aligned, blocks, stream); break;
    case 3: launch<T, 3>(w, coeffs, out, t_len, aligned, blocks, stream); break;
    case 4: launch<T, 4>(w, coeffs, out, t_len, aligned, blocks, stream); break;
    case 5: launch<T, 5>(w, coeffs, out, t_len, aligned, blocks, stream); break;
    case 6: launch<T, 6>(w, coeffs, out, t_len, aligned, blocks, stream); break;
    case 7: launch<T, 7>(w, coeffs, out, t_len, aligned, blocks, stream); break;
    case 8: launch<T, 8>(w, coeffs, out, t_len, aligned, blocks, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (weights and out).
extern "C" int gossip_combine(const void* w, const float* coeffs, void* out,
                              int64_t k, int64_t t_len, int32_t dtype,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(w, coeffs, out, k, t_len, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(w, coeffs, out, k, t_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
