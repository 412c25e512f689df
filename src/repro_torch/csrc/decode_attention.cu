// One-token decode attention against a KV cache (flash-decoding) for
// Hopper (sm_90a), hand-written.
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention/kernel.py (`_decode_kernel`). For
// each sequence b and query head it computes
//   softmax(q . k[pos]^T * scale, pos < lengths[b]) @ v[pos]
// over the cache; entries at or past lengths[b] are never read.
//
// Layout. q (B, Hq, hd); k/v caches (B, S, Hkv, hd), the transformer's
// own layout, read through element strides with hd contiguous (the
// reference swaps the cache to (B, Hkv, S, hd), which in PyTorch would
// copy the whole cache per layer per step); out (B, Hq, hd) contiguous.
// Query head h*group + g attends with KV head h.
//
// Bound. Each visible cache row is read once (k and v: 2*Hkv*hd
// elements per position) for 4*Hq*hd flops: about one flop per byte in
// bf16, far below the card's ridge, so the kernel is bound by the bytes
// of the lengths[b] rows it must read.
//
// Design. The TPU kernel streams all S per (b, KV head) through one
// core. On the card B*Hkv programs would leave most of the 132 SMs idle
// (32 at B=8, Hkv=4), so the sequence is split: each warp takes `chunk`
// consecutive positions of one (b, KV head) and keeps its own online
// softmax (m, l and an unnormalised accumulator for up to 8 query heads)
// in registers; a second, small kernel combines the splits of each
// (b, KV head) with the usual rescaling. Splits that start at or past
// lengths[b] return at once and the combine never reads them. Within a
// split, lane j reads cache row j of a 32-row tile with 16-byte loads
// and computes its scores against the query heads held in shared memory
// (broadcast reads); the probabilities go through shared memory and each
// lane accumulates hd/32 contiguous output columns from coalesced reads
// of the V rows. Groups of more than 8 query heads take more CTAs along
// grid z.
//
// Interface. A plain C entry point, loaded with ctypes. It launches the
// split kernel and the combine kernel on the stream it is given,
// allocates nothing (the caller passes the fp32 split workspace), and
// returns the CUDA error code (0 on success). dtype 0 = fp32, 1 = bf16;
// accumulation is fp32. The caller guarantees 1 <= lengths[b] <= S and
// 16-byte aligned cache rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 32;  // cache rows per tile, one per lane
constexpr int kMaxRows = 8;  // query heads per CTA

struct DecodeArgs {
  int64_t batch, seq, kv_heads, group;
  int64_t q_sb, q_sh;        // element strides of q (B, Hq, hd)
  int64_t k_sb, k_ss, k_sh;  // k cache (B, S, Hkv, hd)
  int64_t v_sb, v_ss, v_sh;  // v cache (B, S, Hkv, hd)
  int64_t chunk;             // cache rows per split
  int64_t num_splits;        // splits per sequence, ceil(S / chunk)
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive elements (N in 1, 2, 4, 8) at a 4*N-byte (fp32) or
// 2*N-byte (bf16) aligned address, as fp32.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* o) {
  if constexpr (N == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x; o[1] = a.y;
  } else {
    o[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 1) {
    o[0] = __bfloat162float(p[0]);
  } else {
    // N bf16 = N/2 bf16x2 words, fetched as one 4/8/16-byte load.
    uint32_t w[N / 2];
    if constexpr (N == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    } else if constexpr (N == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x; w[1] = u.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (ceil(num_splits / kWarps), B*Hkv, ceil(group / kMaxRows)); warp w
// of CTA x handles split x*kWarps + w. Writes, per used split and query
// head, the split's running max, sum and unnormalised accumulator.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ ws_m, float* __restrict__ ws_l,
                    float* __restrict__ ws_acc, DecodeArgs a) {
  constexpr int kCols = HD / 32;
  __shared__ __align__(16) float qs[kMaxRows][HD];
  __shared__ __align__(16) float ps[kWarps][kMaxRows][kBlockK];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / a.kv_heads;
  const int64_t h = bh % a.kv_heads;
  const int64_t G = a.group;
  const int64_t g0 = static_cast<int64_t>(blockIdx.z) * kMaxRows;
  const int ng = static_cast<int>(min(static_cast<int64_t>(kMaxRows), G - g0));
  const int64_t len = lengths[b];

  if (static_cast<int64_t>(blockIdx.x) * kWarps * a.chunk >= len) return;

  for (int idx = threadIdx.x; idx < kMaxRows * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    qs[r][d] = r < ng ? to_f32(q[b * a.q_sb + (h * G + g0 + r) * a.q_sh + d])
                      : 0.f;
  }
  __syncthreads();

  const int64_t split = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t kbeg = split * a.chunk;
  if (kbeg >= len) return;  // warp-uniform
  const int64_t kstop = min(len, kbeg + a.chunk);

  const T* kb = k + b * a.k_sb + h * a.k_sh;
  const T* vb = v + b * a.v_sb + h * a.v_sh;

  float m[kMaxRows], l[kMaxRows], acc[kMaxRows][kCols];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int64_t k0 = kbeg; k0 < kstop; k0 += kBlockK) {
    const int64_t kp = k0 + lane;
    const bool valid = kp < kstop;
    float s[kMaxRows];
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) s[i] = 0.f;
    if (valid) {
      const T* krow = kb + kp * a.k_ss;
#pragma unroll
      for (int d = 0; d < HD; d += 8) {
        float kk[8];
        load_f32<8>(krow + d, kk);
#pragma unroll
        for (int i = 0; i < kMaxRows; ++i) {
          const float4 q0 = *reinterpret_cast<const float4*>(&qs[i][d]);
          const float4 q1 = *reinterpret_cast<const float4*>(&qs[i][d + 4]);
          s[i] = fmaf(q0.x, kk[0], s[i]);
          s[i] = fmaf(q0.y, kk[1], s[i]);
          s[i] = fmaf(q0.z, kk[2], s[i]);
          s[i] = fmaf(q0.w, kk[3], s[i]);
          s[i] = fmaf(q1.x, kk[4], s[i]);
          s[i] = fmaf(q1.y, kk[5], s[i]);
          s[i] = fmaf(q1.z, kk[6], s[i]);
          s[i] = fmaf(q1.w, kk[7], s[i]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      const float sc = valid ? s[i] * a.scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const bool safe = m_new > 0.5f * kNegInf;
      const float alpha = safe ? expf(m[i] - m_new) : 0.f;
      const float p = valid ? expf(sc - m_new) : 0.f;
      l[i] = alpha * l[i] + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      ps[warp][i][lane] = p;
    }
    __syncwarp();

    const int nk = static_cast<int>(min(static_cast<int64_t>(kBlockK),
                                        kstop - k0));
    // Eight V rows in flight at a time; p is 0 past nk.
    for (int j0 = 0; j0 < nk; j0 += 8) {
      float vv[8][kCols];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (j0 + jj < nk) {
          load_f32<kCols>(vb + (k0 + j0 + jj) * a.v_ss + lane * kCols,
                          vv[jj]);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) vv[jj][c] = 0.f;
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i = 0; i < kMaxRows; ++i) {
          const float p = ps[warp][i][j0 + jj];
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[i][c] = fmaf(p, vv[jj][c], acc[i][c]);
        }
    }
    __syncwarp();
  }

  const int64_t base = (bh * a.num_splits + split) * G + g0;
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i >= ng) break;
    if (lane == 0) {
      ws_m[base + i] = m[i];
      ws_l[base + i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      ws_acc[(base + i) * HD + lane * kCols + c] = acc[i][c];
  }
}

// grid (B*Hkv): merges the ceil(lengths[b] / chunk) used splits.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const int32_t* __restrict__ lengths,
                      const float* __restrict__ ws_m,
                      const float* __restrict__ ws_l,
                      const float* __restrict__ ws_acc, T* __restrict__ out,
                      DecodeArgs a) {
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / a.kv_heads;
  const int64_t h = bh % a.kv_heads;
  const int64_t G = a.group;
  const int64_t used = (static_cast<int64_t>(lengths[b]) + a.chunk - 1) /
                       a.chunk;
  for (int64_t idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int64_t g = idx / HD;
    const int64_t c = idx % HD;
    float mx = kNegInf;
    for (int64_t s = 0; s < used; ++s)
      mx = fmaxf(mx, ws_m[(bh * a.num_splits + s) * G + g]);
    float lsum = 0.f, o = 0.f;
    for (int64_t s = 0; s < used; ++s) {
      const int64_t r = (bh * a.num_splits + s) * G + g;
      const float w = expf(ws_m[r] - mx);
      lsum = fmaf(w, ws_l[r], lsum);
      o = fmaf(w, ws_acc[r * HD + c], o);
    }
    out[((b * a.kv_heads + h) * G + g) * HD + c] =
        from_f32<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v,
           const int32_t* lengths, float* ws_m, float* ws_l, float* ws_acc,
           void* out, const DecodeArgs& a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.num_splits + kWarps - 1) / kWarps),
                  static_cast<unsigned>(a.batch * a.kv_heads),
                  static_cast<unsigned>((a.group + kMaxRows - 1) / kMaxRows));
  decode_split_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, ws_m, ws_l, ws_acc, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T, HD>
      <<<static_cast<unsigned>(a.batch * a.kv_heads), kThreads, 0, stream>>>(
          lengths, ws_m, ws_l, ws_acc, static_cast<T*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int head_dim, const void* q, const void* k, const void* v,
                const int32_t* lengths, float* ws_m, float* ws_l,
                float* ws_acc, void* out, const DecodeArgs& a,
                cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, lengths, ws_m, ws_l, ws_acc, out, a, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, ws_m, ws_l, ws_acc, out, a, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, ws_m, ws_l, ws_acc, out, a, stream);
    case 256: return launch<T, 256>(q, k, v, lengths, ws_m, ws_l, ws_acc, out, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dims: batch, seq, kv_heads, group, q strides (b, h), k strides
// (b, s, h), v strides (b, s, h), chunk, num_splits -- 14 int64. The
// workspace holds B*Hkv*num_splits*group floats in ws_m and ws_l and
// hd times as many in ws_acc.
extern "C" int decode_attention_fwd(int dtype, int head_dim, const void* q,
                                    const void* k, const void* v,
                                    const int32_t* lengths, float* ws_m,
                                    float* ws_l, float* ws_acc, void* out,
                                    const int64_t* dims, float scale,
                                    void* stream) {
  DecodeArgs a;
  a.batch = dims[0];
  a.seq = dims[1];
  a.kv_heads = dims[2];
  a.group = dims[3];
  a.q_sb = dims[4];
  a.q_sh = dims[5];
  a.k_sb = dims[6];
  a.k_ss = dims[7];
  a.k_sh = dims[8];
  a.v_sb = dims[9];
  a.v_ss = dims[10];
  a.v_sh = dims[11];
  a.chunk = dims[12];
  a.num_splits = dims[13];
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(head_dim, q, k, v, lengths, ws_m, ws_l, ws_acc,
                              out, a, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(head_dim, q, k, v, lengths, ws_m, ws_l,
                                      ws_acc, out, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
