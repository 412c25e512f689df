// GQA flash attention (prefill) for Hopper (sm_90a), hand-written.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py (`_flash_kernel`). For
// every query row it computes softmax(q.k^T * scale + mask) @ v with an
// online softmax over key tiles, so no (S, S) score matrix ever reaches
// device memory. Masks, as the TPU kernel applies them:
//   ok = kpos < S; causal: kpos <= qpos; window: qpos - kpos < window;
//   prefix: ok |= qpos < prefix && kpos < prefix; and qpos < S.
// A row with no visible key comes out as 0 (the `safe` guard on the
// running max, and l floored at 1e-30); K/V rows past S are zero in
// shared memory before p@v.
//
// Layout. q (B, S, Hq, hd), k/v (B, S, Hkv, hd) and out (B, S, Hq, hd),
// the model's layout, read through element strides with hd contiguous:
// no transposed copy is made. Hq = Hkv * group; query head h*group + g
// attends with KV head h.
//
// Bound. The work is 4*hd flops per visible (query head, qpos, kpos)
// triple: at the yi-9b prefill shape (B=4, S=2048, Hq=32, Hkv=4,
// hd=128, causal) 137.4 GFLOP against 151 MB of q/k/v/out, so it is
// compute bound on the card (0.139 ms at the 989 TFLOP/s bf16 tensor
// peak).
//
// Two routes, one result. Both: one CTA of 4 warps takes one (batch, KV
// head) and a run of consecutive rows of the flattened (qpos, g) order,
// so all the `group` query heads of its KV head share every K/V tile it
// loads, as the TPU kernel's (group*block_q, hd) q tile does; m, l and
// the output accumulator stay in registers; key tiles wholly past the
// causal diagonal, or wholly before every row's window, are skipped
// (unless a row of the CTA lies in the bidirectional prefix), which
// leaves the result the same.
//
// * Tensor cores (bf16, hd 32/64/128, 16-byte aligned rows): the
//   FlashAttention-2 shape on mma.sync. A CTA takes 64 rows, each warp
//   16. Key tiles of 64 rows of K and V are double-buffered in shared
//   memory by cp.async (zero-filled past S), so the next tile loads while
//   this one computes. S = Q K^T runs as m16n8k16 bf16 MMAs with fp32
//   accumulators from Q fragments held in registers for the whole loop;
//   the online softmax works on the accumulator fragments (row max over
//   the 4 lanes of a quad); P is rounded to bf16 in registers, where the
//   accumulator layout of two 8-key tiles is the A fragment of the next
//   MMA, and O += P V reads V through ldmatrix.trans. The row sum l
//   adds the unrounded p (the reference rounds p to bf16 before p@v).
// * CUDA cores (fp32 inputs, or any other head dim or alignment): a CTA
//   takes 4*RW rows; per key tile of 32 it stages K and V as fp32 in
//   shared memory; lane j computes the scores of key j for the warp's
//   rows (float4 reads, row pitch hd+4 so the 8 lanes of a quarter warp
//   hit distinct banks); the row max and sum go through warp shuffles;
//   the probabilities go to shared memory and each lane accumulates its
//   hd/32 output columns from them. PERF.md has both routes' times.
//
// Interface. A plain C entry point, loaded with ctypes. It launches on
// the stream it is given, allocates nothing, and returns the CUDA error
// code (0 on success). dtype 0 = fp32, 1 = bf16; inputs and output share
// it; accumulation is fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 32;  // keys per tile, one per lane

struct FlashArgs {
  int64_t batch, seq, kv_heads, group;
  int64_t q_sb, q_ss, q_sh;  // element strides of q (B, S, Hq, hd)
  int64_t k_sb, k_ss, k_sh;  // k (B, S, Hkv, hd)
  int64_t v_sb, v_ss, v_sh;  // v (B, S, Hkv, hd)
  int64_t causal, window, prefix;
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

// Whether query position qp sees key position kp (qp == S marks a padding
// row, which sees nothing).
__device__ __forceinline__ bool visible(int qp, int kp, int S,
                                        const FlashArgs& a) {
  bool ok = true;
  if (a.causal) ok = kp <= qp;
  if (a.window > 0) ok = ok && (qp - kp) < a.window;
  if (a.prefix > 0) ok = ok || (qp < a.prefix && kp < a.prefix);
  return ok && kp < S && qp < S;
}

// [kstart, kend): the keys any row of a CTA whose rows start at flattened
// row `row0` (kRows of them) can see.
__device__ __forceinline__ void key_range(int64_t row0, int rows, int S,
                                          const FlashArgs& a, int* kstart,
                                          int* kend) {
  const int qlo = static_cast<int>(row0 / a.group);
  const int qhi = static_cast<int>(
      min((row0 + rows - 1) / a.group, static_cast<int64_t>(S - 1)));
  const bool in_prefix = a.prefix > 0 && qlo < a.prefix;
  *kend = a.causal ? qhi + 1 : S;
  if (in_prefix) *kend = max(*kend, static_cast<int>(min(a.prefix, a.seq)));
  *kstart = 0;
  if (a.window > 0 && !in_prefix)
    *kstart = max(0, qlo - static_cast<int>(a.window) + 1);
}

template <int HD, int RW>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kWarps * RW + 2 * kBlockK) * (HD + 4) +
         static_cast<size_t>(kWarps) * RW * kBlockK;
}

template <typename T, int HD, int RW>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, FlashArgs a) {
  constexpr int kRows = kWarps * RW;
  constexpr int kPitch = HD + 4;
  constexpr int kCols = HD / 32;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kRows x kPitch
  float* ks = qs + kRows * kPitch;              // kBlockK x kPitch
  float* vs = ks + kBlockK * kPitch;            // kBlockK x kPitch
  float* ps = vs + kBlockK * kPitch;            // kWarps x RW x kBlockK

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t b = blockIdx.y / a.kv_heads;
  const int64_t h = blockIdx.y % a.kv_heads;
  const int64_t G = a.group;
  const int S = static_cast<int>(a.seq);
  const int64_t nrows = a.seq * G;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;

  const T* qb = q + b * a.q_sb;
  const T* kb = k + b * a.k_sb + h * a.k_sh;
  const T* vb = v + b * a.v_sb + h * a.v_sh;

  // Stage this CTA's query rows in fp32; rows past S*G are zero.
  for (int idx = threadIdx.x; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int64_t f = row0 + r;
    float x = 0.f;
    if (f < nrows) {
      const int64_t qp = f / G;
      const int64_t g = f % G;
      x = to_f32(qb[qp * a.q_ss + (h * G + g) * a.q_sh + d]);
    }
    qs[r * kPitch + d] = x;
  }

  int qpos[RW];  // S marks a padding row: the mask then rejects every key
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int64_t f = row0 + warp * RW + i;
    qpos[i] = f < nrows ? static_cast<int>(f / G) : S;
  }

  int kstart, kend;
  key_range(row0, kRows, S, a, &kstart, &kend);

  float m[RW], l[RW], acc[RW][kCols];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const float* qw = qs + warp * RW * kPitch;
  float* pw = ps + warp * RW * kBlockK;

  for (int k0 = (kstart / kBlockK) * kBlockK; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // q staged; the previous tile's K/V/P reads done
    for (int idx = threadIdx.x; idx < kBlockK * HD; idx += kThreads) {
      const int j = idx / HD;
      const int d = idx % HD;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < S) {
        kx = to_f32(kb[static_cast<int64_t>(kp) * a.k_ss + d]);
        vx = to_f32(vb[static_cast<int64_t>(kp) * a.v_ss + d]);
      }
      ks[j * kPitch + d] = kx;
      vs[j * kPitch + d] = vx;
    }
    __syncthreads();

    // Scores of key k0+lane against the warp's rows.
    float s[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.f;
    const float* krow = ks + lane * kPitch;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + i * kPitch + d);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    // Mask and online softmax, one row at a time across the warp.
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const bool ok = visible(qpos[i], kp, S, a);
      const float sc = ok ? s[i] * a.scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const bool safe = m_new > 0.5f * kNegInf;
      const float alpha = safe ? expf(m[i] - m_new) : 0.f;
      const float p = ok ? expf(sc - m_new) : 0.f;
      l[i] = alpha * l[i] + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      pw[i * kBlockK + lane] = p;
    }
    __syncwarp();

    // acc += P @ V; lane owns columns lane + 32*c.
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          vv[jj][c] = vs[(j + jj) * kPitch + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 pp = *reinterpret_cast<const float4*>(pw + i * kBlockK + j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[i][c] = fmaf(pp.x, vv[0][c], acc[i][c]);
          acc[i][c] = fmaf(pp.y, vv[1][c], acc[i][c]);
          acc[i][c] = fmaf(pp.z, vv[2][c], acc[i][c]);
          acc[i][c] = fmaf(pp.w, vv[3][c], acc[i][c]);
        }
      }
    }
  }

  const int64_t hq = a.kv_heads * G;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int64_t f = row0 + warp * RW + i;
    if (f >= nrows) continue;
    const int64_t qp = f / G;
    const int64_t g = f % G;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + ((b * a.seq + qp) * hq + h * G + g) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      orow[lane + 32 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16)
// ---------------------------------------------------------------------------

constexpr int kMmaRows = kWarps * 16;  // rows per CTA, 16 per warp
constexpr int kMmaKeys = 64;           // keys per tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int HD>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(kMmaRows + 4 * kMmaKeys) * (HD + 8) *
         sizeof(__nv_bfloat16);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, FlashArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int kPitch = HD + 8;  // 16-byte rows; quads hit distinct banks
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int kKSteps = HD / 16;
  constexpr int kNTiles = kMmaKeys / 8;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // kMmaRows x kPitch
  bf16* ks = qs + kMmaRows * kPitch;          // 2 x kMmaKeys x kPitch
  bf16* vs = ks + 2 * kMmaKeys * kPitch;      // 2 x kMmaKeys x kPitch

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t b = blockIdx.y / a.kv_heads;
  const int64_t h = blockIdx.y % a.kv_heads;
  const int64_t G = a.group;
  const int S = static_cast<int>(a.seq);
  const int64_t nrows = a.seq * G;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kMmaRows;

  const bf16* qb = q + b * a.q_sb;
  const bf16* kb = k + b * a.k_sb + h * a.k_sh;
  const bf16* vb = v + b * a.v_sb + h * a.v_sh;

  for (int idx = threadIdx.x; idx < kMmaRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int64_t f = row0 + r;
    const int64_t ff = f < nrows ? f : 0;
    cp_async16(qs + r * kPitch + c * 8,
               qb + (ff / G) * a.q_ss + (h * G + ff % G) * a.q_sh + c * 8,
               f < nrows);
  }
  cp_async_commit();

  int kstart, kend;
  key_range(row0, kMmaRows, S, a, &kstart, &kend);
  const int tile0 = (kstart / kMmaKeys) * kMmaKeys;
  const int ntiles = (kend - tile0 + kMmaKeys - 1) / kMmaKeys;

  auto load_kv = [&](int k0, int buf) {
    for (int idx = threadIdx.x; idx < kMmaKeys * kChunks; idx += kThreads) {
      const int j = idx / kChunks;
      const int c = idx % kChunks;
      const int kp = k0 + j;
      const int64_t kk = kp < S ? kp : 0;
      cp_async16(ks + (buf * kMmaKeys + j) * kPitch + c * 8,
                 kb + kk * a.k_ss + c * 8, kp < S);
      cp_async16(vs + (buf * kMmaKeys + j) * kPitch + c * 8,
                 vb + kk * a.v_ss + c * 8, kp < S);
    }
    cp_async_commit();
  };
  if (ntiles > 0) {
    load_kv(tile0, 0);
    cp_async_wait<1>();  // the query rows; the first K/V tile may be in flight
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // This warp's 16 query rows as m16n8k16 A fragments, for the whole loop.
  const int gr = lane / 4;        // fragment row (and row + 8)
  const int gc = 2 * (lane % 4);  // fragment column pair
  uint32_t qf[kKSteps][4];
  {
    const bf16* qw = qs + warp * 16 * kPitch;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      qf[kk][0] = lds32(qw + gr * kPitch + kk * 16 + gc);
      qf[kk][1] = lds32(qw + (gr + 8) * kPitch + kk * 16 + gc);
      qf[kk][2] = lds32(qw + gr * kPitch + kk * 16 + gc + 8);
      qf[kk][3] = lds32(qw + (gr + 8) * kPitch + kk * 16 + gc + 8);
    }
  }
  int qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t f = row0 + warp * 16 + gr + 8 * r;
    qp[r] = f < nrows ? static_cast<int>(f / G) : S;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = tile0 + t * kMmaKeys;
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_kv(k0 + kMmaKeys, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + buf * kMmaKeys * kPitch;
    const bf16* vt = vs + buf * kMmaKeys * kPitch;

    // S = Q K^T for 16 rows x 64 keys: 8 accumulator tiles of 16 x 8.
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const bf16* kr = kt + (j * 8 + gr) * kPitch + gc;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        mma_bf16(s[j], qf[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
    }

    // Mask, scale, online softmax. Element e of tile j is row gr + 8*(e/2),
    // key k0 + 8*j + gc + (e%2).
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = visible(qp[e / 2], k0 + 8 * j + gc + (e % 2), S, a);
        s[j][e] = ok ? s[j][e] * a.scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = m_new > 0.5f * kNegInf ? expf(m[r] - m_new) : 0.f;
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const float p = s[j][e] > 0.5f * kNegInf ? expf(s[j][e] - m[r]) : 0.f;
        s[j][e] = p;
        l[r] += p;
      }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, 16 keys per step; P's accumulator tiles 2*kk, 2*kk+1 form
    // the A fragment.
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int mi = lane / 8;  // which 8x8 matrix this lane addresses
      const bf16* vrow =
          vt + (kk * 16 + (mi & 1) * 8 + lane % 8) * kPitch + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < HD / 8; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vrow + n * 8);
        mma_bf16(o[n], pa, vf[0], vf[1]);
        mma_bf16(o[n + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  const int64_t hq = a.kv_heads * G;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int64_t f = row0 + warp * 16 + gr + 8 * r;
    if (f >= nrows) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = out + ((b * a.seq + f / G) * hq + h * G + f % G) * HD + gc;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HD>();
  auto kernel = flash_fwd_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nrows = a.seq * a.group;
  const dim3 grid(static_cast<unsigned>((nrows + kMmaRows - 1) / kMmaRows),
                  static_cast<unsigned>(a.batch * a.kv_heads));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           const FlashArgs& a, cudaStream_t stream) {
  constexpr int RW = HD >= 256 ? 8 : 16;  // registers: RW * HD/32 acc
  constexpr int kRows = kWarps * RW;
  const size_t smem = smem_floats<HD, RW>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, HD, RW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nrows = a.seq * a.group;
  const dim3 grid(static_cast<unsigned>((nrows + kRows - 1) / kRows),
                  static_cast<unsigned>(a.batch * a.kv_heads));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int head_dim, const void* q, const void* k, const void* v,
                void* out, const FlashArgs& a, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, out, a, stream);
    case 64: return launch<T, 64>(q, k, v, out, a, stream);
    case 128: return launch<T, 128>(q, k, v, out, a, stream);
    case 256: return launch<T, 256>(q, k, v, out, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dims: batch, seq, kv_heads, group, q strides (b, s, h), k strides
// (b, s, h), v strides (b, s, h), causal, window, prefix, tensor cores
// -- 17 int64. The last asks for the tensor-core route; the caller sets
// it only for bf16 at hd 32/64/128 with 16-byte aligned rows. out is a
// contiguous (B, S, Hq, hd) array of the inputs' type.
extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v, void* out,
                                   const int64_t* dims, float scale,
                                   void* stream) {
  FlashArgs a;
  a.batch = dims[0];
  a.seq = dims[1];
  a.kv_heads = dims[2];
  a.group = dims[3];
  a.q_sb = dims[4];
  a.q_ss = dims[5];
  a.q_sh = dims[6];
  a.k_sb = dims[7];
  a.k_ss = dims[8];
  a.k_sh = dims[9];
  a.v_sb = dims[10];
  a.v_ss = dims[11];
  a.v_sh = dims[12];
  a.causal = dims[13];
  a.window = dims[14];
  a.prefix = dims[15];
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dims[16] && dtype == 1) {
    switch (head_dim) {
      case 32: return launch_mma<32>(q, k, v, out, a, st);
      case 64: return launch_mma<64>(q, k, v, out, a, st);
      case 128: return launch_mma<128>(q, k, v, out, a, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) return dispatch_hd<float>(head_dim, q, k, v, out, a, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(head_dim, q, k, v, out, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
