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
// hd=128, causal) 137.4 GFLOP against 151 MB of q/k/v/out, at zamba2's
// (B=4, S=2048, Hq=Hkv=32, hd=64, causal) 68.7 GFLOP against 134 MB, at
// paligemma's (B=4, S=2048, Hq=8, Hkv=1, hd=256, causal, prefix 256)
// 69.8 GFLOP against 76 MB. So it is bound by operations on the card:
// 0.139, 0.0695 and 0.0706 ms at the 989 TFLOP/s bf16 tensor-core peak,
// which only wgmma reaches.
//
// Two routes, one result. Both: one CTA takes one (batch, KV head) and
// a run of consecutive rows of the flattened (qpos, g) order, so all the
// `group` query heads of its KV head share every K/V tile it loads, as
// the TPU kernel's (group*block_q, hd) q tile does; m, l and the output
// accumulator stay in registers; key tiles wholly past the causal
// diagonal, or wholly before every row's window, are skipped (unless a
// row of the CTA lies in the bidirectional prefix), which leaves the
// result the same.
//
// * Tensor cores (bf16, hd 64/128/256, group <= 128, 16-byte aligned
//   base and strides): TMA + wgmma, warp-specialised. A CTA of 3
//   warpgroups takes P = 128 / group query positions, R = P * group <=
//   128 rows. Warpgroup 0 is the producer: after `setmaxnreg.dec` one
//   thread loads the CTA's Q once and then key tiles of K and V (128 keys
//   at hd 64/128, 64 at hd 256: WgCfg) into a ring of shared-memory
//   stages through TMA (4-D tensor maps over (hd, heads, S, B) with the
//   tensors' own strides, so rows past S come in as zeros; 128-byte
//   swizzle, a tile as hd/64 boxes of 64 columns), each stage guarded by
//   `full` mbarriers (K and V apart, with the expected bytes) and an
//   `empty` one. Warpgroups 1 and 2 are consumers of 64 rows each
//   (`setmaxnreg.inc` to 240): S = Q K^T by wgmma m64n{keys}k16 from
//   shared memory (both K-major), the online softmax on the accumulator
//   in registers (exp2 with scale*log2(e) folded in; the mask is applied
//   only on tiles that the CTA's rows do not all see in full, in int32),
//   P rounded to bf16 in registers, whose accumulator layout is the
//   A-fragment of O += P V, a wgmma m64n{hd}k16 with A from registers and
//   V read in its stored layout through the transpose-B bit. Row blocks
//   run heaviest first (reverse causal order on the grid's y axis). The
//   row sum l adds the unrounded p (the reference rounds p to bf16 before
//   p@v). At hd 256 Q takes 64 KB and a stage of 64-key K and V tiles 64
//   KB, so two stages fit in 192 KB, one CTA an SM; a consumer thread
//   holds O in 128 fp32 registers, S in 32 and P in 16. Not yet:
//   ping-pong of the two consumers, softmax/MMA overlap within a
//   warpgroup, clusters with TMA multicast.
// * CUDA cores (fp32 inputs, hd 32, bf16 off the 16-byte grid, groups
//   over 128): a CTA takes 4*RW rows; per key tile of 32 it stages K and
//   V as fp32 in shared memory; lane j computes the scores of key j for
//   the warp's rows (float4 reads, row pitch hd+4 so the 8 lanes of a
//   quarter warp hit distinct banks); the row max and sum go through warp
//   shuffles; the probabilities go to shared memory and each lane
//   accumulates its hd/32 output columns from them. PERF.md has both
//   routes' times.
//
// Interface. A plain C entry point, loaded with ctypes. It launches on
// the stream it is given, allocates nothing, and returns 0 on success,
// else a CUDA runtime error code, or kCuResultBase + the CUresult of a
// tensor-map encoding that failed. dtype 0 = fp32, 1 = bf16; inputs and
// output share it; accumulation is fp32.

#include <cuda.h>
#include <cudaTypedefs.h>
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
// Tensor-core route (bf16, hd 64/128/256): TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kCuResultBase = 10000;  // added to a failed encode's CUresult
constexpr int kWgThreads = 384;       // producer warpgroup + 2 consumers
constexpr int kWgRows = 128;          // rows per CTA, 64 per consumer
constexpr int kAtomCols = 64;         // bf16 columns of a 128-byte row
constexpr int kConsumerThreads = 256;

// Shared memory: Q | K stages | V stages | mbarriers, each tile a run of
// 64-column atoms (128-byte swizzle, 1024-byte aligned): a Q atom holds
// 128 rows, a K or V atom one tile's keys.
template <int HD>
struct WgCfg {
  static constexpr int kAtoms = HD / kAtomCols;
  // keys per tile; shared memory in all: 192 KB at hd 256, 160 KB at hd
  // 128, 144 KB at hd 64
  static constexpr int kKeys = HD == 256 ? 64 : 128;
  static constexpr int kStages = HD == 64 ? 4 : 2;
  static constexpr int kQAtomBytes = kWgRows * 128;
  static constexpr int kAtomBytes = kKeys * 128;  // of a K or V tile
  static constexpr int kTileBytes = kAtoms * kAtomBytes;
  static constexpr int kKOff = kAtoms * kQAtomBytes;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kBarOff = kVOff + kStages * kTileBytes;
  static constexpr int kNumBars = 1 + 3 * kStages;
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * kNumBars;
};

struct WgArgs {
  int seq, kv_heads, group;
  int qpos_per_cta, rows;  // P and R = P * group
  int causal, window, prefix;
  float scale_log2;         // scale * log2(e)
  __nv_bfloat16* out;       // contiguous (B, S, Hkv * group, hd)
};

__device__ __forceinline__ bool visible32(int qp, int kp, const WgArgs& a) {
  bool ok = true;
  if (a.causal) ok = kp <= qp;
  if (a.window > 0) ok = ok && (qp - kp) < a.window;
  if (a.prefix > 0) ok = ok || (qp < a.prefix && kp < a.prefix);
  return ok && kp < a.seq && qp < a.seq;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a tile in shared memory with the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1. K-major (Q, K): the stride offset steps 8 rows (1024 bytes),
// the leading one is unused. MN-major (V): the stride offset steps 8 keys
// (1024 bytes), the leading one the next 64-column atom.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching wgmma operand registers across the
// asynchronous window: reads after the wait depend on this.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (+)= A . B^T, A and B K-major in shared memory (64 x 16 and 64 x 16).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (+)= A . B^T, A and B K-major in shared memory (64 x 16 and 128 x 16).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A . B, A (64 x 16) in registers, B (16 x 128) MN-major in shared
// memory (the transpose-B bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A . B, A (64 x 16) in registers, B (16 x 64) MN-major in shared
// memory (the transpose-B bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A . B, A (64 x 16) in registers, B (16 x 256) MN-major in shared
// memory (the transpose-B bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, WgArgs a) {
  using Cfg = WgCfg<HD>;
  constexpr int NS = Cfg::kStages;
  constexpr int NK = Cfg::kKeys;
  constexpr uint32_t kTile = Cfg::kTileBytes;
  constexpr uint32_t kAtom = Cfg::kAtomBytes;
  constexpr uint32_t kQAtom = Cfg::kQAtomBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + Cfg::kKOff;
  const uint32_t v_s = base + Cfg::kVOff;
  const uint32_t q_full = base + Cfg::kBarOff;
  const uint32_t k_full = q_full + 8;           // + 8 * stage
  const uint32_t v_full = k_full + 8 * NS;      // + 8 * stage
  const uint32_t empty = v_full + 8 * NS;       // + 8 * stage

  const int S = a.seq;
  const int b = blockIdx.x / a.kv_heads;
  const int h = blockIdx.x % a.kv_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * a.qpos_per_cta;  // heavy first
  const int qhi = min(q0 + a.qpos_per_cta, S) - 1;  // last real position
  // [kstart, kend): the keys any row of this CTA can see.
  const bool in_prefix = a.prefix > 0 && q0 < a.prefix;
  int kend = a.causal ? qhi + 1 : S;
  if (in_prefix) kend = max(kend, min(a.prefix, S));
  const int kstart =
      (a.window > 0 && !in_prefix) ? max(0, q0 - a.window + 1) : 0;
  const int tile0 = kstart / NK;
  const int ntiles = (kend + NK - 1) / NK - tile0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Cfg::kAtoms * a.rows * 128);
#pragma unroll
      for (int c = 0; c < Cfg::kAtoms; ++c)
        tma_load_4d(q_s + c * kQAtom, &qmap, q_full, c * kAtomCols,
                    h * a.group, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % NS;
        const int round = t / NS;
        if (round > 0) mbar_wait(empty + 8 * st, (round - 1) & 1);
        const int k0 = (tile0 + t) * NK;
        mbar_expect_tx(k_full + 8 * st, kTile);
#pragma unroll
        for (int c = 0; c < Cfg::kAtoms; ++c)
          tma_load_4d(k_s + st * kTile + c * kAtom, &kmap,
                      k_full + 8 * st, c * kAtomCols, h, k0, b);
        mbar_expect_tx(v_full + 8 * st, kTile);
#pragma unroll
        for (int c = 0; c < Cfg::kAtoms; ++c)
          tma_load_4d(v_s + st * kTile + c * kAtom, &vmap,
                      v_full + 8 * st, c * kAtomCols, h, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int G = a.group;
    const float sl2 = a.scale_log2;
    // This thread's two rows (accumulator rows lane/4 and lane/4 + 8 of
    // its warp's 16); S marks a padding row, which sees nothing.
    int qp[2], row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[r] = 64 * cw + 16 * warp + lane / 4 + 8 * r;
      const int pos = q0 + row[r] / G;
      qp[r] = (row[r] < a.rows && pos < S) ? pos : S;
    }
    const int col = 2 * (lane % 4);

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this lane's share of the row sums

    const uint64_t dq = smem_desc(q_s + cw * 64 * 128, 16, 1024);
    const uint64_t dk = smem_desc(k_s, 16, 1024);
    const uint64_t dv = smem_desc(v_s, kAtom, 1024);
    mbar_wait(q_full, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int st = t % NS;
      const uint32_t ph = (t / NS) & 1;
      const int k0 = (tile0 + t) * NK;

      // S = Q K^T: 64 rows x NK keys, hd/16 k-steps; k-step kk lies in
      // atom kk/4 at byte 32*(kk%4) of each 128-byte row.
      float s[NK / 2];
      mbar_wait(k_full + 8 * st, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col_off = (kk % 4) * 32;
        const uint32_t q_off = (kk / 4) * kQAtom + col_off;
        const uint32_t k_off = st * kTile + (kk / 4) * kAtom + col_off;
        wgmma_ss(s, dq + (q_off >> 4), dk + (k_off >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // Element 4j+e of s: row row[e/2], key k0 + 8j + col + e%2. The
      // mask runs only where some real row of the CTA misses a key.
      const bool full =
          k0 + NK <= S &&
          (((!a.causal || k0 + NK - 1 <= q0) &&
            (a.window <= 0 || qhi - k0 < a.window)) ||
           (a.prefix > 0 && qhi < a.prefix && k0 + NK <= a.prefix));
      if (!full) {
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible32(qp[e / 2], k0 + 8 * j + col + (e % 2), a))
              s[4 * j + e] = kNegInf;
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float mu[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // in log2 units; a tile with nothing visible leaves m as it was
        const float m_new =
            fmaxf(m[r], mx[r] > 0.5f * kNegInf ? mx[r] * sl2 : kNegInf);
        mu[r] = m_new > 0.5f * kNegInf ? m_new : 0.f;  // the `safe` guard
        alpha[r] = exp2f(m[r] - mu[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t pa[NK / 16][4];  // P in bf16: A fragments of NK/16 k-steps
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
        const float p0 = exp2f(fmaf(s[4 * j], sl2, -mu[0]));
        const float p1 = exp2f(fmaf(s[4 * j + 1], sl2, -mu[0]));
        const float p2 = exp2f(fmaf(s[4 * j + 2], sl2, -mu[1]));
        const float p3 = exp2f(fmaf(s[4 * j + 3], sl2, -mu[1]));
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      // O += P V: NK/16 k-steps of 16 keys, V MN-major (16 keys x hd, the
      // next 64 columns one atom on: the descriptor's leading offset).
      mbar_wait(v_full + 8 * st, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
        wgmma_rs(o, pa[kk], dv + ((st * kTile + kk * 16 * 128) >> 4));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(empty + 8 * st);
    }

    const int64_t hq = static_cast<int64_t>(a.kv_heads) * G;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (qp[r] >= S) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      const int g = row[r] % G;
      __nv_bfloat16* orow =
          a.out + ((static_cast<int64_t>(b) * S + qp[r]) * hq +
                   static_cast<int64_t>(h) * G + g) * HD + col;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
    }
  }
}

using EncodeFn = PFN_cuTensorMapEncodeTiled_v12000;

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A bf16 tensor map over (hd, heads, S, B) with element strides (1, sh,
// ss, sb) and a box of (64, box_h, box_s, 1), 128-byte swizzle; elements
// outside the tensor read as zero. Returns 0 or kCuResultBase + CUresult.
int encode_4d(CUtensorMap* map, const void* ptr, int64_t hd, int64_t heads,
              int64_t seq, int64_t batch, int64_t sh, int64_t ss, int64_t sb,
              int box_h, int box_s) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return kCuResultBase + CUDA_ERROR_NOT_FOUND;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(seq),
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(sh) * sizeof(__nv_bfloat16),
      static_cast<cuuint64_t>(ss) * sizeof(__nv_bfloat16),
      static_cast<cuuint64_t>(sb) * sizeof(__nv_bfloat16)};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(kAtomCols),
                       static_cast<cuuint32_t>(box_h),
                       static_cast<cuuint32_t>(box_s), 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kCuResultBase + static_cast<int>(r);
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 const FlashArgs& a, cudaStream_t stream) {
  using Cfg = WgCfg<HD>;
  if (a.group < 1 || a.group > kWgRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = static_cast<int>(a.group);
  const int P = kWgRows / G;
  const int64_t hq = a.kv_heads * a.group;
  CUtensorMap qm, km, vm;
  int rc = encode_4d(&qm, q, HD, hq, a.seq, a.batch, a.q_sh, a.q_ss, a.q_sb,
                     G, P);
  if (rc == 0)
    rc = encode_4d(&km, k, HD, a.kv_heads, a.seq, a.batch, a.k_sh, a.k_ss,
                   a.k_sb, 1, Cfg::kKeys);
  if (rc == 0)
    rc = encode_4d(&vm, v, HD, a.kv_heads, a.seq, a.batch, a.v_sh, a.v_ss,
                   a.v_sb, 1, Cfg::kKeys);
  if (rc != 0) return rc;
  WgArgs w;
  w.seq = static_cast<int>(a.seq);
  w.kv_heads = static_cast<int>(a.kv_heads);
  w.group = G;
  w.qpos_per_cta = P;
  w.rows = P * G;
  w.causal = static_cast<int>(a.causal);
  w.window = static_cast<int>(a.window);
  w.prefix = static_cast<int>(a.prefix);
  w.scale_log2 = a.scale * 1.4426950408889634f;
  w.out = static_cast<__nv_bfloat16*>(out);
  auto kernel = flash_fwd_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.batch * a.kv_heads),
                  static_cast<unsigned>((a.seq + P - 1) / P));
  kernel<<<grid, kWgThreads, Cfg::kSmem, stream>>>(qm, km, vm, w);
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
// -- 17 int64. The last asks for the wgmma route; the caller sets it
// only for bf16 at hd 64/128/256 with group <= 128 and 16-byte aligned
// base and strides. out is a contiguous (B, S, Hq, hd) array of the inputs'
// type.
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
  if (dims[16]) {
    // a window or prefix past S acts as S + 1; the wgmma route keeps int32
    a.window = a.window > a.seq ? a.seq + 1 : a.window;
    a.prefix = a.prefix > a.seq ? a.seq + 1 : a.prefix;
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (head_dim) {
      case 64: return launch_wgmma<64>(q, k, v, out, a, st);
      case 128: return launch_wgmma<128>(q, k, v, out, a, st);
      case 256: return launch_wgmma<256>(q, k, v, out, a, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) return dispatch_hd<float>(head_dim, q, k, v, out, a, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(head_dim, q, k, v, out, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
