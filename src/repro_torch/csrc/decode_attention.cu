// One-token decode attention against a KV cache (flash-decoding) for
// Hopper (sm_90a), hand-written: one launch, combined inside a thread-
// block cluster.
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention/kernel.py (`_decode_kernel`). For
// each sequence b and query head it computes
//   softmax(q . k[pos]^T * scale, pos < lengths[b]) @ v[pos]
// over the cache with fp32 accumulation; entries at or past lengths[b]
// never reach the result.
//
// Layout. q (B, Hq, hd); k/v caches (B, S, Hkv, hd), the transformer's
// own layout (a layer slice of a stacked cache too), read in place
// through 4-D tensor maps over (hd, Hkv, S, B) with the caches' own
// strides; out (B, Hq, hd) contiguous. Query head h*group + g attends
// with KV head h.
//
// Bound. Each visible cache row is read once (k and v: 2*Hkv*hd elements
// per position) for 4*Hq*hd flops: about one flop per byte in bf16, far
// below the card's ridge, so the kernel is bound by the bytes of the
// lengths[b] rows it must read; at decode lengths (tens to hundreds of
// rows) by latency: one launch, loads in flight early, few steps.
//
// Design.
// * Grid (nsplit, B*Hkv, ceil(group / 32)) (16 in fp32), cluster
//   (nsplit, 1, 1), launched with cudaLaunchKernelEx, so K/V are read
//   once per (b, KV head) up to 32 query heads. nsplit comes from the
//   shapes alone
//   (ops.num_splits), so the grid does not depend on the values in
//   `lengths` and nothing is read back on the host. CTA rank r of the
//   cluster of (b, KV head h) reads lengths[b] and takes rows
//   [r*span, min(len, (r+1)*span)), span = ceil(len / nsplit) rounded up
//   to the 64-row tile. A CTA with no rows joins the cluster barriers
//   with m = -inf and l = 0.
// * Loads: one thread of a producer warp issues TMA loads of 64-row K
//   and V tiles into a ring of stages, guarded by full (expected bytes)
//   and empty mbarriers. bf16 tiles use the 128-byte swizzle (64 bytes
//   at hd 32), one 64-column box per atom, so the ldmatrix reads below
//   hit distinct banks; fp32 tiles are unswizzled rows.
// * Compute: 4 consumer warps per group of 8 query heads; warp (rw, ng)
//   takes rows 16*rw..16*rw+15 of every tile against query heads
//   8*ng..8*ng+7 with its own online softmax (exp2, scale*log2(e) folded
//   in). bf16: S^T = K Q^T by mma.sync.m16n8k16 (A: 16 key rows by
//   ldmatrix, B: the query heads staged in shared memory), then
//   O^T += V^T P^T (A: V through ldmatrix.trans, B: P rounded to bf16 and
//   moved through shared memory into B-fragment order). fp32 (the tests'
//   and the reduced fp32 models' route, e.g. the serving fleet's at hd
//   32): the same thread-to-(key, head) and (column, head) maps
//   with FMAs on the CUDA cores, so no TF32 rounding. A box reads whole
//   tiles, so rows at or past the CTA's end reach shared memory: their
//   scores are selected to -inf and their V elements selected to 0 in
//   registers before the products (0 * NaN would be NaN), never
//   multiplied by a mask.
// * Combine: the 4 row warps of a head group merge in fixed order into
//   the CTA's (m, l, acc[g][hd]) in shared memory. After cluster.sync(),
//   rank r merges output columns [r*hd/nsplit, (r+1)*hd/nsplit) of every
//   rank through distributed shared memory, in rank order (deterministic,
//   no atomics), and writes out; a second cluster.sync() keeps each CTA's
//   shared memory alive until its peers have read it.
//
// Interface. A plain C entry point, loaded with ctypes. It launches on
// the stream it is given, allocates nothing, and returns 0 on success,
// else a CUDA runtime error code, or kCuResultBase + the CUresult of a
// tensor-map encoding that failed. dtype 0 = fp32, 1 = bf16. The caller
// guarantees 1 <= lengths[b] <= S, 16-byte aligned cache bases and
// strides, and 1 <= nsplit <= 8.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kCuResultBase = 10000;  // added to a failed encode's CUresult
constexpr int kTile = 64;             // cache rows per TMA tile
constexpr int kRowWarps = 4;          // 16 rows of a tile each
// Ring bytes aimed at: at decode lengths a CTA takes a few tiles, so a
// small ring keeps several CTAs on an SM (at least 2 stages in bf16).
constexpr int kStageBudget = 32 * 1024;
constexpr int kPPitch = 24;              // bf16 per P row (16 keys + pad)

struct DecodeArgs {
  int batch, seq, kv_heads, group;
  int64_t q_sb, q_sh;  // element strides of q (B, Hq, hd)
  int nsplit;
  int heads_cta;       // query heads of this CTA's group padded to 8: GP
  float scale_log2;    // scale * log2(e)
};

// Shared memory of one CTA, in bytes from a 1024-aligned base.
template <typename T, int HD>
struct Cfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  // Query heads per CTA (grid z beyond): 4 consumer warps per 8 heads
  // and one producer warp. At 32 heads (17 warps) ptxas caps a thread at
  // 96 registers, which the bf16 kernels fit; the fp32 ones (tests only)
  // take 16 heads (9 warps, 168 registers).
  static constexpr int kHeads = kBf16 ? 32 : 16;
  static constexpr int kMaxThreads = 32 * (kRowWarps * kHeads / 8 + 1);
  // bf16: atoms of 64 columns (128-byte rows; 64-byte rows at hd 32)
  static constexpr int kRowBytes = kBf16 ? (HD < 64 ? HD : 64) * 2 : HD * 4;
  static constexpr int kAtoms = kBf16 ? (HD < 64 ? 1 : HD / 64) : 1;
  static constexpr int kAtomBytes = kTile * kRowBytes;
  static constexpr int kTileBytes = kAtoms * kAtomBytes;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages0 = kStageBudget / kStageBytes;
  static constexpr int kStages =
      kStages0 > 4 ? 4 : (kStages0 < (kBf16 ? 2 : 1) ? (kBf16 ? 2 : 1)
                                                     : kStages0);
  static constexpr int kSwizzleMask = kRowBytes == 128 ? 7 : 3;
  static constexpr int kQPitch = kBf16 ? HD + 8 : HD + 4;  // elements
  static constexpr int kAccPitch = HD + 4;                 // floats
  static constexpr int kRing = kStages * kStageBytes;
  // the rest depends on GP (query heads per CTA, padded to 8)
  __host__ __device__ static size_t q_off() { return kRing; }
  __host__ __device__ static size_t p_off(int gp) {
    return q_off() + static_cast<size_t>(gp) * kQPitch * sizeof(T);
  }
  // m, l per row warp; m, l per CTA; the merge's rank weights and 1 / l
  __host__ __device__ static size_t stat_off(int gp) {  // P: gp / 2 warps
    return p_off(gp) + static_cast<size_t>(gp / 2) * 8 * kPPitch * 4;
  }
  __host__ __device__ static size_t acc_off(int gp) {
    return stat_off(gp) + static_cast<size_t>(2 * kRowWarps + 11) * gp * 4;
  }
  __host__ __device__ static size_t bar_off(int gp) {
    return acc_off(gp) + static_cast<size_t>(gp) * kAccPitch * 4;
  }
  __host__ __device__ static size_t bytes(int gp) {
    return 1024 + bar_off(gp) + 16 * kStages;
  }
};

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

// Consumer warps only: named barrier 1.
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D += A . B, m16n8k16, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset in a tile of row `row`, 16-byte chunk `chunk` of the full
// hd-wide row: the atom of the chunk, then the TMA swizzle inside it
// (address bits [4, 4 + log2(mask + 1)) ^= bits [7, ...)).
template <typename T, int HD>
__device__ __forceinline__ uint32_t tile_off(int row, int chunk) {
  using C = Cfg<T, HD>;
  constexpr int kChunks = C::kRowBytes / 16;
  uint32_t o = row * C::kRowBytes + (chunk % kChunks) * 16;
  o ^= ((o >> 7) & C::kSwizzleMask) << 4;
  return (chunk / kChunks) * C::kAtomBytes + o;
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::kMaxThreads, 1)
decode_attn_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const T* __restrict__ q, const int32_t* __restrict__ lengths,
                   T* __restrict__ out, DecodeArgs a) {
  using C = Cfg<T, HD>;
  constexpr int NS = C::kStages;
  constexpr int kMT = HD / 16;  // 16-column blocks of hd
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int gp = a.heads_cta;
  uint8_t* base_ptr = smem_raw + ((1024u - (static_cast<uint32_t>(
      __cvta_generic_to_shared(smem_raw)) & 1023u)) & 1023u);
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(base_ptr));
  T* qs = reinterpret_cast<T*>(base_ptr + C::q_off());
  float* stat = reinterpret_cast<float*>(base_ptr + C::stat_off(gp));
  float* mw = stat;                          // [row warp][gp]
  float* lw = mw + kRowWarps * gp;           // [row warp][gp]
  float* m_cta = lw + kRowWarps * gp;        // [gp], log2 units
  float* l_cta = m_cta + gp;                 // [gp]
  float* wts = l_cta + gp;                   // [gp][8] rank weights
  float* linv = wts + 8 * gp;                // [gp] 1 / l of the cluster
  float* acc = reinterpret_cast<float*>(base_ptr + C::acc_off(gp));
  const uint32_t full = base + C::bar_off(gp);  // + 8 * stage
  const uint32_t empty = full + 8 * NS;         // + 8 * stage

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y / a.kv_heads;
  const int h = blockIdx.y % a.kv_heads;
  const int g0 = blockIdx.z * C::kHeads;  // first query head of the CTA
  const int ng_count = gp / 8;
  const int consumers = kRowWarps * ng_count;  // warps
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // This CTA's rows.
  const int len = lengths[b];
  const int span =
      ((len + a.nsplit - 1) / a.nsplit + kTile - 1) / kTile * kTile;
  const int row0 = rank * span;
  const int row_end = min(len, row0 + span);
  const int ntiles = row0 < row_end ? (row_end - row0 + kTile - 1) / kTile : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == consumers) {
    // ---- producer warp: one thread issues every TMA load ----
    if (lane == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % NS;
        if (t >= NS) mbar_wait(empty + 8 * st, ((t / NS) - 1) & 1);
        const int r = row0 + t * kTile;
        const uint32_t kdst = base + st * C::kStageBytes;
        const uint32_t vdst = kdst + C::kTileBytes;
        mbar_expect_tx(full + 8 * st, C::kStageBytes);
#pragma unroll
        for (int at = 0; at < C::kAtoms; ++at) {
          tma_load_4d(kdst + at * C::kAtomBytes, &kmap, full + 8 * st,
                      at * 64, h, r, b);
          tma_load_4d(vdst + at * C::kAtomBytes, &vmap, full + 8 * st,
                      at * 64, h, r, b);
        }
      }
    }
  } else if (ntiles == 0) {
    if (threadIdx.x < gp) {
      m_cta[threadIdx.x] = kNegInf;
      l_cta[threadIdx.x] = 0.f;  // acc is left as it is: its weight is 0
    }
  } else {
    // ---- consumer warps: rows 16*rw.. of each tile, heads 8*ng.. ----
    const int nthr = 32 * consumers;
    // Stage the CTA's query heads (zero past the group) while the first
    // tiles load: 16-byte loads where q's base and strides allow.
    constexpr int V = 16 / sizeof(T);
    const bool vec = (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                     a.q_sb % V == 0 && a.q_sh % V == 0;
    for (int idx = threadIdx.x; idx < gp * HD / V; idx += nthr) {
      const int g = idx / (HD / V);
      const int d = (idx % (HD / V)) * V;
      const int gq = g0 + g;
      const T* src = q + b * a.q_sb +
                     static_cast<int64_t>(h * a.group + gq) * a.q_sh + d;
      T* dst = qs + g * C::kQPitch + d;
      if (gq >= a.group) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) dst[e] = src[e];
      }
    }
    consumers_sync(nthr);
    const int rw = warp % kRowWarps;
    const int ng = warp / kRowWarps;
    const int quad = lane % 4;
    const int grp = lane / 4;
    const float sl2 = a.scale_log2;
    float o[kMT][4];  // O^T: column 16*mt + grp (+8), head 2*quad (+1)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this lane's share of the row sums
    const T* qw = qs + (ng * 8) * C::kQPitch;
    uint8_t* pw_raw = base_ptr + C::p_off(gp) + warp * 8 * kPPitch * 4;

    for (int t = 0; t < ntiles; ++t) {
      const int st = t % NS;
      mbar_wait(full + 8 * st, (t / NS) & 1);
      const int rem = row_end - (row0 + t * kTile + 16 * rw);  // valid rows
      if (rem > 0) {
        const uint32_t ks = base + st * C::kStageBytes;
        const uint32_t vs = ks + C::kTileBytes;
        // scores of keys 16*rw + grp (+8) against heads 8*ng + 2*quad (+1)
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (C::kBf16) {
          const __nv_bfloat16* qb =
              reinterpret_cast<const __nv_bfloat16*>(qw) + grp * C::kQPitch +
              2 * quad;
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t af[4];
            ldmatrix_x4(ks + tile_off<T, HD>(16 * rw + (lane % 8) +
                                                 8 * ((lane / 8) % 2),
                                             2 * kk + lane / 16),
                        af);
            const uint32_t b0 =
                *reinterpret_cast<const uint32_t*>(qb + 16 * kk);
            const uint32_t b1 =
                *reinterpret_cast<const uint32_t*>(qb + 16 * kk + 8);
            mma_bf16(s, af, b0, b1);
          }
        } else {
          const float* kt = reinterpret_cast<const float*>(
              base_ptr + st * C::kStageBytes);
#pragma unroll 4
          for (int d = 0; d < HD; d += 4) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float4 kk = *reinterpret_cast<const float4*>(
                  kt + (16 * rw + grp + 8 * i) * HD + d);
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const float4 qq = *reinterpret_cast<const float4*>(
                    reinterpret_cast<const float*>(qw) +
                    (2 * quad + j) * C::kQPitch + d);
                float& x = s[2 * i + j];
                x = fmaf(kk.x, qq.x, x);
                x = fmaf(kk.y, qq.y, x);
                x = fmaf(kk.z, qq.z, x);
                x = fmaf(kk.w, qq.w, x);
              }
            }
          }
        }
        // Online softmax; element 2i+j: key grp + 8i, head 2*quad + j.
        const bool ok0 = grp < rem, ok1 = grp + 8 < rem;
        float p[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s0 = ok0 ? s[j] * sl2 : kNegInf;
          const float s1 = ok1 ? s[2 + j] * sl2 : kNegInf;
          float mx = fmaxf(s0, s1);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float m_new = fmaxf(m[j], mx);
          const float mu = m_new > 0.5f * kNegInf ? m_new : 0.f;
          const float alpha = exp2f(m[j] - mu);
          p[j] = ok0 ? exp2f(s0 - mu) : 0.f;
          p[2 + j] = ok1 ? exp2f(s1 - mu) : 0.f;
          l[j] = l[j] * alpha + p[j] + p[2 + j];
          m[j] = m_new;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            o[mt][j] *= alpha;
            o[mt][2 + j] *= alpha;
          }
        }
        __syncwarp();  // the previous tile's P reads are done
        if constexpr (C::kBf16) {
          __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(pw_raw);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              pb[(2 * quad + j) * kPPitch + grp + 8 * i] =
                  __float2bfloat16(p[2 * i + j]);
          __syncwarp();
          // P^T as the B fragment: keys 2*quad (+1, +8, +9), head grp
          const uint32_t b0 =
              *reinterpret_cast<const uint32_t*>(pb + grp * kPPitch + 2 * quad);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
              pb + grp * kPPitch + 2 * quad + 8);
          // V^T's A fragment holds keys 2*quad (+1) and 2*quad + 8 (+9):
          // rows past the end select to 0 (they may hold NaN)
          const uint32_t lo = (2 * quad < rem ? 0x0000ffffu : 0u) |
                              (2 * quad + 1 < rem ? 0xffff0000u : 0u);
          const uint32_t hi = (2 * quad + 8 < rem ? 0x0000ffffu : 0u) |
                              (2 * quad + 9 < rem ? 0xffff0000u : 0u);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            uint32_t af[4];
            ldmatrix_x4_trans(
                vs + tile_off<T, HD>(16 * rw + (lane % 8) + 8 * (lane / 16),
                                     2 * mt + (lane / 8) % 2),
                af);
            if (rem < 16) {
              af[0] &= lo;
              af[1] &= lo;
              af[2] &= hi;
              af[3] &= hi;
            }
            mma_bf16(o[mt], af, b0, b1);
          }
        } else {
          float* pf = reinterpret_cast<float*>(pw_raw);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              pf[(2 * quad + j) * kPPitch + grp + 8 * i] = p[2 * i + j];
          __syncwarp();
          const float* vt = reinterpret_cast<const float*>(
              base_ptr + st * C::kStageBytes + C::kTileBytes);
          const int nk = min(rem, 16);
          for (int kr = 0; kr < nk; ++kr) {  // rows past the end: skipped
            const float* vrow = vt + (16 * rw + kr) * HD;
            const float p0 = pf[(2 * quad) * kPPitch + kr];
            const float p1 = pf[(2 * quad + 1) * kPPitch + kr];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              const float v0 = vrow[16 * mt + grp];
              const float v1 = vrow[16 * mt + grp + 8];
              o[mt][0] = fmaf(v0, p0, o[mt][0]);
              o[mt][1] = fmaf(v0, p1, o[mt][1]);
              o[mt][2] = fmaf(v1, p0, o[mt][2]);
              o[mt][3] = fmaf(v1, p1, o[mt][3]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    // Merge the row warps of each head group, in order, into the CTA's
    // (m, l, acc).
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 4);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 8);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 16);
      if (grp == 0) {
        mw[rw * gp + ng * 8 + 2 * quad + j] = m[j];
        lw[rw * gp + ng * 8 + 2 * quad + j] = l[j];
      }
    }
    consumers_sync(nthr);
    float sc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int g = ng * 8 + 2 * quad + j;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w) mx = fmaxf(mx, mw[w * gp + g]);
      sc[j] = m[j] > 0.5f * kNegInf ? exp2f(m[j] - mx) : 0.f;
      if (rw == 0 && grp == 0) {
        float lsum = 0.f;
#pragma unroll
        for (int w = 0; w < kRowWarps; ++w) {
          const float mv = mw[w * gp + g];
          lsum += (mv > 0.5f * kNegInf ? exp2f(mv - mx) : 0.f) * lw[w * gp + g];
        }
        m_cta[g] = mx;
        l_cta[g] = lsum;
      }
    }
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) {
      if (rw == w) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int g = ng * 8 + 2 * quad + (e % 2);
            const int d = 16 * mt + grp + 8 * (e / 2);
            float* x = acc + g * C::kAccPitch + d;
            const float y = sc[e % 2] * o[mt][e];
            *x = w == 0 ? y : *x + y;
          }
      }
      consumers_sync(nthr);
    }
  }

  // Merge the cluster's CTAs: rank r writes column quads [c0, c1) of
  // every head, summing the ranks in order.
  cluster.sync();
  const int heads = min(C::kHeads, a.group - g0);
  if (threadIdx.x < heads) {
    const int g = threadIdx.x;
    float mj[8];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mj[j] = j < a.nsplit ? cluster.map_shared_rank(m_cta, j)[g] : kNegInf;
      mx = fmaxf(mx, mj[j]);
    }
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float w = mj[j] > 0.5f * kNegInf ? exp2f(mj[j] - mx) : 0.f;
      if (w > 0.f) lsum = fmaf(w, cluster.map_shared_rank(l_cta, j)[g], lsum);
      wts[g * 8 + j] = w;
    }
    linv[g] = 1.f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  const int c0 = rank * (HD / 4) / a.nsplit;
  const int nq = (rank + 1) * (HD / 4) / a.nsplit - c0;
  for (int idx = threadIdx.x; idx < heads * nq; idx += blockDim.x) {
    const int g = idx / nq;
    const int d = 4 * (c0 + idx % nq);
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float w = j < a.nsplit ? wts[g * 8 + j] : 0.f;
      if (w > 0.f) {  // a rank with no rows may hold anything in acc
        const float4 x = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(acc, j) + g * C::kAccPitch + d);
        y.x = fmaf(w, x.x, y.x);
        y.y = fmaf(w, x.y, y.y);
        y.z = fmaf(w, x.z, y.z);
        y.w = fmaf(w, x.w, y.w);
      }
    }
    const float r = linv[g];
    T* dst = out + (static_cast<int64_t>(b) * a.kv_heads * a.group +
                    static_cast<int64_t>(h) * a.group + g0 + g) * HD + d;
    if constexpr (C::kBf16) {
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(dst);
      o2[0] = __floats2bfloat162_rn(y.x * r, y.y * r);
      o2[1] = __floats2bfloat162_rn(y.z * r, y.w * r);
    } else {
      *reinterpret_cast<float4*>(dst) =
          make_float4(y.x * r, y.y * r, y.z * r, y.w * r);
    }
  }
  cluster.sync();  // peers may still read this CTA's shared memory
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

// A tensor map over a (B, S, Hkv, hd) cache as (hd, Hkv, S, B) with
// element strides (1, sh, ss, sb) and a box of one atom's columns, one
// head and kTile rows; rows past S read as zero. Returns 0 or
// kCuResultBase + CUresult.
template <typename T, int HD>
int encode_cache(CUtensorMap* map, const void* ptr, const DecodeArgs& a,
                 int64_t sh, int64_t ss, int64_t sb) {
  using C = Cfg<T, HD>;
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return kCuResultBase + CUDA_ERROR_NOT_FOUND;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                        static_cast<cuuint64_t>(a.kv_heads),
                        static_cast<cuuint64_t>(a.seq),
                        static_cast<cuuint64_t>(a.batch)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * sizeof(T),
                           static_cast<cuuint64_t>(ss) * sizeof(T),
                           static_cast<cuuint64_t>(sb) * sizeof(T)};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(C::kRowBytes / sizeof(T)), 1,
                       static_cast<cuuint32_t>(kTile), 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      !C::kBf16 ? CU_TENSOR_MAP_SWIZZLE_NONE
                : (C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : CU_TENSOR_MAP_SWIZZLE_64B);
  const CUresult r = fn(
      map, C::kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(ptr), dims, strides, box, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kCuResultBase + static_cast<int>(r);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v,
           const int32_t* lengths, void* out, DecodeArgs a,
           const int64_t* kst, const int64_t* vst, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  if (a.nsplit < 1 || a.nsplit > 8 || a.group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gz = (a.group + C::kHeads - 1) / C::kHeads;
  a.heads_cta = (min(a.group, C::kHeads) + 7) / 8 * 8;
  CUtensorMap km, vm;
  int rc = encode_cache<T, HD>(&km, k, a, kst[2], kst[1], kst[0]);
  if (rc == 0) rc = encode_cache<T, HD>(&vm, v, a, vst[2], vst[1], vst[0]);
  if (rc != 0) return rc;
  const size_t smem = C::bytes(a.heads_cta);
  auto kernel = decode_attn_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.nsplit),
                     static_cast<unsigned>(a.batch * a.kv_heads),
                     static_cast<unsigned>(gz));
  cfg.blockDim = dim3(32 * (kRowWarps * a.heads_cta / 8 + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.nsplit);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, km, vm, static_cast<const T*>(q),
                           lengths, static_cast<T*>(out), a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int head_dim, const void* q, const void* k, const void* v,
                const int32_t* lengths, void* out, const DecodeArgs& a,
                const int64_t* kst, const int64_t* vst, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, lengths, out, a, kst, vst, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, out, a, kst, vst, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, out, a, kst, vst, stream);
    case 256: return launch<T, 256>(q, k, v, lengths, out, a, kst, vst, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dims: batch, seq, kv_heads, group, q strides (b, h), k strides
// (b, s, h), v strides (b, s, h), nsplit -- 13 int64 (element strides).
// out is a contiguous (B, Hkv * group, hd) array of q's type.
extern "C" int decode_attention_fwd(int dtype, int head_dim, const void* q,
                                    const void* k, const void* v,
                                    const int32_t* lengths, void* out,
                                    const int64_t* dims, float scale,
                                    void* stream) {
  DecodeArgs a;
  a.batch = static_cast<int>(dims[0]);
  a.seq = static_cast<int>(dims[1]);
  a.kv_heads = static_cast<int>(dims[2]);
  a.group = static_cast<int>(dims[3]);
  a.q_sb = dims[4];
  a.q_sh = dims[5];
  a.nsplit = static_cast<int>(dims[12]);
  a.heads_cta = 0;
  a.scale_log2 = scale * 1.4426950408889634f;
  const int64_t* kst = dims + 6;
  const int64_t* vst = dims + 9;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(head_dim, q, k, v, lengths, out, a, kst, vst, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(head_dim, q, k, v, lengths, out, a, kst,
                                      vst, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
