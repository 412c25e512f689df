// Mamba-2 SSD chunked scan for Hopper (sm_90a), hand-written.
//
// Replaces the Pallas TPU kernel `ssd_scan` in
// src/repro/kernels/ssd_scan/kernel.py (`_ssd_kernel`). For one
// (batch, head) and one chunk of Q rows, with a = dt*A and acs =
// cumsum(a) over the chunk, all in fp32:
//   y      = (C.B^T (.) exp(mask(acs_q - acs_k))) @ (dt*x)
//          + (C @ state^T) * exp(acs_q)
//   state <- state * exp(acs_end) + ((dt*x) * exp(acs_end - acs_k))^T @ B
// The causal mask (k <= q) is applied before exp: masked entries are
// exactly 0. The (P, N) state starts at 0 and is carried across chunks.
//
// Layout. x (b, s, h, p), dt (b, s, h) fp32, A (h,) fp32, one group of
// B/C (b, s, n) shared by all heads, y (b, s, h, p); every tensor is read
// through element strides with its last axis contiguous, so the model's
// x, B and C, slices of one conv output, are never copied. x, B, C and y
// share one type (fp32 or bf16); everything is computed in fp32.
// Padding. The op pads a sequence to a multiple of the chunk with dt = 0
// and x = B = C = 0 (the reference's rule); here rows past s are read as
// exactly that and never fetched, and y rows past s are not written.
// Padded rows add nothing and keep acs flat, so the result is the padded
// scan's.
//
// Bound. Per (batch, head) and chunk of Q rows: the causal half of
// C.B^T (Q*Q*N/2 multiply-adds) and of the product with dt*x
// (Q*Q*P/2), plus C @ state^T and the state update (Q*P*N each). At the
// mamba2-370m prefill (b=4, s=2048, h=32, p=64, n=128, Q=256) that is
// about 21.5 GFLOP against about 72 MB of inputs and output: 0.022 ms
// both ways at the card's bf16 tensor-core peak and HBM rate, but 0.32 ms
// at its 67 TFLOP/s fp32 rate on the CUDA cores, which this version
// uses. So it is bound by fp32 operations.
//
// Design. The TPU kernel walks the chunks as a sequential grid axis and
// keeps the state in VMEM scratch between grid steps. CTAs run in no
// order, so here one CTA of 256 threads takes one (batch, head) and walks
// its chunks in a loop, with the (P, N) state in shared memory (32 KB at
// P=64, N=128). A chunk of up to 256 rows does not fit whole (its
// 256x256 decay matrix and two 256x128 fp32 B/C tiles are over the 227 KB
// a block may use), so it is cut into tiles of 64 rows: for each query
// tile, C is staged transposed (n-major) and C @ state^T taken; then for
// each key tile at or before it, B (transposed) and dt*x are staged, the
// 64x64 C.B^T tile is formed with 4x4 register tiles, decayed and masked
// in registers, staged again (k-major), and multiplied into the query
// tile's 64xP output, which stays in registers across key tiles. After
// the last query tile, one more pass over the key tiles stages B
// row-major and (dt*x)*exp(acs_end - acs) and updates the state, each
// thread holding a 4x8 block of it. The cumsum is one warp's scan. Chunks
// of any length up to 256 work: the last tile's rows past the chunk are
// zero, with dt = 0. Loads from global memory are 16 bytes wide where the
// strides allow it, several in flight per thread. fp32 FMAs on the CUDA
// cores; the tensor cores, sharing C.B^T across heads and a
// chunk-parallel split are later work (ROADMAP queue 2 #4).
//
// Interface. A plain C entry point, loaded with ctypes. It launches on
// the stream it is given, allocates nothing, and returns the CUDA error
// code (0 on success). dtype 0 = fp32, 1 = bf16. p must be a multiple of
// 4 up to 64, n a multiple of 8 up to 128, the chunk 1..256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows of a query or key tile
constexpr int kTS = kTile + 4;     // row stride of the transposed tiles
constexpr int kMaxChunk = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLoadFloats = 32;    // floats of global loads in flight

struct ScanArgs {
  int64_t batch, seq, heads, hp, ns, chunk;
  int64_t x_sb, x_ss, x_sh;     // element strides of x (b, s, h, p)
  int64_t dt_sb, dt_ss, dt_sh;  // dt (b, s, h)
  int64_t b_sb, b_ss;           // B (b, s, n)
  int64_t c_sb, c_ss;           // C (b, s, n)
  int64_t y_sb, y_ss, y_sh;     // y (b, s, h, p)
};

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

// E consecutive elements as fp32: E == 1, or one 16-byte load (4 fp32,
// 8 bf16) from a 16-byte aligned address.
template <int E>
__device__ __forceinline__ void load_elems(const float* p, float* o) {
  if constexpr (E == 1) {
    o[0] = p[0];
  } else {
    static_assert(E == 4, "16 bytes of fp32");
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  }
}

template <int E>
__device__ __forceinline__ void load_elems(const __nv_bfloat16* p, float* o) {
  if constexpr (E == 1) {
    o[0] = __bfloat162float(p[0]);
  } else {
    static_assert(E == 8, "16 bytes of bf16");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}

// Row and first column of load unit `idx` of a tile. TRANS: rows
// fastest, so that a warp's stores to the column-major tile hit distinct
// banks; else columns fastest, coalesced on both sides.
template <bool TRANS, int E>
__device__ __forceinline__ void tile_pos(int idx, int per_row, int* r,
                                         int* c) {
  if constexpr (TRANS) {
    *r = idx % kTile;
    *c = (idx / kTile) * E;
  } else {
    *r = idx / per_row;
    *c = (idx - *r * per_row) * E;
  }
}

// Rows [0, kTile) of a (rows, width) matrix with row stride rs into
// shared memory, zero past `valid` rows. TRANS: dst[c * kTS + r] (column
// major, for reads of 4 consecutive rows); else dst[r * width + c], each
// row scaled by MODE: 0 none, 1 dt[r], 2 dt[r] * exp(acs_end - acs[r]).
template <typename T, int E, bool TRANS, int MODE>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t rs, int width, int valid,
                                          float* __restrict__ dst,
                                          const float* __restrict__ dts,
                                          const float* __restrict__ acs,
                                          float acs_end) {
  constexpr int kBatch = kLoadFloats / E;
  const int per_row = width / E;
  const int total = kTile * per_row;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    float v[kBatch][E];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      int r, c;
      tile_pos<TRANS, E>(idx, per_row, &r, &c);
      if (idx < total && r < valid) {
        load_elems<E>(src + r * rs + c, v[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx >= total) break;
      int r, c;
      tile_pos<TRANS, E>(idx, per_row, &r, &c);
      float scale = 1.f;
      if constexpr (MODE >= 1) scale = dts[r];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float val = v[u][e];
        if constexpr (MODE >= 1) val = __fmul_rn(val, scale);  // dt * x
        if constexpr (MODE == 2) val = __fmul_rn(val, expf(acs_end - acs[r]));
        if constexpr (TRANS) {
          dst[(c + e) * kTS + r] = val;
        } else {
          dst[r * width + c + e] = val;
        }
      }
    }
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, ScanArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int P = static_cast<int>(a.hp);
  const int N = static_cast<int>(a.ns);
  const int Q = static_cast<int>(a.chunk);
  float* acs = smem;                  // [kMaxChunk] cumsum of dt*A
  float* dts = acs + kMaxChunk;       // [kMaxChunk] dt of the chunk
  float* st = dts + kMaxChunk;        // [N][P] the carried state
  float* ct = st + N * P;             // [N][kTS] C^T; B rows [kTile][N]
                                      // in the state pass
  float* bt = ct + N * kTS;           // [N][kTS] B^T of a key tile
  float* dx = bt + N * kTS;           // [kTile][P] dt*x of a key tile
  float* sp = dx + kTile * P;         // [kTile][kTS] decayed scores, k-major

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int64_t b = blockIdx.x / a.heads;
  const int64_t h = blockIdx.x % a.heads;
  const float Ah = A[h];
  const T* xb = x + b * a.x_sb + h * a.x_sh;
  const float* dtb = dt + b * a.dt_sb + h * a.dt_sh;
  const T* Bb = Bm + b * a.b_sb;
  const T* Cb = Cm + b * a.c_sb;
  T* yb = y + b * a.y_sb + h * a.y_sh;

  // Scores tile: rows ty*4.., keys tx*4..; output tile: rows ty*4..,
  // columns tx*4..; state pass: p = tx*4.., n = ty*8...
  const int ty = tid / 16;
  const int tx = tid % 16;
  const bool y_on = tx * 4 < P;
  const bool st_on = y_on && ty * 8 < N;

  for (int i = tid; i < N * P; i += kThreads) st[i] = 0.f;

  const int64_t nchunks = (a.seq + Q - 1) / Q;
  for (int64_t ci = 0; ci < nchunks; ++ci) {
    const int64_t c0 = ci * Q;
    const int L = static_cast<int>(min(static_cast<int64_t>(Q), a.seq - c0));
    const int ntiles = (L + kTile - 1) / kTile;
    const int Lt = ntiles * kTile;

    __syncthreads();  // the last chunk's readers of dts/acs are done
    for (int i = tid; i < Lt; i += kThreads)
      dts[i] = i < L ? dtb[(c0 + i) * a.dt_ss] : 0.f;
    __syncthreads();
    if (tid < 32) {
      // inclusive scan of a = dt*A, 8 consecutive rows per lane
      float v[8];
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = lane * 8 + j;
        run = __fadd_rn(run, i < Lt ? __fmul_rn(dts[i], Ah) : 0.f);
        v[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl = __fadd_rn(incl, t);
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = lane * 8 + j;
        if (i < Lt) acs[i] = __fadd_rn(excl, v[j]);
      }
    }
    __syncthreads();
    const float acs_end = acs[L - 1];

    for (int qi = 0; qi < ntiles; ++qi) {
      const int q0 = qi * kTile;
      load_tile<T, E, true, 0>(Cb + (c0 + q0) * a.c_ss, a.c_ss, N, L - q0,
                               ct, nullptr, nullptr, 0.f);
      float acc[4][4], inter[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = inter[i][j] = 0.f;

      for (int kj = 0; kj <= qi; ++kj) {
        const int k0 = kj * kTile;
        load_tile<T, E, true, 0>(Bb + (c0 + k0) * a.b_ss, a.b_ss, N, L - k0,
                                 bt, nullptr, nullptr, 0.f);
        load_tile<T, E, false, 1>(xb + (c0 + k0) * a.x_ss, a.x_ss, P,
                                  L - k0, dx, dts + k0, nullptr, 0.f);
        __syncthreads();

        if (kj == 0 && y_on) {
          // the carried state's term: C @ state^T
#pragma unroll 4
          for (int n = 0; n < N; ++n) {
            const float4 c4 = *reinterpret_cast<const float4*>(
                &ct[n * kTS + ty * 4]);
            const float4 s4 = *reinterpret_cast<const float4*>(
                &st[n * P + tx * 4]);
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                inter[i][j] = fmaf(cv[i], sv[j], inter[i][j]);
          }
        }

        // scores C.B^T for rows q0+ty*4.., keys k0+tx*4..
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 c4 =
              *reinterpret_cast<const float4*>(&ct[n * kTS + ty * 4]);
          const float4 b4 =
              *reinterpret_cast<const float4*>(&bt[n * kTS + tx * 4]);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
        // decay, masked before exp: entries with k > q are exactly 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + tx * 4 + j;
          float o[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = q0 + ty * 4 + i;
            o[i] = k <= q ? __fmul_rn(s[i][j], expf(acs[q] - acs[k])) : 0.f;
          }
          *reinterpret_cast<float4*>(&sp[(tx * 4 + j) * kTS + ty * 4]) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
        __syncthreads();

        if (y_on) {
          // on the diagonal tile, keys past the thread's last row are 0
          const int kend = kj == qi ? ty * 4 + 4 : kTile;
#pragma unroll 4
          for (int k = 0; k < kend; ++k) {
            const float4 s4 =
                *reinterpret_cast<const float4*>(&sp[k * kTS + ty * 4]);
            const float4 d4 =
                *reinterpret_cast<const float4*>(&dx[k * P + tx * 4]);
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
            const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(sv[i], dv[j], acc[i][j]);
          }
        }
        __syncthreads();
      }

      if (y_on) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty * 4 + i;
          if (q < L) {
            const float e = expf(acs[q]);
            T* yr = yb + (c0 + q) * a.y_ss + tx * 4;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              yr[j] = from_f32<T>(__fadd_rn(acc[i][j],
                                            __fmul_rn(inter[i][j], e)));
          }
        }
      }
    }

    if (ci + 1 == nchunks) break;  // the last state is not returned

    // state <- state * exp(acs_end) + ((dt*x) * exp(acs_end - acs))^T @ B
    float inj[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) inj[i][j] = 0.f;
    float* br = ct;  // [kTile][N]
    for (int kj = 0; kj < ntiles; ++kj) {
      const int k0 = kj * kTile;
      load_tile<T, E, false, 0>(Bb + (c0 + k0) * a.b_ss, a.b_ss, N, L - k0,
                                br, nullptr, nullptr, 0.f);
      load_tile<T, E, false, 2>(xb + (c0 + k0) * a.x_ss, a.x_ss, P, L - k0,
                                dx, dts + k0, acs + k0, acs_end);
      __syncthreads();
      if (st_on) {
#pragma unroll 4
        for (int k = 0; k < kTile; ++k) {
          const float4 d4 =
              *reinterpret_cast<const float4*>(&dx[k * P + tx * 4]);
          const float4 b0 =
              *reinterpret_cast<const float4*>(&br[k * N + ty * 8]);
          const float4 b1 =
              *reinterpret_cast<const float4*>(&br[k * N + ty * 8 + 4]);
          const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              inj[i][j] = fmaf(dv[i], bv[j], inj[i][j]);
        }
      }
      __syncthreads();
    }
    if (st_on) {
      const float decay = expf(acs_end);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float4* row = reinterpret_cast<float4*>(&st[(ty * 8 + j) * P + tx * 4]);
        float4 v = *row;
        v.x = __fadd_rn(__fmul_rn(v.x, decay), inj[0][j]);
        v.y = __fadd_rn(__fmul_rn(v.y, decay), inj[1][j]);
        v.z = __fadd_rn(__fmul_rn(v.z, decay), inj[2][j]);
        v.w = __fadd_rn(__fmul_rn(v.w, decay), inj[3][j]);
        *row = v;
      }
    }
  }
}

size_t smem_bytes(int P, int N) {
  return sizeof(float) *
         (2 * kMaxChunk + static_cast<size_t>(N) * P + 2 * N * kTS +
          kTile * P + kTile * kTS);
}

template <typename T, int E>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, void* y, const ScanArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(static_cast<int>(a.hp),
                                 static_cast<int>(a.ns));
  auto kernel = ssd_scan_kernel<T, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(a.batch * a.heads), kThreads, smem,
           stream>>>(static_cast<const T*>(x), dt, A,
                     static_cast<const T*>(B), static_cast<const T*>(C),
                     static_cast<T*>(y), a);
  return static_cast<int>(cudaGetLastError());
}

// Whether x, B and C can be read 16 bytes at a time: aligned base
// addresses, and strides and widths in whole 16-byte units.
template <typename T>
bool wide_loads(const void* x, const void* B, const void* C,
                const ScanArgs& a) {
  constexpr int64_t e = 16 / sizeof(T);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return aligned(x) && aligned(B) && aligned(C) && a.hp % e == 0 &&
         a.ns % e == 0 && a.x_sb % e == 0 && a.x_ss % e == 0 &&
         a.x_sh % e == 0 && a.b_sb % e == 0 && a.b_ss % e == 0 &&
         a.c_sb % e == 0 && a.c_ss % e == 0;
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* B,
             const void* C, void* y, const ScanArgs& a, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (wide_loads<T>(x, B, C, a))
    return launch<T, kWide>(x, dt, A, B, C, y, a, stream);
  return launch<T, 1>(x, dt, A, B, C, y, a, stream);
}

}  // namespace

// dims: batch, seq, heads, head_dim, state, chunk, x strides (b, s, h),
// dt strides (b, s, h), B strides (b, s), C strides (b, s), y strides
// (b, s, h) -- 19 int64, element strides.
extern "C" int ssd_scan_fwd(int dtype, const void* x, const void* dt,
                            const void* A, const void* B, const void* C,
                            void* y, const int64_t* dims, void* stream) {
  ScanArgs a;
  a.batch = dims[0];
  a.seq = dims[1];
  a.heads = dims[2];
  a.hp = dims[3];
  a.ns = dims[4];
  a.chunk = dims[5];
  a.x_sb = dims[6];
  a.x_ss = dims[7];
  a.x_sh = dims[8];
  a.dt_sb = dims[9];
  a.dt_ss = dims[10];
  a.dt_sh = dims[11];
  a.b_sb = dims[12];
  a.b_ss = dims[13];
  a.c_sb = dims[14];
  a.c_ss = dims[15];
  a.y_sb = dims[16];
  a.y_ss = dims[17];
  a.y_sh = dims[18];
  if (a.hp <= 0 || a.hp % 4 || a.hp > kMaxP || a.ns <= 0 || a.ns % 8 ||
      a.ns > kMaxN || a.chunk <= 0 || a.chunk > kMaxChunk ||
      a.batch * a.heads > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.batch * a.heads == 0 || a.seq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  if (dtype == 0) return dispatch<float>(x, dtp, Ap, B, C, y, a, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dtp, Ap, B, C, y, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
