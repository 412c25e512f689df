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
// both ways at the card's bf16 tensor-core peak and HBM rate, and 0.32 ms
// at its 67 TFLOP/s fp32 rate on the CUDA cores. So on the tensor cores it
// is bound by bytes, and on the CUDA cores (the fp32 route) by
// operations.
//
// Design. The TPU kernel walks the chunks as a sequential grid axis and
// keeps the state in VMEM scratch between grid steps. Here a bf16 call is
// three launches of Mamba-2's own chunk-parallel decomposition (Dao & Gu,
// arXiv:2405.21060, sections 6-7; a one-chunk sequence takes (c) alone),
// with every product on the bf16 tensor cores (mma.sync m16n8k16, fp32
// accumulators, ldmatrix from 128-byte swizzled tiles of 64 rows by 64
// columns), CTAs of 8 warps at most 128 registers, two an SM:
//   (a) chunk state, one CTA per (batch, chunk, heads) for every chunk
//       but the last, two heads sharing the B tiles at n <= 64: acs from
//       dt, then the chunk's own end state from zero, inj = (x * w)^T @ B
//       with w = dt * exp(acs_end - acs), fp32, and exp(acs_end);
//   (b) state passing, one thread per 8 state elements of a (batch,
//       head): state <- state * exp(acs_end) + inj chunk after chunk in
//       fp32, each state entering a chunk stored as bf16 hi and lo tiles;
//   (c) chunk scan, one CTA per (query tile of 64 rows, chunk, batch,
//       pair of heads), a warp per (16 rows, head): C @ state_in^T scaled
//       by exp(acs_q), plus, for each key tile at or before the query
//       tile, S = C.B^T, formed once for both heads (the row block's two
//       warps each take half of the keys and trade halves through shared
//       memory on a named barrier), then each head's P = S * exp(acs_q -
//       acs_k) * dt_k masked (k <= q) in registers and P @ x.
// One operand of every product is a raw input (C.B^T: both). The other
// is formed in fp32 and split into a bf16 hi + lo pair, two products:
// x * w in (a), P and the state in (c). One rounding each would move a
// row of zamba2's output by up to 1.1e-2 of its norm, over the 1e-2 the
// op is held to, and elements where a row's terms cancel by up to 0.7,
// over the 2e-2 + 2e-2 |y| of the reference tests' tolerance; the pairs
// keep both (tests/test_torch_ssd_scan.py). The carried state stays
// fp32. The workspace, each chunk's inj and state (fp32 and bf16 hi +
// lo, 29 MB each at the prefill shapes) and the decays, costs about two
// inputs' worth of bytes and is read back mostly from L2; folding the
// passes into one launch is later work (ROADMAP queue 2 #4), as are
// wgmma's rates. Sums run in a fixed order and no atomics are used: two
// runs give the same bits.
//
// Loads (bf16). x, B and C are copied into shared memory as they are,
// through their strides. At the prefill's shapes (16-byte aligned slices,
// p = 64, n a multiple of 64) TMA fetches them, with (c)'s C tile and
// states on a barrier of their own, into a ring of two key tiles (B and
// the heads' x) with full and empty mbarriers: the next key tile is in
// flight while one is multiplied, and the dt scan overlaps the first
// fetches. (c)'s states are staged in the ring, so after the first chunk
// its first fetch waits for C @ state_in^T. Other aligned inputs take
// 16-byte cp.async copies, and rows
// off the 16-byte grid one element at a time, both a tile at a time.
// Rows past the chunk and columns past p or n read as zeros.
//
// fp32 inputs (the tests' cases) keep a CUDA-core kernel: one CTA of 256
// threads per (batch, head) walks its chunks in a loop, with the (P, N)
// state in shared memory (32 KB at P=64, N=128). A chunk of up to 256
// rows is cut into tiles of 64 rows: for each query tile, C is staged
// transposed (n-major) and C @ state^T taken; then for each key tile at
// or before it, B (transposed) and dt*x are staged, the 64x64 C.B^T tile
// is formed with 4x4 register tiles, decayed and masked in registers,
// staged again (k-major), and multiplied into the query tile's 64xP
// output, which stays in registers across key tiles. After the last
// query tile, one more pass over the key tiles stages B row-major and
// (dt*x)*exp(acs_end - acs) and updates the state, each thread holding a
// 4x8 block of it. The cumsum is one warp's scan (the bf16 route's too).
// Chunks of any length up to 256 work: the last tile's rows past the
// chunk are zero, with dt = 0. Loads from global memory are 16 bytes wide
// where the strides allow it, several in flight per thread.
//
// Interface. A plain C entry point, loaded with ctypes. It launches on
// the stream it is given, allocates nothing (the caller passes the bf16
// route's workspace), and returns 0 on success, else a CUDA error code or
// kCuResultBase + the CUresult of a failed tensor-map encode.
// dtype 0 = fp32, 1 = bf16. p must be a multiple of 4 up to 64, n a
// multiple of 8 up to 128, the chunk 1..256.

#include <cuda.h>
#include <cudaTypedefs.h>
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

// E consecutive elements: E == 1, or one 16-byte load of 4 from a
// 16-byte aligned address.
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


// ---------------------------------------------------------------------------
// bf16 route: passes (a), (b) and (c) on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// 8 warps a CTA: 4 blocks of 16 rows, each taken by two warps (pass (a):
// the halves of n, or at n <= 64 two heads; pass (c): two heads, which
// split each key tile's C.B^T), so that two CTAs, 16 warps, fit an SM's
// 65,536 registers.
constexpr int kBThreads = 256;
constexpr int kAtomBytes = kTile * 128;     // 64 rows of 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;
// How passes (a) and (c) fill their tiles, the E of their templates: TMA
// into a ring of kStages key tiles (x, B and C 16-byte aligned, p = 64, n
// a multiple of 64: the prefill); 16-byte cp.async copies (other aligned
// inputs); one element at a time (rows off the 16-byte grid).
constexpr int kTma = 0, kWide = 8, kElem = 1;
constexpr int kStages = 2;
constexpr int kCuResultBase = 10000;  // added to a failed encode's CUresult

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of row `row` (0..63), 16-byte chunk `ch` of a tile made of
// 64-column atoms: the atom, then the 128-byte swizzle inside it (chunk
// ^= row % 8, TMA's SWIZZLE_128B on a 1024-byte aligned atom), so that
// ldmatrix's eight rows of one matrix fall in distinct banks.
__device__ __forceinline__ uint32_t toff(int row, int ch) {
  return (ch >> 3) * kAtomBytes + row * 128 + (((ch & 7) ^ (row & 7)) << 4);
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Orders this thread's generic stores to shared memory before later TMA
// writes to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// 2^x in one MUFU instruction (relative error under 2^-22; results below
// 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (v0, v1) as a bf16 pair hi, rounded to nearest, and the pair lo of
// what hi leaves, rounded again: hi + lo carries 16 bits of each.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// A bf16 pair scaled by (w0, w1) in fp32, split into hi + lo.
__device__ __forceinline__ void scale_split(uint32_t u, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  split_bf16(f.x * w0, f.y * w1, hi, lo);
}

// ldmatrix lane addresses in tile t. a_addr: an m16k16 A operand at
// (m0, k0) of a tile stored [m][k]; b_addr: the two n8k16 B operands at
// n0 and n0 + 8 (k0..) of a tile stored [n][k]. The _t forms read tiles
// stored [k][m] and [k][n], through ldmatrix.trans.
__device__ __forceinline__ uint32_t a_addr(uint32_t t, int m0, int k0,
                                           int lane) {
  const int j = lane >> 3, r = lane & 7;
  return t + toff(m0 + (j & 1) * 8 + r, (k0 >> 3) + (j >> 1));
}
__device__ __forceinline__ uint32_t a_addr_t(uint32_t t, int m0, int k0,
                                             int lane) {
  const int j = lane >> 3, r = lane & 7;
  return t + toff(k0 + (j >> 1) * 8 + r, (m0 >> 3) + (j & 1));
}
__device__ __forceinline__ uint32_t b_addr(uint32_t t, int n0, int k0,
                                           int lane) {
  const int j = lane >> 3, r = lane & 7;
  return t + toff(n0 + (j >> 1) * 8 + r, (k0 >> 3) + (j & 1));
}
__device__ __forceinline__ uint32_t b_addr_t(uint32_t t, int n0, int k0,
                                             int lane) {
  const int j = lane >> 3, r = lane & 7;
  return t + toff(k0 + (j & 1) * 8 + r, (n0 >> 3) + (j >> 1));
}

// Rows [0, 64) of a (rows, width) bf16 matrix with row stride rs into a
// tile of `atoms` atoms; rows at or past `valid` and columns at or past
// `width` are zero and never read. E = kWide: 16-byte cp.async copies
// (aligned base, stride and width; `copies_done` waits for them); E =
// kElem: one element at a time.
template <int E>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src,
                                          int64_t rs, int width, int valid,
                                          int atoms, uint8_t* dst) {
  const int chunks = atoms * 8;  // 16-byte chunks of a row
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
  for (int i = threadIdx.x; i < kTile * chunks; i += blockDim.x) {
    const int r = i / chunks, ch = i - r * chunks, c0 = ch * 8;
    const bool ok = r < valid && c0 < width;
    if constexpr (E == kWide) {
      // a source size of 0 fills the 16 bytes with zeros and reads nothing
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(dst + toff(r, ch))),
                   "l"(ok ? s + r * rs + c0 : s), "r"(ok ? 16 : 0)
                   : "memory");
    } else {
      uint32_t e[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (ok) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (c0 + k < width) e[k] = s[r * rs + c0 + k];
      }
      *reinterpret_cast<uint4*>(dst + toff(r, ch)) =
          make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                     e[4] | (e[5] << 16), e[6] | (e[7] << 16));
    }
  }
}

template <int E>
__device__ __forceinline__ void copies_done() {
  if constexpr (E == kWide) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [from, 64) of a tile of `atoms` atoms to zero, with a proxy fence
// before a later TMA write: TMA fills rows past the tensor with zeros,
// but a chunk can end inside a tile before the tensor does.
__device__ __forceinline__ void zero_rows(uint8_t* t, int atoms, int from) {
  const int chunks = atoms * 8;
  for (int i = threadIdx.x; i < (kTile - from) * chunks; i += blockDim.x) {
    const int r = from + i / chunks, ch = i % chunks;
    *reinterpret_cast<uint4*>(t + toff(r, ch)) = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
}

// One warp: dt of rows [0, 256) of a chunk (0 at or past `valid`) and
// acs * log2(e), acs = cumsum(dt * A), summed in the fp32 route's order:
// 8 consecutive rows a lane, then a warp scan. A row's value depends on
// no later row, so every pass that scans a prefix of the chunk gets the
// same bits.
__device__ __forceinline__ void chunk_acs2(const float* __restrict__ dtp,
                                           int64_t dt_ss, int valid,
                                           float Ah, float* dts,
                                           float* acs2) {
  const int lane = threadIdx.x % 32;
  float v[8];
  float run = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = lane * 8 + j;
    const float d = i < valid ? dtp[i * dt_ss] : 0.f;
    dts[i] = d;
    run = __fadd_rn(run, __fmul_rn(d, Ah));
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
  for (int j = 0; j < 8; ++j)
    acs2[lane * 8 + j] = __fmul_rn(__fadd_rn(excl, v[j]), kLog2e);
}

__device__ __forceinline__ uint8_t* align1k(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// The key tiles of passes (a) and (c): B rows of a chunk and the x rows
// of nx heads, a stage of the ring each (B's atoms, then one atom per
// head, room for gx). With TMA one thread fetches a tile, the stage's
// `full` barrier counts its bytes, and each warp arrives on its `empty`
// barrier once it is done with the stage; else every thread copies the
// tile when its turn comes.
template <int E>
struct KeyRing {
  static constexpr int kNS = E == kTma ? kStages : 1;
  uint32_t ring;      // shared address of stage 0
  int na;             // atoms of a B tile
  int gx, nx;         // x atoms a stage holds, heads fetched
  uint32_t full;      // kNS full barriers, then kNS empty ones
  const bf16* Bb;     // B and x rows of the chunk (x of the first head)
  const bf16* xb;
  const ScanArgs* a;
  int b, h, c0;       // TMA coordinates of the first head
  int L;              // rows of the chunk

  __device__ int stage_bytes() const { return (na + gx) * kAtomBytes; }
  __device__ uint32_t Bs(int t) const {
    return ring + (t % kNS) * stage_bytes();
  }
  __device__ uint32_t Xs(int t, int g) const {
    return Bs(t) + (na + g) * kAtomBytes;
  }
  __device__ static uint8_t* ptr(uint32_t s) {
    return static_cast<uint8_t*>(__cvta_shared_to_generic(s));
  }

  // TMA: one thread, before the tile is waited for
  __device__ void fetch(int t, const CUtensorMap* xmap,
                        const CUtensorMap* bmap) const {
    const uint32_t bar = full + 8 * (t % kNS);
    const int row = c0 + t * kTile;
    mbar_expect_tx(bar, (na + nx) * kAtomBytes);
    for (int at = 0; at < na; ++at)
      tma_load_3d(Bs(t) + at * kAtomBytes, bmap, bar, at * 64, row, b);
    for (int g = 0; g < nx; ++g)
      tma_load_4d(Xs(t, g), xmap, bar, 0, h + g, row, b);
  }

  // Every thread: tile t is in shared memory once this returns.
  __device__ void wait(int t) const {
    const int k0 = t * kTile;
    if constexpr (E == kTma) {
      mbar_wait(full + 8 * (t % kNS), (t / kNS) & 1);
      if (L - k0 < kTile) {  // the chunk ends inside the tile
        zero_rows(ptr(Bs(t)), na, L - k0);
        for (int g = 0; g < nx; ++g) zero_rows(ptr(Xs(t, g)), 1, L - k0);
        __syncthreads();
      }
    } else {
      __syncthreads();  // the last tile's readers are done
      load_rows<E>(Bb + k0 * a->b_ss, a->b_ss, static_cast<int>(a->ns),
                   L - k0, na, ptr(Bs(t)));
      for (int g = 0; g < nx; ++g)
        load_rows<E>(xb + g * a->x_sh + k0 * a->x_ss, a->x_ss,
                     static_cast<int>(a->hp), L - k0, 1, ptr(Xs(t, g)));
      copies_done<E>();
      __syncthreads();
    }
  }

  // Every thread, after its last read of tile t: frees the stage and,
  // from thread 0, fetches tile t + kNS (if below nk) into it.
  __device__ void release(int t, int nk, const CUtensorMap* xmap,
                          const CUtensorMap* bmap) const {
    if constexpr (E == kTma) {
      __syncwarp();
      const uint32_t empty = full + 8 * (kNS + t % kNS);
      if (threadIdx.x % 32 == 0) mbar_arrive(empty);
      if (threadIdx.x == 0 && t + kNS < nk) {
        mbar_wait(empty, (t / kNS) & 1);
        fetch(t + kNS, xmap, bmap);
      }
    }
  }
};

// Barriers of a ring (TMA): thread 0 sets them up, before a block
// barrier; `extra` more single-arrival ones follow.
template <int NS>
__device__ __forceinline__ void init_bars(uint32_t full, int extra) {
  for (int s = 0; s < NS; ++s) {
    mbar_init(full + 8 * s, 1);
    mbar_init(full + 8 * (NS + s), kBThreads / 32);  // one arrival a warp
  }
  for (int i = 0; i < extra; ++i) mbar_init(full + 8 * (2 * NS + i), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Heads a pass (a) CTA takes: at n <= 64 two, which share the B tiles
// and each warp covers all of n; at n = 128 one, whose n two warps split.
__host__ __device__ __forceinline__ int state_heads(int64_t n) {
  return n <= 64 ? 2 : 1;
}

// Pass (a). CTA (b, c, one or two heads) for c < nc - 1: inj = (x * w)^T
// @ B over the chunk's key tiles, each warp a block of 16 state rows.
template <int E>
__global__ void __launch_bounds__(kBThreads, 2)
ssd_scan_states_bf16(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap bmap,
                     const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     float* __restrict__ inj, float* __restrict__ decay,
                     ScanArgs a) {
  using Ring = KeyRing<E>;
  constexpr int NS = Ring::kNS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sm = align1k(smem_raw);
  const int P = static_cast<int>(a.hp), N = static_cast<int>(a.ns);
  const int Q = static_cast<int>(a.chunk);
  const int na = (N + 63) / 64;
  const int ga = state_heads(N);
  float* dts = reinterpret_cast<float*>(sm + NS * (na + ga) * kAtomBytes);
  float* acs2 = dts + 2 * kMaxChunk;                   // [2][256]
  float* w = acs2 + 2 * kMaxChunk;                     // [2][256]
  const uint32_t bars = smem_u32(w + 2 * kMaxChunk);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t nc1 = (a.seq + Q - 1) / Q - 1;
  const int64_t ngr = (a.heads + ga - 1) / ga;
  const int64_t h0 = (blockIdx.x % ngr) * ga;
  const int64_t bc = blockIdx.x / ngr;                 // b * nc1 + c
  const int64_t c = bc % nc1, b = bc / nc1;
  const int64_t c0 = c * Q;                            // a full chunk
  const int nk = (Q + kTile - 1) / kTile;
  const int gv = static_cast<int>(min(static_cast<int64_t>(ga),
                                      a.heads - h0));
  const Ring keys{smem_u32(sm), na, ga, gv, bars,
                  Bm + b * a.b_sb + c0 * a.b_ss,
                  x + b * a.x_sb + c0 * a.x_ss + h0 * a.x_sh, &a,
                  static_cast<int>(b), static_cast<int>(h0),
                  static_cast<int>(c0), Q};
  if constexpr (E == kTma) {
    if (tid == 0) init_bars<NS>(bars, 0);
    __syncthreads();
    if (tid == 0)
      for (int t = 0; t < min(NS, nk); ++t) keys.fetch(t, &xmap, &bmap);
  }
  if (warp % 4 == 0 && warp / 4 < gv) {
    const int j = warp / 4;
    chunk_acs2(dt + b * a.dt_sb + c0 * a.dt_ss + (h0 + j) * a.dt_sh, a.dt_ss,
               Q, A[h0 + j], dts + j * kMaxChunk, acs2 + j * kMaxChunk);
  }
  __syncthreads();
  for (int i = tid; i < gv * kMaxChunk; i += kBThreads) {
    const int j = i / kMaxChunk, k = i % kMaxChunk;
    const float end2 = acs2[j * kMaxChunk + Q - 1];
    w[i] = k < Q ? dts[i] * ex2(end2 - acs2[i]) : 0.f;
  }
  if (tid < gv)
    decay[bc * a.heads + h0 + tid] = ex2(acs2[tid * kMaxChunk + Q - 1]);
  __syncthreads();

  // warp (rb, sel): state rows 16 rb..; with two heads, head sel and
  // every 16-column step of n; with one, the steps 2 i + sel
  const int m0 = (warp % 4) * 16, sel = warp / 4;
  const int g = ga == 2 ? sel : 0, nh = ga == 2 ? 0 : sel;
  const int step = 3 - ga;  // 16-column steps between a warp's
  const int njp = (N + 15) / 16;
  const bool on = m0 < P && g < gv;
  const float* hw = w + g * kMaxChunk;
  float acc[8][4];
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  for (int t = 0; t < nk; ++t) {
    keys.wait(t);
    const uint32_t bs = keys.Bs(t), xs = keys.Xs(t, g);
    if (on) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4];
        ldmatrix_x4_trans(a_addr_t(xs, m0, kk * 16, lane), af);
        const float* wk = hw + t * kTile + kk * 16 + 2 * (lane % 4);
        uint32_t ah[4], al[4];
        scale_split(af[0], wk[0], wk[1], ah[0], al[0]);
        scale_split(af[1], wk[0], wk[1], ah[1], al[1]);
        scale_split(af[2], wk[8], wk[9], ah[2], al[2]);
        scale_split(af[3], wk[8], wk[9], ah[3], al[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int jp = step * i + nh;
          if (jp < njp) {
            uint32_t bf[4];
            ldmatrix_x4_trans(b_addr_t(bs, jp * 16, kk * 16, lane), bf);
            mma_bf16(acc[2 * i], ah, bf[0], bf[1]);
            mma_bf16(acc[2 * i + 1], ah, bf[2], bf[3]);
            mma_bf16(acc[2 * i], al, bf[0], bf[1]);
            mma_bf16(acc[2 * i + 1], al, bf[2], bf[3]);
          }
        }
      }
    }
    keys.release(t, nk, &xmap, &bmap);
  }
  if (!on) return;
  float* out = inj + (bc * a.heads + h0 + g) * P * N;
  const int r0 = m0 + lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const int n = (step * (f / 2) + nh) * 16 + (f % 2) * 8 + col;
    if (n < N) {
      if (r0 < P)
        *reinterpret_cast<float2*>(out + r0 * N + n) =
            make_float2(acc[f][0], acc[f][1]);
      if (r0 + 8 < P)
        *reinterpret_cast<float2*>(out + (r0 + 8) * N + n) =
            make_float2(acc[f][2], acc[f][3]);
    }
  }
}

// Pass (b). One thread per 8 state elements of a (batch, head): the
// state entering chunk c + 1, run = run * exp(acs_end) + inj over the
// chunks in fp32, stored to slot c of `states` as its bf16 hi + lo
// tiles, (p, n) each.
__global__ void __launch_bounds__(256)
ssd_scan_passing(const float* __restrict__ inj,
                 const float* __restrict__ decay, bf16* __restrict__ states,
                 int64_t batch, int64_t heads, int64_t pn, int64_t nc1) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t pn8 = pn / 8;
  if (i >= batch * heads * pn8) return;
  const int64_t e = i % pn8, bh = i / pn8;
  const int64_t h = bh % heads, b = bh / heads;
  float run[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int64_t c = 0; c < nc1; ++c) {
    const int64_t slot = (b * nc1 + c) * heads + h;
    const float d = decay[slot];
    const float4* src = reinterpret_cast<const float4*>(inj + slot * pn);
    const float4 u = src[2 * e], v = src[2 * e + 1];
    const float in[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int k = 0; k < 8; ++k) run[k] = fmaf(run[k], d, in[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      split_bf16(run[2 * k], run[2 * k + 1], hi[k], lo[k]);
    reinterpret_cast<uint4*>(states + 2 * slot * pn)[e] =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    reinterpret_cast<uint4*>(states + (2 * slot + 1) * pn)[e] =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

constexpr int kHeadGroup = 2;

// Atoms of pass (c)'s key ring: NS stages of B and kHeadGroup x tiles,
// which first hold the heads' states (hi and lo).
template <int NS>
__host__ __device__ __forceinline__ int ring_atoms(int na) {
  const int stages = NS * (na + kHeadGroup), states = 2 * kHeadGroup * na;
  return stages >= states ? stages : states;
}

// Pass (c). CTA (query tile, chunk, batch, pair of heads): each warp a
// block of 16 query rows of one head's y, every p. The two warps of a row
// block form C.B^T once for both heads, each over one half of the key
// tile, and trade halves through shared memory; then each applies its
// head's decay and dt and multiplies by its head's x.
template <int E>
__global__ void __launch_bounds__(kBThreads, 2)
ssd_scan_chunks_bf16(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ CUtensorMap cmap,
                     const __grid_constant__ CUtensorMap smap,
                     const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm, bf16* __restrict__ y,
                     const bf16* __restrict__ states, ScanArgs a) {
  constexpr int G = kHeadGroup;
  using Ring = KeyRing<E>;
  constexpr int NS = Ring::kNS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sm = align1k(smem_raw);
  const int P = static_cast<int>(a.hp), N = static_cast<int>(a.ns);
  const int Q = static_cast<int>(a.chunk);
  const int na = (N + 63) / 64;
  // The heads' states (hi, lo) are staged in the key ring, and the first
  // fetch waits for C @ state_in^T: a region of their own leaves one CTA
  // an SM at n = 128, and at n = 64, where it fits, it measured the same.
  uint8_t* Cs = sm;                                    // na atoms
  uint8_t* ring = Cs + na * kAtomBytes;
  uint8_t* St = ring;
  // C.B^T of a row block, [block][fragment][lane][4], fp32
  float* sx = reinterpret_cast<float*>(ring + ring_atoms<NS>(na) *
                                              kAtomBytes);
  float* dts = sx + 4 * 8 * 32 * 4;                    // [G][256]
  float* acs2 = dts + G * kMaxChunk;                   // [G][256]
  const uint32_t bars = smem_u32(acs2 + G * kMaxChunk);  // ring's, C's
  const uint32_t cbar = bars + 16 * NS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ntq = (Q + kTile - 1) / kTile;
  const int64_t nc = (a.seq + Q - 1) / Q;
  const int64_t ng = (a.heads + G - 1) / G;
  int64_t idx = blockIdx.x;
  const int64_t h0 = (idx % ng) * G;
  idx /= ng;
  const int qi = ntq - 1 - static_cast<int>(idx % ntq);  // long tiles first
  idx /= ntq;
  const int64_t c = idx % nc, b = idx / nc;
  const int64_t c0 = c * Q;
  const int L = static_cast<int>(min(static_cast<int64_t>(Q), a.seq - c0));
  const int q0 = qi * kTile;
  if (q0 >= L) return;
  const int nk = qi + 1;  // key tiles at or before the query tile
  const int gv = static_cast<int>(min(static_cast<int64_t>(G), a.heads - h0));
  const int rb = warp % 4, g = warp / 4;  // row block; head and key half
  const bool on = g < gv;                 // this warp's head exists
  const int64_t h = h0 + g;
  const Ring keys{smem_u32(ring), na, G, gv, bars,
                  Bm + b * a.b_sb + c0 * a.b_ss,
                  x + b * a.x_sb + c0 * a.x_ss + h0 * a.x_sh, &a,
                  static_cast<int>(b), static_cast<int>(h0),
                  static_cast<int>(c0), L};

  // the heads' states entering the chunk: slot (b, c - 1, h0 + j) of
  // `states`, its hi tile at St atom 2 j na and its lo tile na atoms on
  const int slot0 =
      static_cast<int>(((b * (nc - 1) + c - 1) * a.heads + h0) * 2);
  if constexpr (E == kTma) {
    if (tid == 0) init_bars<NS>(bars, 1);
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(cbar, (c > 0 ? 1 + 2 * gv : 1) * na * kAtomBytes);
      for (int at = 0; at < na; ++at) {
        tma_load_3d(smem_u32(Cs) + at * kAtomBytes, &cmap, cbar, at * 64,
                    static_cast<int>(c0 + q0), static_cast<int>(b));
        for (int j = 0; c > 0 && j < 2 * gv; ++j)
          tma_load_3d(smem_u32(St) + (j * na + at) * kAtomBytes, &smap, cbar,
                      at * 64, 0, slot0 + j);
      }
      if (c == 0)  // no state in the ring
        for (int t = 0; t < min(NS, nk); ++t) keys.fetch(t, &xmap, &bmap);
    }
  } else {
    load_rows<E>(Cm + b * a.c_sb + (c0 + q0) * a.c_ss, a.c_ss, N, L - q0,
                 na, Cs);
    for (int j = 0; c > 0 && j < 2 * gv; ++j)  // aligned in any case
      load_rows<kWide>(states + (slot0 + j) * P * N, N, N, P, na,
                       St + j * na * kAtomBytes);
  }
  if (on && rb == 0)
    chunk_acs2(dt + b * a.dt_sb + c0 * a.dt_ss + h * a.dt_sh, a.dt_ss,
               min(L, q0 + kTile), A[h], dts + g * kMaxChunk,
               acs2 + g * kMaxChunk);
  if constexpr (E != kTma) copies_done<kWide>();
  __syncthreads();
  if constexpr (E == kTma) mbar_wait(cbar, 0);

  const int m0 = rb * 16;
  const int nks = (N + 15) / 16, npj = (P + 15) / 16;
  const int qa = q0 + m0 + lane / 4, qb = qa + 8;  // chunk rows of c0..c3
  const float* hdt = dts + g * kMaxChunk;
  const float* hac = acs2 + g * kMaxChunk;
  const uint32_t cs = smem_u32(Cs);
  float acc[8][4];
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;

  if (c > 0 && on) {
    const uint32_t sh = smem_u32(St + 2 * g * na * kAtomBytes);
    const uint32_t sl = sh + na * kAtomBytes;
#pragma unroll 1
    for (int ks = 0; ks < 8; ++ks) {
      if (ks < nks) {
        uint32_t af[4];
        ldmatrix_x4(a_addr(cs, m0, ks * 16, lane), af);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp < npj) {
            uint32_t bh[4], bl[4];
            ldmatrix_x4(b_addr(sh, jp * 16, ks * 16, lane), bh);
            ldmatrix_x4(b_addr(sl, jp * 16, ks * 16, lane), bl);
            mma_bf16(acc[2 * jp], af, bh[0], bh[1]);
            mma_bf16(acc[2 * jp + 1], af, bh[2], bh[3]);
            mma_bf16(acc[2 * jp], af, bl[0], bl[1]);
            mma_bf16(acc[2 * jp + 1], af, bl[2], bl[3]);
          }
        }
      }
    }
    const float ea = ex2(hac[qa]), eb = ex2(hac[qb]);
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      acc[f][0] *= ea;
      acc[f][1] *= ea;
      acc[f][2] *= eb;
      acc[f][3] *= eb;
    }
  }
  if (E == kTma && c > 0) {
    __syncthreads();  // the states are read: their bytes take key tiles
    if (tid == 0)
      for (int t = 0; t < min(NS, nk); ++t) keys.fetch(t, &xmap, &bmap);
  }

  const float aqa = hac[qa], aqb = hac[qb];
  float4* pair = reinterpret_cast<float4*>(sx) + rb * 8 * 32;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    keys.wait(kt);
    const uint32_t bs = keys.Bs(kt);
    // fragments of 8 keys this row block can see: all off the diagonal
    // tile, up to its last row on it
    const int nkf = kt == qi ? m0 / 8 + 2 : 8;
    if (4 * g < nkf) {  // C.B^T over this warp's half of the keys
      float s[4][4];
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[f][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if (ks < nks) {
          uint32_t af[4];
          ldmatrix_x4(a_addr(cs, m0, ks * 16, lane), af);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int jp = 2 * g + j;
            if (2 * jp < nkf) {
              uint32_t bf[4];
              ldmatrix_x4(b_addr(bs, jp * 16, ks * 16, lane), bf);
              mma_bf16(s[2 * j], af, bf[0], bf[1]);
              mma_bf16(s[2 * j + 1], af, bf[2], bf[3]);
            }
          }
        }
      }
#pragma unroll
      for (int f = 0; f < 4; ++f)
        pair[(4 * g + f) * 32 + lane] =
            make_float4(s[f][0], s[f][1], s[f][2], s[f][3]);
    }
    // the row block's two warps: both halves written
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rb) : "memory");
    if (on) {
      const uint32_t xs = keys.Xs(kt, g);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (2 * kk < nkf) {
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int f = 2 * kk + hf;
            const float4 sv = pair[f * 32 + lane];
            const int k = k0 + f * 8 + 2 * (lane % 4);
            const float w0 = hdt[k], w1 = hdt[k + 1];
            const float a0 = hac[k], a1 = hac[k + 1];
            // masked before exp: entries with k > q are exactly 0
            split_bf16(k <= qa ? sv.x * (ex2(aqa - a0) * w0) : 0.f,
                       k + 1 <= qa ? sv.y * (ex2(aqa - a1) * w1) : 0.f,
                       ph[2 * hf], pl[2 * hf]);
            split_bf16(k <= qb ? sv.z * (ex2(aqb - a0) * w0) : 0.f,
                       k + 1 <= qb ? sv.w * (ex2(aqb - a1) * w1) : 0.f,
                       ph[2 * hf + 1], pl[2 * hf + 1]);
          }
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            if (jp < npj) {
              uint32_t bx[4];
              ldmatrix_x4_trans(b_addr_t(xs, jp * 16, kk * 16, lane), bx);
              mma_bf16(acc[2 * jp], ph, bx[0], bx[1]);
              mma_bf16(acc[2 * jp + 1], ph, bx[2], bx[3]);
              mma_bf16(acc[2 * jp], pl, bx[0], bx[1]);
              mma_bf16(acc[2 * jp + 1], pl, bx[2], bx[3]);
            }
          }
        }
      }
    }
    // both halves read before the next tile's are written
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rb) : "memory");
    keys.release(kt, nk, &xmap, &bmap);
  }

  if (!on) return;
  bf16* yb = y + b * a.y_sb + c0 * a.y_ss + h * a.y_sh;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const int p = f * 8 + col;
    if (p < P) {
      if (qa < L)
        *reinterpret_cast<__nv_bfloat162*>(yb + qa * a.y_ss + p) =
            __floats2bfloat162_rn(acc[f][0], acc[f][1]);
      if (qb < L)
        *reinterpret_cast<__nv_bfloat162*>(yb + qb * a.y_ss + p) =
            __floats2bfloat162_rn(acc[f][2], acc[f][3]);
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
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

// A bf16 tensor map of `rank` dims (innermost first) with element strides
// of dims 1.., a box of 64 columns by 64 rows of dim `row_dim` (1 in every
// other dim), 128-byte swizzle; elements outside the tensor read as zero.
// Returns 0 or kCuResultBase + CUresult.
int encode(CUtensorMap* map, const void* ptr, int rank, const int64_t* dims,
           const int64_t* strides, int row_dim) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return kCuResultBase + CUDA_ERROR_NOT_FOUND;
  cuuint64_t d[4], st[3];
  cuuint32_t box[4], es[4];
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    box[i] = i == 0 || i == row_dim ? 64 : 1;
    es[i] = 1;
    if (i + 1 < rank)
      st[i] = static_cast<cuuint64_t>(strides[i]) * sizeof(bf16);
  }
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d,
      st, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kCuResultBase + static_cast<int>(r);
}

// The three passes on the stream. ws holds each chunk's inj, (b, nc - 1,
// h, p, n) fp32; the states entering chunks 1.., (b, nc - 1, h, 2, p, n)
// bf16 hi and lo; and the decays, (b, nc - 1, h) fp32.
template <int E>
int launch_bf16(const void* x, const float* dt, const float* A,
                const void* B, const void* C, void* y, float* ws,
                const ScanArgs& a, cudaStream_t stream) {
  constexpr int NS = KeyRing<E>::kNS;
  const int64_t nc = (a.seq + a.chunk - 1) / a.chunk;
  const int na = static_cast<int>((a.ns + 63) / 64);
  const int64_t pn = a.hp * a.ns;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* bp = static_cast<const bf16*>(B);
  const int64_t slots = a.batch * (nc - 1) * a.heads;
  bf16* states = reinterpret_cast<bf16*>(ws + slots * pn);
  float* decay = ws + 2 * slots * pn;
  CUtensorMap xm{}, bm{}, cm{}, sm{};
  int rc;
  if constexpr (E == kTma) {
    const int64_t xd[4] = {a.hp, a.heads, a.seq, a.batch};
    const int64_t xs[3] = {a.x_sh, a.x_ss, a.x_sb};
    const int64_t bd[3] = {a.ns, a.seq, a.batch};
    const int64_t bs[2] = {a.b_ss, a.b_sb};
    const int64_t cs[2] = {a.c_ss, a.c_sb};
    if ((rc = encode(&xm, x, 4, xd, xs, 2))) return rc;
    if ((rc = encode(&bm, B, 3, bd, bs, 1))) return rc;
    if ((rc = encode(&cm, C, 3, bd, cs, 1))) return rc;
    if (nc > 1) {  // (n, p, hi/lo of a slot), rows p
      const int64_t sd[3] = {a.ns, a.hp, 2 * slots};
      const int64_t ss[2] = {a.ns, pn};
      if ((rc = encode(&sm, states, 3, sd, ss, 1))) return rc;
    }
  }
  if (nc > 1) {
    const int ga = state_heads(a.ns);
    const size_t smem_a = 1024 + NS * (na + ga) * kAtomBytes +
                          6 * kMaxChunk * 4 + 16 * NS;
    auto ka = ssd_scan_states_bf16<E>;
    if ((rc = set_smem(ka, smem_a))) return rc;
    const int64_t ctas = a.batch * (nc - 1) * ((a.heads + ga - 1) / ga);
    ka<<<static_cast<unsigned>(ctas), kBThreads, smem_a, stream>>>(
        xm, bm, xp, dt, A, bp, ws, decay, a);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
    const int64_t threads = a.batch * a.heads * (pn / 8);
    ssd_scan_passing<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                       stream>>>(ws, decay, states, a.batch, a.heads, pn,
                                 nc - 1);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  }
  constexpr int G = kHeadGroup;
  const size_t smem_c =
      1024 + (na + ring_atoms<NS>(na)) * kAtomBytes +
      4 * 8 * 32 * 16 + 2 * G * kMaxChunk * 4 + 8 * (2 * NS + 1);
  auto kc = ssd_scan_chunks_bf16<E>;
  if ((rc = set_smem(kc, smem_c))) return rc;
  const int64_t ntq = (a.chunk + kTile - 1) / kTile;
  const int64_t ng = (a.heads + G - 1) / G;
  kc<<<static_cast<unsigned>(ntq * nc * a.batch * ng), kBThreads,
       smem_c, stream>>>(xm, bm, cm, sm, xp, dt, A, bp,
                         static_cast<const bf16*>(C), static_cast<bf16*>(y),
                         states, a);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 route's loads: TMA for the prefill's aligned slices at p = 64
// and n a multiple of 64, cp.async for other aligned inputs, one element
// at a time otherwise.
int dispatch_bf16(const void* x, const float* dt, const float* A,
                  const void* B, const void* C, void* y, float* ws,
                  const ScanArgs& a, cudaStream_t stream) {
  if (!wide_loads<bf16>(x, B, C, a))
    return launch_bf16<kElem>(x, dt, A, B, C, y, ws, a, stream);
  if (a.hp == 64 && a.ns % 64 == 0)
    return launch_bf16<kTma>(x, dt, A, B, C, y, ws, a, stream);
  return launch_bf16<kWide>(x, dt, A, B, C, y, ws, a, stream);
}

}  // namespace

// dims: batch, seq, heads, head_dim, state, chunk, x strides (b, s, h),
// dt strides (b, s, h), B strides (b, s), C strides (b, s), y strides
// (b, s, h) -- 19 int64, element strides.
// ws: the bf16 route's workspace, b (nc - 1) h (2 p n + 1) fp32 (see
// launch_bf16; unused by fp32).
extern "C" int ssd_scan_fwd(int dtype, const void* x, const void* dt,
                            const void* A, const void* B, const void* C,
                            void* y, void* ws, const int64_t* dims,
                            void* stream) {
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
    return dispatch_bf16(x, dtp, Ap, B, C, y, static_cast<float*>(ws), a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
