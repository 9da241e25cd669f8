// Mamba-2 SSD (state-space duality) chunked scan, with an optional
// initial state in and the final state out.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:ssd_scan
// (_ssd_kernel, pallas_call at :108), and computes what the JAX package's
// pure-jnp models/mamba2.py:ssd_chunked computes.
//
// Semantics, per (batch b, head h), with g = h / (H / G) the head's B/C
// group: the linear recurrence
//     S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T ;   y_t = S_t C_t (+ D x_t)
// over a float32 (P, N) state, from S_{-1} = init_state (or 0), taken in
// chunks.  Inside a chunk of positions with L_t = cumsum(dt a):
//     y_t  = sum_{s<=t} (C_t . B_s) exp(L_t - L_s) dt_s x_s
//          + exp(L_t) S_prev C_t
//     S    = exp(L_last) S_prev + sum_s exp(L_last - L_s) dt_s x_s B_s^T
// The exponent is masked (s <= t) before the exp, as in the reference.  y
// is summed in float32, D x is added when d is given, and y is rounded once
// to x's type; the final state stays float32.  The decomposition is exact
// for any chunk length (the state at a chunk's end is the recurrence's
// state there), so another chunk changes only the order of the float32
// sums, not the function.
//
// What bounds it on the H100: at mamba2-2.7b's prefill (x 2 x 4096 x 80 x 64
// bf16, N 128, chunk 256) it moves about 180 MB of operands, 0.054 ms at
// 3.35 TB/s, and needs about 33 GFLOP (C B^T once per B/C group), 0.033 ms
// on the bf16 tensor cores' 989 TFLOP/s: bytes bound it.
//
// bfloat16, L >= the wrapper's threshold: chunk-parallel on the tensor
// cores, three launches from one entry point over a float32 workspace that
// the wrapper allocates.  The kernel's chunk Q is the caller's where that
// is a multiple of 64 up to 256 (else the nearest such), so that L_t comes
// from the same float32 cumsum the plain version forms: one thread adds
// dt_s a in order, as PyTorch's cumsum along a non-innermost dimension
// does, and the exponents match it bit for bit.
// (a) ssd_chunk_state, a block of two warpgroups per (b, chunk, 64
//     columns of P, 4 heads of one B/C group): B's chunk tile once and
//     every head's x, all through TMA (128-byte swizzle) issued at the
//     start; one thread per head forms L_t, then w_s = exp(L_last - L_s)
//     dt_s, and each warpgroup takes alternate heads: s_c = (w o x)^T B,
//     m64n128 wgmma products with A = (w o x)^T from registers and B from
//     shared memory.  Writes s_c (float32) and the chunk's L and dt to the
//     workspace.
// (b) ssd_state_pass, a thread per state element (b, h, p, n): walks the
//     chunks in order, S <- exp(L_last) S + s_c in float32 (multiply, then
//     add, as the plain version's two tensor ops round), writes the state
//     entering each chunk as two bf16 planes hi + lo, and the final state.
//     final_state may alias init_state: a thread reads its element before
//     it writes it.
// (c) ssd_chunk_scan, a block of two warpgroups per (b, chunk, 64-row tile
//     of the chunk, 64 columns of P, up to 8 heads of one B/C group): the
//     block forms C B^T for its row tile against every 64-column tile s <=
//     t of the chunk once (m64n64 wgmma, C and B bf16 from shared memory)
//     and keeps it in shared memory as float32.  Each warpgroup then takes
//     alternate heads, its head's x tiles, state halves, L and dt coming
//     through TMA into its own buffer while the other computes: y =
//     exp(L_t) C S_in^T + sum_s (C B^T o decay o dt) x (+ d x), rounded
//     once to bf16 and stored through shared memory in whole rows.  The
//     next tile's M is formed while the tensor cores multiply this one.
//     The decay of a position s left of a warp's 16 rows is exp(L_t -
//     L_a) (exp(L_a - L_s) dt_s), a the warp's first row, both exponents
//     <= 0: two exps a thread and one a column, and only each warp's
//     16 x 16 diagonal block takes exp(L_t - L_s) itself.  The longest row
//     tiles are dispatched first.
// Every float32 factor enters the tensor cores as two bf16 halves, hi +
// lo (M = C B^T o decay, w o x, S_in): one bf16 rounding carries 2^-9 of
// relative error into outputs that cancel, beyond the allowance (the CPU
// model in tests/test_torch_ssd.py).  wgmma truncates its float32 sums, so
// each tile's product goes into a fresh accumulator and the tiles are
// added in float32 with rounding to nearest.  A width TMA cannot map (P or
// N not a multiple of 8, a base not 16-byte aligned) takes the same path
// with the tiles written by plain loads.
//
// float32 inputs, and bf16 below the threshold (the decode step, L = 1):
// one launch on the CUDA cores (ssd_kernel), no workspace.  One block of
// 256 threads per (batch, head, 64 columns of P) walks the sequence in
// tiles of kT = 64 positions whatever the caller's chunk, the state in
// registers (each thread owns 4 rows of P x N/16 columns) and mirrored in
// shared memory for the C S^T product; a tile's B, C, x and its masked
// decay-weighted C B^T live in shared memory as float32.  Each thread owns
// a 4 x 4 patch (rows 4 ty + i, columns tx + 16 j) of the C B^T tile and
// of the output tile; a warp skips the columns right of its rows'
// diagonal, and the rows past the sequence's end.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "hopper.cuh"

namespace {

// ------------------------- float32, and bf16 decode: the CUDA cores

constexpr int kT = 64;         // positions of a tile
constexpr int kPT = 64;        // columns of P a block owns
constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kSX = kPT + 4;   // row stride of the x tile
constexpr int kSM = kT + 4;    // row stride of the C B^T tile

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct SsdArgs {
  const void* x;           // (B, L, H, P)
  const float* dt;         // (B, L, H)
  const float* a;          // (H,)
  const void* b;           // (B, L, G, N)
  const void* c;           // (B, L, G, N)
  const float* d;          // (H,) or null
  const float* init_state; // (B, H, P, N) or null
  void* y;                 // (B, L, H, P)
  float* final_state;      // (B, H, P, N) or null
  int len, h, p, g, n;
};

// Shared memory of a block, in floats, for N padded to NP (a multiple of
// 16).  Rows of B, C and the state are NP + 4 floats apart: a multiple of 4
// (float4 loads along N) whose quarter is odd, so the float4 loads of 8
// consecutive rows fall in distinct banks.
template <int NP>
struct Smem {
  static constexpr int kSB = NP + 4;
  static constexpr int kB = 0;
  static constexpr int kC = kB + kT * kSB;
  static constexpr int kS = kC + kT * kSB;
  static constexpr int kX = kS + kPT * kSB;
  static constexpr int kM = kX + kT * kSX;
  static constexpr int kDt = kM + kT * kSM;
  static constexpr int kL = kDt + kT;    // L_t
  static constexpr int kEl = kL + kT;    // exp(L_t)
  static constexpr int kW = kEl + kT;    // exp(L_last - L_t) dt_t
  static constexpr size_t kBytes = sizeof(float) * (kW + kT);
};

__device__ __forceinline__ float dot4(float4 u, float4 v) {
  return u.x * v.x + u.y * v.y + u.z * v.z + u.w * v.w;
}

// acc[i][j] = sum_n A[4 ty + i][n] * Bm[tx + 16 j][n] over n < NP, for the
// first jn values of j; A and Bm are row-major with stride SB.
template <int NP, int SB>
__device__ __forceinline__ void rows_dot(const float* A, const float* Bm,
                                         int ty, int tx, int jn,
                                         float (&acc)[4][4]) {
#pragma unroll 4
  for (int n = 0; n < NP; n += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * SB + n);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < jn)
        bv[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * SB + n);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < jn) acc[i][j] += dot4(av[i], bv[j]);
  }
}

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const SsdArgs args) {
  using S = Smem<NP>;
  constexpr int SB = S::kSB;
  constexpr int NJ = NP / 16;
  extern __shared__ float smem[];
  float* Bs = smem + S::kB;
  float* Cs = smem + S::kC;
  float* Ss = smem + S::kS;
  float* Xs = smem + S::kX;
  float* Ms = smem + S::kM;
  float* dts = smem + S::kDt;
  float* ld = smem + S::kL;
  float* el = smem + S::kEl;
  float* wt = smem + S::kW;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int L = args.len, H = args.h, P = args.p, G = args.g, N = args.n;
  const int g = h / (H / G);
  const float a = args.a[h];
  const float dskip = args.d != nullptr ? args.d[h] : 0.0f;
  const T* x = static_cast<const T*>(args.x);
  const T* bmat = static_cast<const T*>(args.b);
  const T* cmat = static_cast<const T*>(args.c);
  T* y = static_cast<T*>(args.y);
  const size_t state0 = ((size_t)bb * H + h) * P * N;

  // this thread's rows of the state: p = p0 + 4 ty + i, n = tx + 16 j
  float sreg[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tx + 16 * j;
      sreg[i][j] = (args.init_state != nullptr && p < P && n < N)
                       ? args.init_state[state0 + (size_t)p * N + n] : 0.0f;
      Ss[(4 * ty + i) * SB + n] = sreg[i][j];
    }
  }
  // rows 8 warp .. 8 warp + 7 are this warp's in the C B^T and output
  // tiles; the columns s <= 8 warp + 7 of C B^T lie in the first jn
  // column groups tx + 16 j
  const int row_lo = 8 * warp;
  const int jn = warp / 2 + 1;

  for (int t0 = 0; t0 < L; t0 += kT) {
    const int tlen = min(kT, L - t0);
    // ---- load the tile: dt, B, C, x (zero past the sequence / N / P)
    if (tid < kT) {
      dts[tid] = tid < tlen
                     ? args.dt[((size_t)bb * L + t0 + tid) * H + h] : 0.0f;
    }
    for (int idx = tid; idx < kT * NP; idx += kThreads) {
      const int t = idx / NP, n = idx % NP;
      float bv = 0.0f, cv = 0.0f;
      if (t < tlen && n < N) {
        const size_t off = (((size_t)bb * L + t0 + t) * G + g) * N + n;
        bv = load_f(bmat + off);
        cv = load_f(cmat + off);
      }
      Bs[t * SB + n] = bv;
      Cs[t * SB + n] = cv;
    }
    for (int idx = tid; idx < kT * kPT; idx += kThreads) {
      const int t = idx / kPT, pl = idx % kPT;
      const int p = p0 + pl;
      Xs[t * kSX + pl] =
          (t < tlen && p < P)
              ? load_f(x + (((size_t)bb * L + t0 + t) * H + h) * P + p) : 0.0f;
    }
    __syncthreads();

    // ---- L_t = cumsum(dt a) over the tile: warp 0, two positions a lane
    if (warp == 0) {
      const float v0 = dts[2 * lane] * a, v1 = dts[2 * lane + 1] * a;
      float incl = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const float excl = incl - (v0 + v1);
      const float l0 = excl + v0, l1 = excl + v0 + v1;
      const float last = __shfl_sync(0xffffffffu, l1, 31);
      ld[2 * lane] = l0;
      ld[2 * lane + 1] = l1;
      el[2 * lane] = expf(l0);
      el[2 * lane + 1] = expf(l1);
      wt[2 * lane] = expf(last - l0) * dts[2 * lane];
      wt[2 * lane + 1] = expf(last - l1) * dts[2 * lane + 1];
    }
    __syncthreads();

    // ---- M[t][s] = (C_t . B_s) exp(L_t - L_s) dt_s for s <= t, else 0
    const bool live = row_lo < tlen;  // warp-uniform
    {
      float acc[4][4] = {};
      if (live) rows_dot<NP, SB>(Cs, Bs, ty, tx, jn, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          float m = 0.0f;
          if (s <= t) {  // mask before the exp
            const float gm = expf(ld[t] - ld[s]) * dts[s];
            m = acc[i][j] * gm;
          }
          Ms[t * kSM + s] = m;
        }
      }
    }
    __syncthreads();

    // ---- y = M x + exp(L_t) C S_prev^T (+ d x), rows 4 ty + i, columns
    // tx + 16 j of the block's 64 columns of P
    if (live) {
      float inter[4][4] = {};
      rows_dot<NP, SB>(Cs, Ss, ty, tx, 4, inter);
      float intra[4][4] = {};
      const int s_hi = min(row_lo + 8, kT);
      for (int s = 0; s < s_hi; s += 4) {
        float4 mv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mv[i] = *reinterpret_cast<const float4*>(Ms + (4 * ty + i) * kSM + s);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float xv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xs[(s + k) * kSX + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float m = k == 0 ? mv[i].x : k == 1 ? mv[i].y
                          : k == 2 ? mv[i].z : mv[i].w;
#pragma unroll
            for (int j = 0; j < 4; ++j) intra[i][j] += m * xv[j];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * ty + i;
        if (t >= tlen) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pl = tx + 16 * j;
          const int p = p0 + pl;
          if (p >= P) continue;
          float v = intra[i][j] + el[t] * inter[i][j];
          if (args.d != nullptr) v += dskip * Xs[t * kSX + pl];
          store_f(y + (((size_t)bb * L + t0 + t) * H + h) * P + p, v);
        }
      }
    }
    __syncthreads();

    // ---- S = exp(L_last) S_prev + sum_s (exp(L_last - L_s) dt_s x_s) B_s^T
    {
      float acc[4][NJ] = {};
      for (int s = 0; s < tlen; ++s) {
        const float w = wt[s];
        const float4 xv4 =
            *reinterpret_cast<const float4*>(Xs + s * kSX + 4 * ty);
        const float xw[4] = {w * xv4.x, w * xv4.y, w * xv4.z, w * xv4.w};
        float bv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = Bs[s * SB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] += xw[i] * bv[j];
      }
      const float decay = expf(ld[kT - 1]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          sreg[i][j] = decay * sreg[i][j] + acc[i][j];
          Ss[(4 * ty + i) * SB + tx + 16 * j] = sreg[i][j];
        }
    }
    __syncthreads();
  }

  if (args.final_state != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + 4 * ty + i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tx + 16 * j;
        if (n < N) args.final_state[state0 + (size_t)p * N + n] = sreg[i][j];
      }
    }
  }
}

template <typename T, int NP>
int launch(const SsdArgs& a, int batch, cudaStream_t st) {
  const size_t bytes = Smem<NP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.p + kPT - 1) / kPT, a.h, batch);
  ssd_kernel<T, NP><<<grid, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const SsdArgs& a, int batch, cudaStream_t st) {
  if (a.n <= 16) return launch<T, 16>(a, batch, st);
  if (a.n <= 32) return launch<T, 32>(a, batch, st);
  if (a.n <= 64) return launch<T, 64>(a, batch, st);
  return launch<T, 128>(a, batch, st);
}

// ------------------------------ bfloat16: chunk-parallel, wgmma and TMA

namespace chunked {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kMaxQ = 256;      // the kernel's longest chunk
constexpr int kHeads = 8;       // heads of one B/C group a scan block takes
constexpr int kThreads = 128;   // one warpgroup
constexpr int kBox = 64 * 128;  // a 64-row x 64-column bf16 box, in bytes

struct ChunkArgs {
  const bf16* x;            // (B, L, H, P)
  const float* dt;          // (B, L, H)
  const float* a;           // (H,)
  const bf16* b;            // (B, L, G, N)
  const bf16* c;            // (B, L, G, N)
  const float* d;           // (H,) or null
  const float* init_state;  // (B, H, P, N) or null
  bf16* y;                  // (B, L, H, P)
  float* final_state;       // (B, H, P, N) or null
  float* ws_s;              // (B, nc, H, P, N): each chunk's own state
  bf16* ws_hi;              // (B, nc, H, P, N): the state entering it, hi
  bf16* ws_lo;              // the same, lo
  float* ws_ld;             // (B, nc, H, 2, Q): L_t, then dt_t, of a chunk
  int len, h, p, g, n, q, nc;
};

// The kernel's chunk for the caller's: a multiple of 64 in [64, 256].
inline int kernel_chunk(int chunk) {
  const int q = chunk / 64 * 64;
  return q < 64 ? 64 : (q > kMaxQ ? kMaxQ : q);
}

inline size_t align256(size_t v) {
  return (v + 255) & ~static_cast<size_t>(255);
}

// Byte offsets of the workspace's parts, and its size.
struct Layout {
  size_t hi, lo, ld, total;
};

inline Layout layout(int batch, int nc, int h, int p, int n, int q) {
  const size_t cells = static_cast<size_t>(batch) * nc * h * p * n;
  Layout l;
  l.hi = align256(cells * 4);
  l.lo = l.hi + align256(cells * 2);
  l.ld = l.lo + align256(cells * 2);
  l.total = l.ld + align256(static_cast<size_t>(batch) * nc * h * 2 * q * 4);
  return l;
}

// Byte offset of element (r, c) of a 64 x 64 bf16 box in the 128-byte
// swizzle that TMA writes and wgmma's descriptors read: 128-byte rows, the
// 16-byte chunk index XORed with the row's index within its 8-row group.
__device__ __forceinline__ int box_off(int r, int c) {
  return r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// The plain-load producer, for widths TMA cannot map: rows [0, 64) and
// columns [col0, col0 + 64) of a row-major bf16 matrix (row r at src +
// r * stride; rows >= nrows and columns >= ncols read as zero) into one
// swizzled box, by threads `tid` of `nthr`.  The caller fences and
// synchronises before wgmma reads it.
__device__ __forceinline__ void fill_box(uint8_t* box, const bf16* src,
                                         int nrows, size_t stride, int col0,
                                         int ncols, int tid, int nthr) {
  for (int idx = tid; idx < 64 * 64; idx += nthr) {
    const int r = idx >> 6, c = idx & 63;
    bf16 v = __float2bfloat16_rn(0.f);
    if (r < nrows && col0 + c < ncols) v = src[r * stride + col0 + c];
    *reinterpret_cast<bf16*>(box + box_off(r, c)) = v;
  }
}

// ---- (a) each chunk's own state, s_c = (w o x)^T B

constexpr int kStateHeads = 4;             // heads of one group a block takes
constexpr int kStateThreads = 2 * kThreads;  // two warpgroups

// Synchronise the 128 threads of warpgroup `wg` (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "r"(kThreads)
               : "memory");
}

struct StateSmem {  // byte offsets from the 1024-aligned base
  static constexpr int kB = 0;                // Q / 64 x 2 boxes of B
  static constexpr int kX = kB + 8 * kBox;    // each head's Q / 64 x boxes
  static constexpr int kDt = kX + kStateHeads * 4 * kBox;  // dt, L, w
  static constexpr int kL = kDt + kStateHeads * kMaxQ * 4;
  static constexpr int kW = kL + kStateHeads * kMaxQ * 4;
  static constexpr size_t kBytes = kW + kStateHeads * kMaxQ * 4 + 1024;
};

// A block per (b, chunk, 64 columns of P, up to kStateHeads heads of one
// B/C group): B's tiles once and every head's x, all loads issued at the
// start; the two warpgroups take alternate heads.
__global__ void __launch_bounds__(kStateThreads, 1)
ssd_chunk_state(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_b, const ChunkArgs A,
                int use_tma) {
  using S = StateSmem;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + kStateHeads];  // B's tiles; each head's x
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  uint8_t* const bp = smem_raw + (base - raw);
  float* const dts = reinterpret_cast<float*>(bp + S::kDt);
  float* const ls = reinterpret_cast<float*>(bp + S::kL);
  float* const ws = reinterpret_cast<float*>(bp + S::kW);

  const int ptiles = (A.p + 63) / 64;
  const int hpg = A.h / A.g;
  const int hblocks = (hpg + kStateHeads - 1) / kStateHeads;
  int idx = blockIdx.x;
  const int pt = idx % ptiles;
  idx /= ptiles;
  const int hb = idx % (A.g * hblocks);
  idx /= A.g * hblocks;
  const int ci = idx % A.nc;
  const int bb = idx / A.nc;
  const int p0 = pt * 64;
  const int grp = hb / hblocks;
  const int h0 = grp * hpg + (hb % hblocks) * kStateHeads;
  const int nh = min(kStateHeads, (grp + 1) * hpg - h0);
  const int cs = ci * A.q;
  const int valid = min(A.q, A.len - cs);
  const int nq = (valid + 63) / 64;  // the 64-position tiles holding positions
  const int nbox = A.n > 64 ? 2 : 1;
  const int tid = threadIdx.x;
  const int wg = tid / kThreads, wtid = tid % kThreads;

  // Head h0 + i's x tiles into its buffer.
  auto load_x = [&](int i) {
    const int h = h0 + i;
    const int off = S::kX + i * 4 * kBox;
    if (use_tma) {
      const uint32_t bar = smem_u32(&bars[1 + i]);
      mbar_expect_tx(bar, static_cast<uint32_t>(nq * kBox));
      for (int j = 0; j < nq; ++j)
        tma_load(base + off + j * kBox, &map_x, bar, p0, h, cs + 64 * j, bb);
    } else {
      for (int j = 0; j < nq; ++j) {
        const int pos = cs + 64 * j;
        fill_box(bp + off + j * kBox,
                 A.x + ((static_cast<size_t>(bb) * A.len + pos) * A.h + h)
                           * A.p,
                 A.len - pos, static_cast<size_t>(A.h) * A.p, p0, A.p, wtid,
                 kThreads);
      }
      fence_async_smem();
    }
  };

  if (tid == 0) {
    for (int i = 0; i <= kStateHeads; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (use_tma) {
    if (tid == 0) {
      const uint32_t bar = smem_u32(&bars[0]);
      mbar_expect_tx(bar, static_cast<uint32_t>(nq * nbox * kBox));
      for (int j = 0; j < nq; ++j)
        for (int k = 0; k < nbox; ++k)
          tma_load(base + S::kB + (2 * j + k) * kBox, &map_b, bar, 64 * k,
                   grp, cs + 64 * j, bb);
      for (int i = 0; i < nh; ++i) load_x(i);
    }
  } else {
    for (int j = 0; j < nq; ++j)
      for (int k = 0; k < nbox; ++k) {
        const int pos = cs + 64 * j;
        fill_box(bp + S::kB + (2 * j + k) * kBox,
                 A.b + ((static_cast<size_t>(bb) * A.len + pos) * A.g + grp)
                           * A.n,
                 A.len - pos, static_cast<size_t>(A.g) * A.n, 64 * k, A.n,
                 tid, kStateThreads);
      }
    fence_async_smem();
  }
  // dt of the block's heads (neighbouring heads on neighbouring threads,
  // every load issued before the first store), zero past the sequence
  constexpr int kPer = kStateHeads * kMaxQ / kStateThreads;
  float dv[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = tid + u * kStateThreads;
    const int s = e / nh, k = e % nh;
    dv[u] = e < nh * A.q && s < valid
                ? A.dt[(static_cast<size_t>(bb) * A.len + cs + s) * A.h + h0
                       + k]
                : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = tid + u * kStateThreads;
    if (e < nh * A.q) dts[(e % nh) * kMaxQ + e / nh] = dv[u];
  }
  __syncthreads();
  // L = cumsum(dt a) in order, a thread per head, rounding the product and
  // then the sum, as the plain version's float32 ops do
  if (tid < nh) {
    const float av = A.a[h0 + tid];
    const float* d = dts + tid * kMaxQ;
    float* l = ls + tid * kMaxQ;
    float acc = 0.f;
    for (int s0 = 0; s0 < A.q; s0 += 64) {  // the loads off the chain
      float v[64];
#pragma unroll
      for (int u = 0; u < 64; ++u) v[u] = __fmul_rn(d[s0 + u], av);
#pragma unroll
      for (int u = 0; u < 64; ++u) {
        acc = __fadd_rn(acc, v[u]);
        l[s0 + u] = acc;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nh * A.q; e += kStateThreads) {
    const int k = e / A.q, s = e % A.q;
    const float* l = ls + k * kMaxQ;
    ws[k * kMaxQ + s] = __fmul_rn(expf(l[A.q - 1] - l[s]), dts[k * kMaxQ + s]);
    if (pt == 0) {
      float* row = A.ws_ld + ((static_cast<size_t>(bb) * A.nc + ci) * A.h
                              + h0 + k) * 2 * A.q;
      row[s] = l[s];
      row[A.q + s] = dts[k * kMaxQ + s];
    }
  }
  __syncthreads();
  if (use_tma) mbar_wait(smem_u32(&bars[0]), 0);

  // A thread holds rows r0 and r0 + 8 of the block's 64 columns of P (the
  // wgmma fragment layout), and of each 8 columns of N the pair col0, + 1.
  const int warp = wtid >> 5, lane = wtid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  for (int i = wg; i < nh; i += 2) {
    const int h = h0 + i;
    const int xoff = S::kX + i * 4 * kBox;
    if (use_tma) {
      mbar_wait(smem_u32(&bars[1 + i]), 0);
    } else {
      load_x(i);
      wg_sync(wg);
    }
    const float* w = ws + i * kMaxQ;
    float acc[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) acc[k] = 0.f;
    for (int j = 0; j < nq; ++j) {
      // A = (w o x)^T over 16 positions a step, as hi + lo: a[r] holds row
      // r0 (+ 8 if r & 1) at positions 16 kk + col0 (+ 8 if r & 2), + 1.
      const uint8_t* xb = bp + xoff + j * kBox;
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int pr = r0 + ((r & 1) ? 8 : 0);
          const int sr = 16 * kk + col0 + ((r & 2) ? 8 : 0);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = __fmul_rn(w[64 * j + sr + e], __bfloat162float(
                *reinterpret_cast<const bf16*>(xb + box_off(sr + e, pr))));
          split_pack_bf16(v[0], v[1], &hi[kk][r], &lo[kk][r]);
        }
      }
      // this tile's product into a fresh accumulator (wgmma truncates its
      // sums), then added in float32
      float part[64];
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = sw128_desc(
            base + S::kB + 2 * j * kBox + kk * 16 * 128, kBox, 1024);
        wgmma_rs(part, hi[kk], db, kk > 0);
        wgmma_rs(part, lo[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int k = 0; k < 64; ++k) acc[k] += part[k];
    }

    float* out = A.ws_s + ((static_cast<size_t>(bb) * A.nc + ci) * A.h + h)
                              * A.p * A.n;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + r0 + 8 * half;
      if (p >= A.p) continue;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int n = 8 * jn + col0;
        if (n < A.n)
          out[static_cast<size_t>(p) * A.n + n] = acc[4 * jn + 2 * half];
        if (n + 1 < A.n)
          out[static_cast<size_t>(p) * A.n + n + 1] =
              acc[4 * jn + 2 * half + 1];
      }
    }
  }
}

// ---- (b) the states entering each chunk, in order

constexpr int kPassThreads = 256;

__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const ChunkArgs A) {
  const int cells = A.p * A.n;
  const int per = (cells + kPassThreads - 1) / kPassThreads;
  const int bh = blockIdx.x / per;
  const int e = (blockIdx.x % per) * kPassThreads + threadIdx.x;
  if (e >= cells) return;
  const int bb = bh / A.h, h = bh % A.h;
  const float* __restrict__ s_own = A.ws_s;
  const float* __restrict__ ld = A.ws_ld;
  bf16* __restrict__ s_hi = A.ws_hi;
  bf16* __restrict__ s_lo = A.ws_lo;
  float s = A.init_state != nullptr
                ? A.init_state[static_cast<size_t>(bh) * cells + e] : 0.f;
#pragma unroll 4
  for (int ci = 0; ci < A.nc; ++ci) {
    const size_t plane = (static_cast<size_t>(bb) * A.nc + ci) * A.h + h;
    const size_t off = plane * cells + e;
    const float own = s_own[off];
    const float decay = expf(ld[plane * 2 * A.q + A.q - 1]);
    const bf16 hi = __float2bfloat16_rn(s);
    s_hi[off] = hi;
    s_lo[off] = __float2bfloat16_rn(s - __bfloat162float(hi));
    s = __fadd_rn(__fmul_rn(decay, s), own);
  }
  if (A.final_state != nullptr)
    A.final_state[static_cast<size_t>(bh) * cells + e] = s;
}

// ---- (c) y of each 64-row tile, C B^T shared across a group's heads

constexpr int kScanThreads = 2 * kThreads;  // two consumer warpgroups

struct ScanSmem {  // byte offsets from the 1024-aligned base
  static constexpr int kC = 0;                      // C's row tile, 2 boxes
  static constexpr int kCB = kC + 2 * kBox;         // 4 C B^T tiles, float32
  static constexpr int kBuf0 = kCB + 4 * 64 * 64 * 4;
  static constexpr int kBuf1 = kBuf0 + 8 * kBox;    // first B's tiles
  // per head buffer: L and dt of the chunk, then each warp's column
  // factors
  static constexpr int kLd = kBuf1 + 8 * kBox;
  static constexpr int kLdFloats = 6 * kMaxQ;
  static constexpr size_t kBytes = kLd + 2 * kLdFloats * 4 + 1024;
};
// A head's buffer: its x tiles (one box each), then S_in hi and lo.
constexpr int kXOff = 0, kHiOff = 4 * kBox, kLoOff = 6 * kBox;

// The A fragments of M = C B^T o exp(L_t - L_s) dt_s over the row tile's
// rows tr0, tr1 (in the chunk) and the 64 columns of tile j, as hi + lo:
// the 32 values of the thread's C B^T fragment (8 float4 at `cb`,
// thread-fastest) are the wgmma accumulator's, pairs (8 kk + 2 r, + 1) of
// step kk.  Warp wq holds rows a .. a + 15, a = 64 rt + 16 wq.  For the
// columns s < a the decay is g_t f_s, g_t = exp(L_t - L_a) (g0, g1) and
// f_s = exp(L_a - L_s) dt_s (`fw`, the warp's own): both exponents are
// <= 0.  Only the 16 x 16 block on the diagonal takes exp(L_t - L_s) dt_s
// itself, masked (s <= t) before the exp as in the plain version; the
// columns right of it are 0.
// kDiag: tile j is the row tile's own (a separate instantiation, so that
// the tiles below it carry no exp code at all).
template <bool kDiag>
__device__ __forceinline__ void m_fragments(const float4* cb, int wtid,
                                            const float* Ls, const float* dts,
                                            const float* fw, float g0,
                                            float g1, int tr0, int tr1, int j,
                                            int wq, int col0,
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
  const int s0 = 64 * j;
#pragma unroll
  for (int q4 = 0; q4 < 8; ++q4) {
    const float4 c4 = cb[q4 * kThreads + wtid];
    const float v[4] = {c4.x, c4.y, c4.z, c4.w};
    const int jn = q4;  // the columns 8 jn .. 8 jn + 7
    float m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = 4 * q4 + u;
      const int t = (k & 2) ? tr1 : tr0;
      const int s = s0 + 8 * jn + col0 + (k & 1);
      if (!kDiag || jn < 2 * wq)
        m[u] = v[u] * __fmul_rn((k & 2) ? g1 : g0, fw[s]);
      else if (jn > 2 * wq + 1)
        m[u] = 0.f;
      else
        m[u] = s <= t ? v[u] * __fmul_rn(expf(Ls[t] - Ls[s]), dts[s]) : 0.f;
    }
    // values 4 q4 .. 4 q4 + 3 are the pairs r = 2 (q4 & 1), + 1 of step
    // kk = q4 / 2
    split_pack_bf16(m[0], m[1], &hi[q4 >> 1][2 * (q4 & 1)],
                    &lo[q4 >> 1][2 * (q4 & 1)]);
    split_pack_bf16(m[2], m[3], &hi[q4 >> 1][2 * (q4 & 1) + 1],
                    &lo[q4 >> 1][2 * (q4 & 1) + 1]);
  }
}

// part = M x over tile j: 4 steps of 16 positions, M as hi + lo.
__device__ __forceinline__ void mx_issue(float (&part)[32], uint32_t xtile,
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4]) {
  fence_regs(part);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dx = sw128_desc(xtile + kk * 16 * 128, kBox, 1024);
    wgmma_rs(part, hi[kk], dx, kk > 0);
    wgmma_rs(part, lo[kk], dx, 1);
  }
  wgmma_commit();
}

__global__ void __launch_bounds__(kScanThreads, 1)
ssd_chunk_scan(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_c,
               const __grid_constant__ CUtensorMap map_hi,
               const __grid_constant__ CUtensorMap map_lo, const ChunkArgs A,
               int use_tma) {
  using S = ScanSmem;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[3];  // C and B's tiles; head buffers 0 and 1
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const bp = smem_raw + (base - raw);
  float* const lds = reinterpret_cast<float*>(bp + S::kLd);

  const int nrt = A.q / 64;
  const int ptiles = (A.p + 63) / 64;
  const int hpg = A.h / A.g;
  const int hblocks = (hpg + kHeads - 1) / kHeads;
  int idx = blockIdx.x;
  const int rt = nrt - 1 - idx % nrt;  // the longest row tiles first
  idx /= nrt;
  const int hb = idx % (A.g * hblocks);
  idx /= A.g * hblocks;
  const int pt = idx % ptiles;
  idx /= ptiles;
  const int ci = idx % A.nc;
  const int bb = idx / A.nc;
  const int cs = ci * A.q;
  const int t0 = cs + 64 * rt;
  if (t0 >= A.len) return;
  const int grp = hb / hblocks;
  const int h0 = grp * hpg + (hb % hblocks) * kHeads;
  const int nh = min(kHeads, (grp + 1) * hpg - h0);
  const int p0 = pt * 64;
  const int nk = (A.n + 15) / 16;  // wgmma steps of 16 over N
  const int nbox = A.n > 64 ? 2 : 1;
  const int tid = threadIdx.x;
  const int wg = tid / kThreads, wtid = tid % kThreads;

  // Head h0 + i into buffer i & 1, which warpgroup i & 1 computes: its x
  // tiles 0..rt of the chunk, the state entering the chunk as hi and lo,
  // and the chunk's L and dt.  With TMA one thread issues it; otherwise
  // the warpgroup's threads load it.
  auto load_head = [&](int i) {
    const int h = h0 + i;
    const int buf = i & 1;
    const int off = buf ? S::kBuf1 : S::kBuf0;
    const size_t plane = (static_cast<size_t>(bb) * A.nc + ci) * A.h + h;
    const float* ld_row = A.ws_ld + plane * 2 * A.q;
    float* ld_dst = lds + buf * S::kLdFloats;
    if (use_tma) {
      const uint32_t bar = smem_u32(&bars[1 + buf]);
      mbar_expect_tx(bar, static_cast<uint32_t>((rt + 1 + 2 * nbox) * kBox
                                                + 2 * A.q * 4));
      for (int j = 0; j <= rt; ++j)
        tma_load(base + off + kXOff + j * kBox, &map_x, bar, p0, h,
                 cs + 64 * j, bb);
      for (int k = 0; k < nbox; ++k) {
        tma_load(base + off + kHiOff + k * kBox, &map_hi, bar, 64 * k, p0,
                 static_cast<int>(plane));
        tma_load(base + off + kLoOff + k * kBox, &map_lo, bar, 64 * k, p0,
                 static_cast<int>(plane));
      }
      bulk_load(smem_u32(ld_dst), ld_row, 2 * A.q * 4, bar);
    } else {
      for (int j = 0; j <= rt; ++j) {
        const int pos = cs + 64 * j;
        fill_box(bp + off + kXOff + j * kBox,
                 A.x + ((static_cast<size_t>(bb) * A.len + pos) * A.h + h)
                           * A.p,
                 A.len - pos, static_cast<size_t>(A.h) * A.p, p0, A.p, wtid,
                 kThreads);
      }
      const size_t srow = plane * A.p * A.n + static_cast<size_t>(p0) * A.n;
      for (int k = 0; k < nbox; ++k) {
        fill_box(bp + off + kHiOff + k * kBox, A.ws_hi + srow, A.p - p0, A.n,
                 64 * k, A.n, wtid, kThreads);
        fill_box(bp + off + kLoOff + k * kBox, A.ws_lo + srow, A.p - p0, A.n,
                 64 * k, A.n, wtid, kThreads);
      }
      for (int s = wtid; s < 2 * A.q; s += kThreads) ld_dst[s] = ld_row[s];
      fence_async_smem();
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // C's row tile and B's tiles 0..rt of the chunk (in buffer 1's place),
  // then head 0 into buffer 0.
  if (use_tma) {
    if (tid == 0) {
      const uint32_t bar = smem_u32(&bars[0]);
      mbar_expect_tx(bar, static_cast<uint32_t>((rt + 2) * nbox * kBox));
      for (int k = 0; k < nbox; ++k) {
        tma_load(base + S::kC + k * kBox, &map_c, bar, 64 * k, grp, t0, bb);
        for (int j = 0; j <= rt; ++j)
          tma_load(base + S::kBuf1 + (2 * j + k) * kBox, &map_b, bar, 64 * k,
                   grp, cs + 64 * j, bb);
      }
      load_head(0);
    }
    mbar_wait(smem_u32(&bars[0]), 0);
  } else {
    for (int k = 0; k < nbox; ++k) {
      fill_box(bp + S::kC + k * kBox,
               A.c + ((static_cast<size_t>(bb) * A.len + t0) * A.g + grp)
                         * A.n,
               A.len - t0, static_cast<size_t>(A.g) * A.n, 64 * k, A.n, tid,
               kScanThreads);
      for (int j = 0; j <= rt; ++j) {
        const int pos = cs + 64 * j;
        fill_box(bp + S::kBuf1 + (2 * j + k) * kBox,
                 A.b + ((static_cast<size_t>(bb) * A.len + pos) * A.g + grp)
                           * A.n,
                 A.len - pos, static_cast<size_t>(A.g) * A.n, 64 * k, A.n,
                 tid, kScanThreads);
      }
    }
    fence_async_smem();
    __syncthreads();
  }

  // A thread holds rows r0 and r0 + 8 of the row tile (the wgmma fragment
  // layout), and of each 8 columns the pair col0, + 1.
  const int warp = wtid >> 5, lane = wtid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const int tr0 = 64 * rt + r0, tr1 = tr0 + 8;  // the rows in the chunk

  // C B^T against each 64-column tile s <= t of the chunk, once for all the
  // block's heads (the warpgroups take alternate tiles), kept in shared
  // memory in the fragment layout: a thread's 32 values as 8 float4,
  // thread-fastest.
  float4* const cbs = reinterpret_cast<float4*>(bp + S::kCB);
  for (int j = wg; j <= rt; j += 2) {
    float cb[32];
    fence_regs(cb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk < nk) {
        const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
        wgmma_ss(cb, sw128_desc(base + S::kC + off, 16, 1024),
                 sw128_desc(base + S::kBuf1 + 2 * j * kBox + off, 16, 1024),
                 kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(cb);
#pragma unroll
    for (int q4 = 0; q4 < 8; ++q4)
      cbs[(j * 8 + q4) * kThreads + wtid] =
          make_float4(cb[4 * q4], cb[4 * q4 + 1], cb[4 * q4 + 2],
                      cb[4 * q4 + 3]);
  }
  __syncthreads();  // C B^T is written and B's tiles read: buffer 1 is free
  if (use_tma && tid == kThreads && nh > 1) load_head(1);

  // Warpgroup wg computes heads wg, wg + 2, ... from buffer wg.
  const int off = wg ? S::kBuf1 : S::kBuf0;
  const float* Ls = lds + wg * S::kLdFloats;
  const float* dts = Ls + A.q;
  float* fw = lds + wg * S::kLdFloats + (2 + warp) * kMaxQ;
  for (int i = wg; i < nh; i += 2) {
    const int h = h0 + i;
    if (use_tma) {
      mbar_wait(smem_u32(&bars[1 + wg]), (i >> 1) & 1);
    } else {
      load_head(i);
      wg_sync(wg);
    }
    // the warp's factors exp(L_t - L_a) of its rows and exp(L_a - L_s) dt_s
    // of the columns s < a, a its first row
    const int ra = 64 * rt + 16 * warp;
    for (int s = lane; s < ra; s += 32)
      fw[s] = __fmul_rn(expf(Ls[ra] - Ls[s]), dts[s]);
    const float g0 = expf(Ls[tr0] - Ls[ra]), g1 = expf(Ls[tr1] - Ls[ra]);
    __syncwarp();
    auto frags = [&](int j, uint32_t (&h)[4][4], uint32_t (&l)[4][4]) {
      const float4* cb = cbs + j * 8 * kThreads;
      if (j == rt)
        m_fragments<true>(cb, wtid, Ls, dts, fw, g0, g1, tr0, tr1, j, warp,
                          col0, h, l);
      else
        m_fragments<false>(cb, wtid, Ls, dts, fw, g0, g1, tr0, tr1, j, warp,
                           col0, h, l);
    };

    // exp(L_t) C S_in^T, S_in as hi + lo, into a fresh accumulator, while
    // the first tile's M is formed
    float y[32], part[32];
    uint32_t ha[4][4], lo_a[4][4], hb2[4][4], lb[4][4];
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk < nk) {
        const uint32_t o = (kk >> 2) * kBox + (kk & 3) * 32;
        const uint64_t dc = sw128_desc(base + S::kC + o, 16, 1024);
        wgmma_ss(part, dc, sw128_desc(base + off + kHiOff + o, 16, 1024),
                 kk > 0);
        wgmma_ss(part, dc, sw128_desc(base + off + kLoOff + o, 16, 1024), 1);
      }
    }
    wgmma_commit();
    frags(0, ha, lo_a);
    wgmma_wait_all();
    fence_regs(part);
    const float e0 = expf(Ls[tr0]), e1 = expf(Ls[tr1]);
#pragma unroll
    for (int k = 0; k < 32; ++k) y[k] = __fmul_rn((k & 2) ? e1 : e0, part[k]);

    // + sum over the tiles s <= t of M x, each into a fresh accumulator,
    // the next tile's M formed while the tensor cores run
    for (int j = 0; j <= rt; j += 2) {
      mx_issue(part, base + off + kXOff + j * kBox, ha, lo_a);
      if (j + 1 <= rt)
        frags(j + 1, hb2, lb);
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int k = 0; k < 32; ++k) y[k] = __fadd_rn(y[k], part[k]);
      if (j + 1 > rt) break;
      mx_issue(part, base + off + kXOff + (j + 1) * kBox, hb2, lb);
      if (j + 2 <= rt)
        frags(j + 2, ha, lo_a);
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int k = 0; k < 32; ++k) y[k] = __fadd_rn(y[k], part[k]);
    }

    // (+ d x), rounded once to bf16, then written out through shared
    // memory (this head's x tile 0, swizzled) in 16-byte pieces of whole
    // rows; rows past the sequence and columns past P are not stored
    const float dh = A.d != nullptr ? A.d[h] : 0.f;
    const uint8_t* xt = bp + off + kXOff + rt * kBox;
    uint32_t packed[2][8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = r0 + 8 * half;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int pc = 8 * jn + col0;
        float v0 = y[4 * jn + 2 * half], v1 = y[4 * jn + 2 * half + 1];
        if (A.d != nullptr) {
          const float x0 = __bfloat162float(
              *reinterpret_cast<const bf16*>(xt + box_off(rl, pc)));
          const float x1 = __bfloat162float(
              *reinterpret_cast<const bf16*>(xt + box_off(rl, pc + 1)));
          v0 = __fadd_rn(v0, __fmul_rn(dh, x0));
          v1 = __fadd_rn(v1, __fmul_rn(dh, x1));
        }
        packed[half][jn] = pack_bf16(v0, v1);
      }
    }
    wg_sync(wg);  // x is read: its tile 0 takes y
    uint8_t* stage = bp + off + kXOff;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
        *reinterpret_cast<uint32_t*>(stage + box_off(r0 + 8 * half,
                                                     8 * jn + col0)) =
            packed[half][jn];
    wg_sync(wg);
    const bool vec = A.p % 8 == 0;
    for (int e = wtid; e < 64 * 8; e += kThreads) {
      const int rl = e >> 3, c8 = e & 7;
      const int t = t0 + rl, p = p0 + 8 * c8;
      if (t >= A.len || p >= A.p) continue;
      bf16* yrow = A.y + ((static_cast<size_t>(bb) * A.len + t) * A.h + h)
                             * A.p;
      const uint8_t* piece = stage + rl * 128 + ((c8 ^ (rl & 7)) << 4);
      if (vec) {
        *reinterpret_cast<uint4*>(yrow + p) =
            *reinterpret_cast<const uint4*>(piece);
      } else {
        for (int q = 0; q < 8 && p + q < A.p; ++q)
          yrow[p + q] = reinterpret_cast<const bf16*>(piece)[q];
      }
    }
    fence_async_smem();  // before TMA writes the buffer again
    wg_sync(wg);  // the warpgroup is done with this head's buffer
    if (use_tma && wtid == 0 && i + 2 < nh) load_head(i + 2);
  }
}

// A 4-D map of (B, L, groups, width) bf16 read in boxes of 64 columns x
// 1 group x 64 positions (x: groups = heads, width = P; B, C: G and N).
int encode_rows(CUtensorMap* map, const void* ptr, int width, int groups,
                int len, int batch) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(groups),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t w = static_cast<cuuint64_t>(width) * 2;
  const cuuint64_t strides[3] = {w, w * groups, w * groups * len};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return encode_bf16_map(map, ptr, 4, dims, strides, box);
}

// A 3-D map of the (planes, P, N) state halves in boxes of 64 x 64.
int encode_state(CUtensorMap* map, const void* ptr, int n, int p,
                 int planes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(p),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n) * 2,
                                 static_cast<cuuint64_t>(n) * 2 * p};
  const cuuint32_t box[3] = {64, 64, 1};
  return encode_bf16_map(map, ptr, 3, dims, strides, box);
}

int launch(ChunkArgs A, int batch, int chunk, void* ws, long long ws_bytes,
           cudaStream_t st) {
  A.q = kernel_chunk(chunk);
  A.nc = (A.len + A.q - 1) / A.q;
  const Layout lay = layout(batch, A.nc, A.h, A.p, A.n, A.q);
  if (ws == nullptr || ws_bytes < static_cast<long long>(lay.total))
    return static_cast<int>(cudaErrorInvalidValue);
  uint8_t* w = static_cast<uint8_t*>(ws);
  A.ws_s = reinterpret_cast<float*>(w);
  A.ws_hi = reinterpret_cast<bf16*>(w + lay.hi);
  A.ws_lo = reinterpret_cast<bf16*>(w + lay.lo);
  A.ws_ld = reinterpret_cast<float*>(w + lay.ld);

  CUtensorMap mx, mb, mc, mhi, mlo;
  std::memset(&mx, 0, sizeof(mx));
  std::memset(&mb, 0, sizeof(mb));
  std::memset(&mc, 0, sizeof(mc));
  std::memset(&mhi, 0, sizeof(mhi));
  std::memset(&mlo, 0, sizeof(mlo));
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int use_tma = A.p % 8 == 0 && A.n % 8 == 0 && aligned(A.x)
                      && aligned(A.b) && aligned(A.c);
  if (use_tma) {
    const int planes = batch * A.nc * A.h;
    int err = encode_rows(&mx, A.x, A.p, A.h, A.len, batch);
    if (err == 0) err = encode_rows(&mb, A.b, A.n, A.g, A.len, batch);
    if (err == 0) err = encode_rows(&mc, A.c, A.n, A.g, A.len, batch);
    if (err == 0) err = encode_state(&mhi, A.ws_hi, A.n, A.p, planes);
    if (err == 0) err = encode_state(&mlo, A.ws_lo, A.n, A.p, planes);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(StateSmem::kBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_scan,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(ScanSmem::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ptiles = (A.p + 63) / 64;
  const int hpg = A.h / A.g;
  const int hblocks = (hpg + kHeads - 1) / kHeads;
  const int state_blocks = (hpg + kStateHeads - 1) / kStateHeads;

  ssd_chunk_state<<<batch * A.nc * ptiles * A.g * state_blocks,
                    kStateThreads, StateSmem::kBytes, st>>>(mx, mb, A,
                                                            use_tma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = (A.p * A.n + kPassThreads - 1) / kPassThreads;
  ssd_state_pass<<<batch * A.h * per, kPassThreads, 0, st>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int scan_blocks =
      batch * A.nc * ptiles * A.g * hblocks * (A.q / 64);
  ssd_chunk_scan<<<scan_blocks, kScanThreads, ScanSmem::kBytes, st>>>(
      mx, mb, mc, mhi, mlo, A, use_tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked

}  // namespace

// The workspace the chunk-parallel bf16 path needs, in bytes.
extern "C" long long ssd_scan_workspace_bytes(int batch, int len, int h,
                                              int p, int n, int chunk) {
  const int q = chunked::kernel_chunk(chunk);
  return static_cast<long long>(
      chunked::layout(batch, (len + q - 1) / q, h, p, n, q).total);
}

// x, y: (B, L, H, P); dt: (B, L, H); a, d: (H,); b, c: (B, L, G, N);
// init_state, final_state: (B, H, P, N).  All contiguous; x, b, c and y
// float32 or (bf16 != 0) bfloat16, the rest float32; d, init_state and
// final_state may be null.  H a multiple of G, 1 <= N <= 128.  final_state
// may alias init_state.  With bf16 and a workspace of
// ssd_scan_workspace_bytes(...) bytes, the chunk-parallel path runs (three
// launches, `chunk` the caller's); without one, the single-launch kernel.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* d,
                            const void* init_state, void* y,
                            void* final_state, int bf16, int batch, int len,
                            int h, int p, int g, int n, int chunk,
                            void* workspace, long long workspace_bytes,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || h == 0 || p == 0) return 0;
  if (bf16 && workspace != nullptr) {
    chunked::ChunkArgs A;
    A.x = static_cast<const __nv_bfloat16*>(x);
    A.dt = static_cast<const float*>(dt);
    A.a = static_cast<const float*>(a);
    A.b = static_cast<const __nv_bfloat16*>(b);
    A.c = static_cast<const __nv_bfloat16*>(c);
    A.d = static_cast<const float*>(d);
    A.init_state = static_cast<const float*>(init_state);
    A.y = static_cast<__nv_bfloat16*>(y);
    A.final_state = static_cast<float*>(final_state);
    A.len = len; A.h = h; A.p = p; A.g = g; A.n = n;
    return chunked::launch(A, batch, chunk, workspace, workspace_bytes, st);
  }
  SsdArgs args;
  args.x = x;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.b = b;
  args.c = c;
  args.d = static_cast<const float*>(d);
  args.init_state = static_cast<const float*>(init_state);
  args.y = y;
  args.final_state = static_cast<float*>(final_state);
  args.len = len; args.h = h; args.p = p; args.g = g; args.n = n;
  return bf16 ? dispatch<__nv_bfloat16>(args, batch, st)
              : dispatch<float>(args, batch, st);
}
