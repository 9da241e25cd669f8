// Mamba-2 SSD (state-space duality) chunked scan, with an optional
// initial state in and the final state out.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:ssd_scan
// (_ssd_kernel), and computes what the JAX package's pure-jnp
// models/mamba2.py:ssd_chunked computes.
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
// to x's type; the final state stays float32.
//
// The chunk: the reference's chunk (256 at mamba2-2.7b) does not fit in
// shared memory as float32 (a 256 x 128 tile of B or C alone is 128 KB), so
// this kernel walks the sequence in tiles of kT = 64 positions whatever the
// caller's chunk, carrying the state from tile to tile.  The decomposition
// is exact for any chunk length (the state at a tile's end is the
// recurrence's state there), so a tile other than the chunk changes only the
// order of the float32 sums, not the function.
//
// What bounds it on the H100: at mamba2-2.7b's prefill (x 2 x 4096 x 80 x 64
// bf16, N 128) it moves about 180 MB of operands, 0.054 ms at 3.35 TB/s,
// and needs about 33 GFLOP (C B^T once per B/C group), 0.033 ms on the bf16
// tensor cores' 989 TFLOP/s: bytes bound it, though the reference's
// chunked algorithm, forming C B^T for every head, does about 54 GFLOP.
// This first kernel computes in float32 on the CUDA cores: one block of 256
// threads per (batch, head, 64 columns of P) loops over the tiles in order,
// the state in registers (each thread owns 4 rows of P x N/16 columns) and
// mirrored in shared memory for the C S^T product; a tile's B, C, x and its
// masked decay-weighted C B^T live in shared memory as float32.  Each
// thread owns a 4 x 4 patch (rows 4 ty + i, columns tx + 16 j) of the
// C B^T tile and of the output tile; a warp skips the columns right of its
// rows' diagonal, and the rows past the sequence's end.  Sharing C B^T
// across the heads of a group, bf16 wgmma and TMA-fed tiles are the next
// steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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

}  // namespace

// x, y: (B, L, H, P); dt: (B, L, H); a, d: (H,); b, c: (B, L, G, N);
// init_state, final_state: (B, H, P, N).  All contiguous; x, b, c and y
// float32 or (bf16 != 0) bfloat16, the rest float32; d, init_state and
// final_state may be null.  H a multiple of G, 1 <= N <= 128.  final_state
// may alias init_state (each block reads its rows of the state before it
// writes them).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* d,
                            const void* init_state, void* y,
                            void* final_state, int bf16, int batch, int len,
                            int h, int p, int g, int n, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || h == 0 || p == 0) return 0;
  return bf16 ? dispatch<__nv_bfloat16>(args, batch, st)
              : dispatch<float>(args, batch, st);
}
