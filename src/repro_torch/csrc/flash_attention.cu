// Blocked online-softmax (flash) attention over grouped-query heads, with
// causal, sliding-window and q_offset masks.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel).
//
// Semantics, per (batch b, query head h, query row i): the key head is
// h / (H / HKV), read in place (K and V are never repeated); qpos =
// q_offset + i; key j is visible iff j < Skv, j <= qpos when causal, and
// j > qpos - window when a window is given.  Scores s = (q . k) * scale in
// float32; a masked score is the finite sentinel -1e30, as in the TPU
// kernel.  Over the KV tiles the online softmax keeps a running max m, sum
// l and accumulator acc: m' = max(m, max s), p = exp(s - m'),
// l = l * exp(m - m') + sum p, acc = acc * exp(m - m') + p . v.  The
// output is acc / l, rounded once to the input type.
//
// A row that sees no key at all keeps m = -1e30, so every entry of it
// weighs exp(0) = 1, padding included: the TPU kernel returns
// sum(v[:Skv]) / Skv_padded there, Skv_padded being its KV length rounded
// up to its KV block.  The wrapper passes that divisor as l_masked; this
// kernel sums v over every key of such a row and divides by l_masked.
//
// What bounds it on the H100: causal prefill at qwen2-1.5b's shapes does
// 4 B H D (visible pairs) = about 0.1 TFLOP a layer against 59 MB of q, k,
// v and o, far above the card's 295 FLOP/byte ridge, so operations bound
// it (the bf16 tensor cores' 989 TFLOP/s).  This first kernel computes in
// float32 on the CUDA cores instead: one block of 256 threads per (64
// query rows, b * H) stages its query tile, then each 64-key K/V tile,
// through shared memory as float32; each thread owns a 4 x 4 patch of the
// score tile and 4 rows x D/16 columns of the accumulator, in registers;
// a row's max and sum are reduced over its 16 threads with warp shuffles.
// KV tiles that every row of a block masks are skipped (causal: right of
// the diagonal; window: left of the band), except in a block holding a row
// that sees no key, which must sum v over all of them.  bf16 wgmma with
// TMA-fed tiles is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 64;        // keys of a KV tile
constexpr int kThreads = 256;  // 16 x 16: ty owns rows ty + 16 i, tx columns tx + 16 j
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct FlashArgs {
  const void* q;  // (B, H, Sq, D)
  const void* k;  // (B, HKV, Skv, D)
  const void* v;  // (B, HKV, Skv, D)
  void* o;        // (B, H, Sq, D)
  int h, hkv, sq, skv, d;
  float scale;
  int causal, has_window, window, q_offset;
  float l_masked;
};

// Shared-memory layout for head dims up to DP (a multiple of 16), in floats.
template <int DP>
struct Smem {
  static constexpr int kStride = DP + 1;  // odd row stride: no bank conflicts
  static constexpr int kQ = kBQ * kStride;
  // K's tile, reused for the probabilities once the scores are in registers
  static constexpr int kKP = kBK * kStride > kBQ * (kBK + 1)
                                 ? kBK * kStride : kBQ * (kBK + 1);
  static constexpr int kV = kBK * DP;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKP + kV);
};

// Rows [row0, row0 + 64) of a (rows, d) matrix into a 64 x DP float tile
// with row stride `stride`, zero past the last row and past column d.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* src, int row0, int rows,
                                          int d) {
  for (int idx = threadIdx.x; idx < 64 * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    float val = 0.f;
    if (row0 + r < rows && c < d) val = load_f(src + (size_t)(row0 + r) * d + c);
    dst[r * stride + c] = val;
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(FlashArgs a) {
  constexpr int DP = 16 * NJ;
  using S = Smem<DP>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + S::kQ;
  float* ps = ks;
  float* vs = ks + S::kKP;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int bh = blockIdx.y;
  const int b = bh / a.h, kvh = (bh % a.h) / (a.h / a.hkv);
  const int q0 = qt * kBQ;
  const T* qg = static_cast<const T*>(a.q) + (size_t)bh * a.sq * a.d;
  const size_t kv_off = (size_t)(b * a.hkv + kvh) * a.skv * a.d;
  const T* kg = static_cast<const T*>(a.k) + kv_off;
  const T* vg = static_cast<const T*>(a.v) + kv_off;
  T* og = static_cast<T*>(a.o) + (size_t)bh * a.sq * a.d;

  load_tile<T, DP>(qs, S::kStride, qg, q0, a.sq, a.d);

  // The KV tiles some row of this block sees.  A row sees no key iff
  // qpos - window >= Skv - 1 (only with a window); a block holding one
  // visits every tile, so that the row sums v over all keys.
  const int n_kt = (a.skv + kBK - 1) / kBK;
  const int qa = a.q_offset + q0;
  const int qb = a.q_offset + min(q0 + kBQ, a.sq) - 1;
  int kt_lo = 0, kt_hi = n_kt;
  if (!(a.has_window && qb - a.window >= a.skv - 1)) {
    if (a.causal) kt_hi = min(n_kt, qb / kBK + 1);
    if (a.has_window) kt_lo = max(0, (qa - a.window + 1) / kBK);
  }

  float m[4], l[4], acc[4][NJ];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qpos[i] = qa + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();  // the last tile's P and V reads are done
    const int k0 = kt * kBK;
    load_tile<T, DP>(ks, S::kStride, kg, k0, a.skv, a.d);
    load_tile<T, DP>(vs, DP, vg, k0, a.skv, a.d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < a.d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * S::kStride + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * S::kStride + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool vis = kpos < a.skv;
        if (a.causal) vis = vis && kpos <= qpos[i];
        if (a.has_window) vis = vis && kpos > qpos[i] - a.window;
        s[i][j] = vis ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading K: P takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.sq) continue;
    const float li = m[i] == kNegInf ? a.l_masked : l[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < a.d) store_f(og + (size_t)r * a.d + c, acc[i][j] / li);
    }
  }
}

template <typename T, int NJ>
int launch(const FlashArgs& a, int b, cudaStream_t st) {
  const size_t bytes = Smem<16 * NJ>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + kBQ - 1) / kBQ, b * a.h);
  flash_kernel<T, NJ><<<grid, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const FlashArgs& a, int b, cudaStream_t st) {
  if (a.d <= 16) return launch<T, 1>(a, b, st);
  if (a.d <= 32) return launch<T, 2>(a, b, st);
  if (a.d <= 64) return launch<T, 4>(a, b, st);
  return launch<T, 8>(a, b, st);
}

}  // namespace

// q, o: (B, H, Sq, D); k, v: (B, HKV, Skv, D); all contiguous, float32 or
// (bf16 != 0) bfloat16; 1 <= D <= 128, H a multiple of HKV, Skv >= 1.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int bf16, int b,
                                   int h, int hkv, int sq, int skv, int d,
                                   float scale, int causal, int has_window,
                                   int window, int q_offset, float l_masked,
                                   void* stream) {
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.h = h; a.hkv = hkv; a.sq = sq; a.skv = skv; a.d = d;
  a.scale = scale;
  a.causal = causal; a.has_window = has_window; a.window = window;
  a.q_offset = q_offset;
  a.l_masked = l_masked;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sq == 0 || b == 0 || h == 0) return 0;
  return bf16 ? dispatch<__nv_bfloat16>(a, b, st) : dispatch<float>(a, b, st);
}
