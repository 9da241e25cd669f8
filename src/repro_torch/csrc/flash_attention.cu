// Blocked online-softmax (flash) attention over grouped-query heads, with
// causal, sliding-window and q_offset masks.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel, pallas_call at :107).
//
// Semantics, per (batch b, query head h, query row i): the key head is
// h / (H / HKV), read in place (K and V are never repeated); qpos =
// q_offset + i; key j is visible iff j < Skv, j <= qpos when causal, and
// j > qpos - window when a window is given.  Scores s = (q . k) * scale in
// float32; a masked score is the finite sentinel -1e30, as in the TPU
// kernel.  Over 128-key tiles the online softmax keeps a running max m,
// sum l and accumulator acc: m' = max(m, max s), p = exp(s - m'),
// l = l * exp(m - m') + sum p, acc = acc * exp(m - m') + p . v.  The
// output is acc / l, rounded once to the input type.
//
// A row that sees no key at all keeps m = -1e30, so every entry of it
// weighs exp(0) = 1, padding included: the TPU kernel returns
// sum(v[:Skv]) / Skv_padded there, Skv_padded being its KV length rounded
// up to its KV block.  The wrapper passes that divisor as l_masked; the
// kernels sum v over every key of such a row and divide by l_masked.
//
// What bounds it on the H100: causal prefill does 4 B H D FLOP per
// visible (query, key) pair, about 0.1 TFLOP a layer at qwen2-1.5b's
// shapes against 59 MB of q, k, v and o, far above the card's 295
// FLOP/byte ridge, so operations bound it: the bf16 tensor cores' 989
// TFLOP/s.
//
// bfloat16: a Hopper kernel on the tensor cores (flash_bf16_kernel).
// - Grid (B * H, ceil(Sq / 128)); the query tile index runs backwards
//   along y, so the blocks with the longest causal rows of every head
//   start first and the short ones fill the tail.  A block of 384
//   threads takes 128 query rows of one (b, h): two consumer warpgroups
//   of 64 rows each, and a producer warpgroup of which one warp issues
//   the copies.  setmaxnreg gives the producers 24 registers a thread and
//   the consumers 240 (a launch of 384 threads starts with 168).
// - Shared memory: the Q tile (128 x 128 bf16, 32 KB, loaded once) and a
//   ring of two stages of K and V tiles (128 keys x 128 bf16 each), 160
//   KB in all.  Every tile is two boxes of 128 rows x 64 columns (128
//   bytes) in the 128-byte swizzle that wgmma's shared-memory descriptors
//   read.  The producer fills them with TMA (cp.async.bulk.tensor, 3-D
//   maps (D, S, B*H) from cuTensorMapEncodeTiled): columns past D and
//   rows past Sq or Skv arrive as zeros, so D = 120 takes the same path.
//   A head dim that is not a multiple of 8 (or a base address that is
//   not 16-byte aligned) cannot be a TMA map; the producer warp then
//   writes the same swizzled tiles with plain loads.  Each tile completes
//   on an mbarrier; the consumers release a stage's K once S is done and
//   its V once P.V is done, and the producer refills it.
// - S = Q K^T: 8 wgmma m64n128k16 (bf16 -> float32, both operands
//   K-major from shared memory), then * scale in float32.  The masks
//   and the sentinel are applied only on tiles that cross the causal
//   diagonal, the window's edge or Skv.  Tiles that every row of the
//   block masks are skipped (causal: right of the diagonal; window: left
//   of the band), except in a block holding a row that sees no key,
//   which must sum v over all of them.
// - The online softmax runs on the accumulator fragments: each thread
//   holds two rows, a row's max and sum are reduced over the 4 threads
//   of its quad, m, l and the rescale of acc stay in float32.
// - O += P V with P from registers (wgmma with A in registers, B = V in
//   shared memory, MN-major: the transpose bit).  P is split into two
//   bf16 halves, hi = bf16(p) and lo = bf16(p - hi): one bf16 P alone
//   carries a relative error of 2^-9 into every output, which misses the
//   plain version (float32 p) by up to ~200 times one bf16 ulp where
//   outputs cancel towards 0; hi + lo carries 2^-17, within one ulp.  It
//   costs 1.5 times the plain FLOPs: Q K^T once, P V twice.  Both halves
//   go into one float32 accumulator per tile, which is then added as the
//   plain version adds it, acc = acc * corr + pv, rounded to nearest: the
//   tensor cores truncate each step's float32 sum, and into one running
//   accumulator over thousands of keys that error reaches ~2x the bf16
//   allowance where outputs cancel; over one tile it stays far below.
// - Epilogue: acc / l (or / l_masked for a row that sees no key), rounded
//   once to bf16; rows past Sq and columns past D are not stored.
// Left for later: two consumer warpgroups ping-ponging softmax against
// wgmma, a persistent grid, and a finer causal load balance.
//
// float32: the first kernel of this port, on the CUDA cores
// (flash_f32_kernel): one block of 256 threads per (64 query rows, b * H)
// stages its query tile, then each 64-key K/V tile, through shared memory
// as float32; each thread owns a 4 x 4 patch of the score tile and 4 rows
// x D/16 columns of the accumulator, in registers; a row's max and sum
// are reduced over its 16 threads with warp shuffles.  It skips tiles as
// the bf16 kernel does.  No model path calls it; it keeps float32 inputs
// exact to 2e-5.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

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

// The KV tiles of `bk` keys that some row in [qa, qb] (absolute query
// positions) sees, as [*lo, *hi).  A row sees no key iff qpos - window >=
// Skv - 1 (only with a window); a block holding one visits every tile.
__device__ __forceinline__ void kv_tile_range(const FlashArgs& a, int qa,
                                              int qb, int bk, int* lo,
                                              int* hi) {
  const int n_kt = (a.skv + bk - 1) / bk;
  *lo = 0;
  *hi = n_kt;
  if (!(a.has_window && qb - a.window >= a.skv - 1)) {
    if (a.causal) *hi = min(n_kt, qb / bk + 1);
    if (a.has_window) *lo = max(0, (qa - a.window + 1) / bk);
  }
}

// ------------------------------------------------ float32: CUDA cores

namespace f32 {

constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 64;        // keys of a KV tile
constexpr int kThreads = 256;  // 16 x 16: ty owns rows ty + 16 i, tx columns tx + 16 j

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
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src, int row0,
                                          int rows, int d) {
  for (int idx = threadIdx.x; idx < 64 * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    float val = 0.f;
    if (row0 + r < rows && c < d) val = src[(size_t)(row0 + r) * d + c];
    dst[r * stride + c] = val;
  }
}

template <int NJ>
__global__ void __launch_bounds__(kThreads, 2) flash_f32_kernel(FlashArgs a) {
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
  const float* qg = static_cast<const float*>(a.q) + (size_t)bh * a.sq * a.d;
  const size_t kv_off = (size_t)(b * a.hkv + kvh) * a.skv * a.d;
  const float* kg = static_cast<const float*>(a.k) + kv_off;
  const float* vg = static_cast<const float*>(a.v) + kv_off;
  float* og = static_cast<float*>(a.o) + (size_t)bh * a.sq * a.d;

  load_tile<DP>(qs, S::kStride, qg, q0, a.sq, a.d);

  const int qa = a.q_offset + q0;
  const int qb = a.q_offset + min(q0 + kBQ, a.sq) - 1;
  int kt_lo, kt_hi;
  kv_tile_range(a, qa, qb, kBK, &kt_lo, &kt_hi);

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
    load_tile<DP>(ks, S::kStride, kg, k0, a.skv, a.d);
    load_tile<DP>(vs, DP, vg, k0, a.skv, a.d);
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
      if (c < a.d) og[(size_t)r * a.d + c] = acc[i][j] / li;
    }
  }
}

template <int NJ>
int launch(const FlashArgs& a, int b, cudaStream_t st) {
  const size_t bytes = Smem<16 * NJ>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + kBQ - 1) / kBQ, b * a.h);
  flash_f32_kernel<NJ><<<grid, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const FlashArgs& a, int b, cudaStream_t st) {
  if (a.d <= 16) return launch<1>(a, b, st);
  if (a.d <= 32) return launch<2>(a, b, st);
  if (a.d <= 64) return launch<4>(a, b, st);
  return launch<8>(a, b, st);
}

}  // namespace f32

// ------------------------------------ bfloat16: wgmma, TMA, mbarriers

namespace hopper {

using namespace sm90;

constexpr int kBQ = 128;                 // query rows of a block
constexpr int kBK = 128;                 // keys of a KV tile
constexpr int kBox = 64;                 // bf16 columns of one 128-byte box
constexpr int kBoxBytes = 128 * 128;     // 128 rows of 128 bytes
constexpr int kTileBytes = 2 * kBoxBytes;  // 128 rows x 128 columns
constexpr int kStages = 2;
constexpr int kConsumers = 256;          // two warpgroups
// and a producer warpgroup, of which one warp works: setmaxnreg moves
// registers between whole warpgroups
constexpr int kThreads = kConsumers + 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// Q, then K of each stage, then V of each stage; 1 KB to align the base.
constexpr size_t kSmemBytes = (1 + 2 * kStages) * kTileBytes + 1024;

// mbarriers: Q full, K full x2, V full x2, K empty x2, V empty x2
enum { kBarQ = 0, kBarK = 1, kBarV = 3, kBarKFree = 5, kBarVFree = 7,
       kBars = 9 };

// Byte offset of element (r, c) of a 128 x 128 tile in the layout TMA's
// 128-byte swizzle writes: two boxes of 64 columns, 128-byte rows, the
// 16-byte chunk index XORed with the row's index within its 8-row group.
__device__ __forceinline__ int swizzled(int r, int c) {
  return (c >> 6) * kBoxBytes + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4)
         + (c & 7) * 2;
}

// The plain-load producer: rows [row0, row0 + 128) of a (rows, d) matrix
// into a swizzled tile, zero past the last row and past column d, then
// made visible to wgmma's (async) proxy.
__device__ __forceinline__ void fill_tile(uint8_t* tile,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int d, int lane) {
  for (int idx = lane; idx < 128 * 128; idx += 32) {
    const int r = idx >> 7, c = idx & 127;
    __nv_bfloat16 val = __float2bfloat16_rn(0.f);
    if (row0 + r < rows && c < d) val = src[(size_t)(row0 + r) * d + c];
    *reinterpret_cast<__nv_bfloat16*>(tile + swizzled(r, c)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, FlashArgs a,
                  int use_tma) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[kBars];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t q_tile = base;
  auto k_tile = [&](int s) { return base + (1 + s) * kTileBytes; };
  auto v_tile = [&](int s) { return base + (1 + kStages + s) * kTileBytes; };
  auto bar = [&](int i) { return smem_u32(&bars[i]); };

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest rows first
  const int b = bh / a.h, kvh = (bh % a.h) / (a.h / a.hkv);
  const int kv_bh = b * a.hkv + kvh;
  const int q0 = qt * kBQ;
  const int qa = a.q_offset + q0;
  const int qb = a.q_offset + min(q0 + kBQ, a.sq) - 1;
  int kt_lo, kt_hi;
  kv_tile_range(a, qa, qb, kBK, &kt_lo, &kt_hi);
  const int n_tiles = kt_hi - kt_lo;

  if (threadIdx.x == 0) {
    mbar_init(bar(kBarQ), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(kBarK + s), 1);
      mbar_init(bar(kBarV + s), 1);
      mbar_init(bar(kBarKFree + s), kConsumers);
      mbar_init(bar(kBarVFree + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= kConsumers / 32) {
    // ---------------------------------------------------- the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (warp > kConsumers / 32) return;
    if (use_tma) {
      if (lane != 0) return;
      mbar_expect_tx(bar(kBarQ), kTileBytes);
      tma_load(q_tile, &map_q, bar(kBarQ), 0, q0, bh);
      tma_load(q_tile + kBoxBytes, &map_q, bar(kBarQ), kBox, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j & 1;
        const uint32_t free_parity = ((j >> 1) & 1) ^ 1;
        const int k0 = (kt_lo + j) * kBK;
        mbar_wait(bar(kBarKFree + s), free_parity);
        mbar_expect_tx(bar(kBarK + s), kTileBytes);
        tma_load(k_tile(s), &map_k, bar(kBarK + s), 0, k0, kv_bh);
        tma_load(k_tile(s) + kBoxBytes, &map_k, bar(kBarK + s), kBox, k0,
                 kv_bh);
        mbar_wait(bar(kBarVFree + s), free_parity);
        mbar_expect_tx(bar(kBarV + s), kTileBytes);
        tma_load(v_tile(s), &map_v, bar(kBarV + s), 0, k0, kv_bh);
        tma_load(v_tile(s) + kBoxBytes, &map_v, bar(kBarV + s), kBox, k0,
                 kv_bh);
      }
    } else {
      const auto* qg = static_cast<const __nv_bfloat16*>(a.q)
                       + (size_t)bh * a.sq * a.d;
      const size_t kv_off = (size_t)kv_bh * a.skv * a.d;
      const auto* kg = static_cast<const __nv_bfloat16*>(a.k) + kv_off;
      const auto* vg = static_cast<const __nv_bfloat16*>(a.v) + kv_off;
      fill_tile(base_ptr, qg, q0, a.sq, a.d, lane);
      if (lane == 0) mbar_arrive(bar(kBarQ));
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j & 1;
        const uint32_t free_parity = ((j >> 1) & 1) ^ 1;
        const int k0 = (kt_lo + j) * kBK;
        mbar_wait(bar(kBarKFree + s), free_parity);
        fill_tile(base_ptr + (1 + s) * kTileBytes, kg, k0, a.skv, a.d, lane);
        if (lane == 0) mbar_arrive(bar(kBarK + s));
        mbar_wait(bar(kBarVFree + s), free_parity);
        fill_tile(base_ptr + (1 + kStages + s) * kTileBytes, vg, k0, a.skv,
                  a.d, lane);
        if (lane == 0) mbar_arrive(bar(kBarV + s));
      }
    }
  } else {
    // ------------------------------------------------------ the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    // Warpgroup wg owns rows [64 wg, 64 wg + 64) of the block; a thread
    // holds rows g and g + 8 of its warp's 16 (the wgmma fragment layout),
    // and of each 8 columns the pair 2 (lane % 4), + 1.
    const int wg = warp >> 2;
    const int g = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int qpos0 = qa + g, qpos1 = qpos0 + 8;
    const int qa_wg = qa + wg * 64, qb_wg = qa_wg + 63;
    const int col0 = 2 * (lane & 3);
    const uint32_t q_rows = q_tile + wg * 64 * 128;

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar(kBarQ), 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j & 1;
      const uint32_t parity = (j >> 1) & 1;
      const int k0 = (kt_lo + j) * kBK;

      // S = Q K^T over D in 8 steps of 16: 4 within each 64-column box
      float sc[64];
      mbar_wait(bar(kBarK + s), parity);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
        wgmma_ss(sc, sw128_desc(q_rows + off, 16, 1024),
                 sw128_desc(k_tile(s) + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      mbar_arrive(bar(kBarKFree + s));

      const bool masked = k0 + kBK > a.skv || (a.causal && k0 + kBK - 1 > qa_wg)
                          || (a.has_window && k0 <= qb_wg - a.window);
      if (masked) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          bool vis = kpos < a.skv;
          if (a.causal) vis = vis && kpos <= qpos;
          if (a.has_window) vis = vis && kpos > qpos - a.window;
          sc[i] = vis ? sc[i] * a.scale : kNegInf;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= a.scale;
      }

      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, sc[i]);
        else mx0 = fmaxf(mx0, sc[i]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (i & 2) {
          sc[i] = expf(sc[i] - mn1);
          sum1 += sc[i];
        } else {
          sc[i] = expf(sc[i] - mn0);
          sum0 += sc[i];
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
      m0 = mn0;
      m1 = mn1;

      // P as A fragments of 16 keys each, in two bf16 halves: the scores'
      // pairs (8 kk + 2 r, + 1) are rows g / g + 8 and keys 16 kk + col0
      // (r = 0, 1) and 16 kk + 8 + col0 (r = 2, 3).
      uint32_t hi[8][4], lo[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = sc[8 * kk + 2 * r], y = sc[8 * kk + 2 * r + 1];
          const float hx = __bfloat162float(__float2bfloat16_rn(x));
          const float hy = __bfloat162float(__float2bfloat16_rn(y));
          hi[kk][r] = pack_bf16(hx, hy);
          lo[kk][r] = pack_bf16(x - hx, y - hy);
        }
      }

      // pv = P V over the tile's keys in 8 steps of 16 (16 rows of V, 2 KB),
      // into an accumulator of its own: the tensor cores add in float32 but
      // truncate each step's sum, an error that grows with the magnitude
      // they add to.  Over one tile it stays far below the tolerance; the
      // tiles are summed as the plain version sums them, acc = acc * corr +
      // pv in float32 with rounding to nearest.  (A running accumulator over
      // 4096 keys drifts to ~2x the bf16 allowance where outputs cancel.)
      float pv[64];
      mbar_wait(bar(kBarV + s), parity);
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t dv = sw128_desc(v_tile(s) + kk * 16 * 128, kBoxBytes,
                                       1024);
        wgmma_rs(pv, hi[kk], dv, kk > 0);
        wgmma_rs(pv, lo[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pv);
      mbar_arrive(bar(kBarVFree + s));
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[i] = acc[i] * ((i & 2) ? corr1 : corr0) + pv[i];
    }

    const float li0 = m0 == kNegInf ? a.l_masked : l0;
    const float li1 = m1 == kNegInf ? a.l_masked : l1;
    auto* og = static_cast<__nv_bfloat16*>(a.o) + (size_t)bh * a.sq * a.d;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + g + 8 * half;
      if (row >= a.sq) continue;
      const float li = half ? li1 : li0;
      __nv_bfloat16* orow = og + (size_t)row * a.d;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int c = 8 * jn + col0;
        const float x = acc[4 * jn + 2 * half] / li;
        const float y = acc[4 * jn + 2 * half + 1] / li;
        if (a.d % 2 == 0) {
          if (c < a.d)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(x, y);
        } else {
          if (c < a.d) orow[c] = __float2bfloat16_rn(x);
          if (c + 1 < a.d) orow[c + 1] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

// A 3-D map of a contiguous (planes, rows, d) bf16 tensor, read in boxes
// of 64 columns x 128 rows x 1 plane with the 128-byte swizzle; elements
// outside the tensor read as zero.
int encode_map(CUtensorMap* map, const void* ptr, int d, int rows,
               int planes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(d) * 2 * rows};
  const cuuint32_t box[3] = {kBox, kBK, 1};
  return encode_bf16_map(map, ptr, 3, dims, strides, box);
}

int launch(const FlashArgs& a, int b, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  std::memset(&mq, 0, sizeof(mq));
  std::memset(&mk, 0, sizeof(mk));
  std::memset(&mv, 0, sizeof(mv));
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int use_tma =
      a.d % 8 == 0 && aligned(a.q) && aligned(a.k) && aligned(a.v);
  if (use_tma) {
    int err = encode_map(&mq, a.q, a.d, a.sq, b * a.h);
    if (err == 0) err = encode_map(&mk, a.k, a.d, a.skv, b * a.hkv);
    if (err == 0) err = encode_map(&mv, a.v, a.d, a.skv, b * a.hkv);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * a.h, (a.sq + kBQ - 1) / kBQ);
  flash_bf16_kernel<<<grid, kThreads, kSmemBytes, st>>>(mq, mk, mv, a,
                                                        use_tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

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
  return bf16 ? hopper::launch(a, b, st) : f32::dispatch(a, b, st);
}
