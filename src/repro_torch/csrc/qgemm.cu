// int8 GEMM + bias + requantize: the FC stage of the int8 CNN path.
//
// Replaces the Pallas kernel src/repro/kernels/qgemm.py:qgemm
// (_qgemm_kernel, pallas_call at :99):
//   y[m, n] = clip(relu(round_shift(sum_k x[m, k] * w[k, n] + b[n], s[n])))
// with x (M, K) int8, w (K, N) int8, b (N,) int32, s a scalar or a
// per-column int32 vector, y (M, N) int8, all row-major.
//
// What bounds it on the H100: the CNN serves small batches (M = 1..8),
// so each weight byte is used M times, far below the ~590 int8 operations
// per byte at which the tensor cores, not the 3.35 TB/s of HBM, become the
// limit.  The kernel is bound by reading w once (VGG-16's fc6 alone is
// 103 MB), so the design keeps weight bytes in flight on every SM and
// does nothing per byte but hand it to the tensor cores:
// * swap-AB on the int8 tensor cores: a block computes a tile of y
//   transposed, (BN output columns) x (NW rows of x), as
//   wgmma.m64nNWk32.s32.s8.s8 with A = BN rows of the weight staged
//   K-major once per layer ((N, K_pad), kernels/qgemm.py:stage_kmajor;
//   int8 wgmma takes only K-major operands) and B = NW rows of x, K-major
//   as they stand, NW = 8, 16 or 32 (rows past M read as zero); larger M
//   tiles M over gridDim.y.  One warpgroup per 64 output columns.
// * one producer warp issues TMA loads of both operands, in the 128-byte
//   swizzle the wgmma descriptors name, into a ring of kStages mbarrier
//   stages (64 KB of weight in flight a block at BN = 128); the consumer
//   warpgroups release a stage through an "empty" mbarrier, so nothing
//   waits on __syncthreads in the main loop.  The weight, read once, goes
//   through L2 under the evict-first policy: it displaces (and writes
//   back) little of what L2 holds.  The tile's biases and shifts load
//   while the ring fills.
// * K is split over the blocks of one thread-block cluster (gridDim.z, at
//   most 8) so that the grid fills the card in one wave
//   (kernels/qgemm.py:plan).  Each block stages its int32 sums in its
//   shared memory; each then adds the others' sums over its share of the
//   tile through distributed shared memory and applies requant.cuh's
//   requant with bias and shift, in the same launch: no scratch, no
//   atomics, no second kernel.  Integer sums are exact in any order.
// Ragged edges: TMA reads zeros past N, M and K; stores are masked.
//
// The trial form (`trials` > 1) is what the JAX package's qgemm becomes
// under jax.vmap in an SER campaign (src/repro/core/ser.py:315): trial t
// multiplies its own M rows of x, rows [t*M, (t+1)*M), by its own weight
// image, rows [t*N, (t+1)*N) of a K-major stack (T*N, K_pad), with the
// biases and shifts the trials share.  The trial rides gridDim.y beside
// the trial's M tiles, so a tile, and the K splits of its cluster, never
// mix two trials.  Rows a box reads past a trial's M or N belong to the
// next trial (or read as zero past the last): their sums are computed
// and never stored.  At batch 1 each trial's weight is read once, T
// times the bytes of one call (VGG-16's fc6 at T = 32: 3.3 GB).
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "requant.cuh"

namespace {

using namespace sm90;

constexpr int kBK = 128;        // K bytes a stage: one 128-byte swizzle row
constexpr int kMaxSplits = 8;   // K splits of a tile: one portable cluster

template <int BN, int NW>
struct Tile {
  static constexpr int kConsumers = BN / 64;            // warpgroups
  static constexpr int kProducerWarp = 4 * kConsumers;  // the warp after them
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kStages = BN == 128 ? 4 : 6;
  static constexpr int kATile = BN * kBK;
  static constexpr int kBTile = NW * kBK;
  static constexpr int kStage = kATile + kBTile;
  static constexpr int kAcc = NW / 2;  // int32 sums a consumer thread
  static constexpr int kLd = BN + 4;   // words a row of the staged sums
  static constexpr size_t kSmem = kStages * kStage + 1024;  // + alignment
  static_assert(NW * kLd * 4 <= kStages * kStage,
                "the sums tile must fit the drained ring");
};

struct GemmArgs {
  const int32_t* bias;       // (N,) or null
  const int32_t* shift_vec;  // (N,) per-column shifts, or null: `shift`
  int8_t* y;                 // (M, N)
  int m, n, k_tiles, splits, chunk, shift, relu;
  int m_tiles;               // tiles of a trial's M rows
  int wide;                  // N % 4 == 0 and y 4-byte aligned
};

template <int BN, int NW>
__global__ void __launch_bounds__(Tile<BN, NW>::kThreads)
qgemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_x, GemmArgs a) {
  using T = Tile<BN, NW>;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full_bar[kStages], empty_bar[kStages];
  __shared__ int32_t s_bias[BN], s_shift[BN];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  uint8_t* const base_ptr = smem_raw + (base - raw);
  auto a_tile = [&](int s) { return base + s * T::kStage; };
  auto b_tile = [&](int s) { return base + s * T::kStage + T::kATile; };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int trial = blockIdx.y / a.m_tiles;
  const int n0 = blockIdx.x * BN, m0 = (blockIdx.y - trial * a.m_tiles) * NW;
  const int x_row0 = trial * a.m + m0;  // the tile's rows of x, of y
  const int w_row0 = trial * a.n + n0;  // and of the weight stack
  const int split = blockIdx.z;  // the block's rank in its cluster
  const int kt0 = split * a.chunk;
  const int n_k = min(a.chunk, a.k_tiles - kt0);

  if (warp == T::kProducerWarp && lane == 0) {
    prefetch_map(&map_w);
    prefetch_map(&map_x);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), 4 * T::kConsumers);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int32_t acc[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0;
  // the tile's biases and shifts load while the ring fills; they go to
  // shared memory after the main loop, so that the epilogue makes no trip
  // to global memory
  int32_t my_bias = 0, my_shift = a.shift;
  if (tid < BN && n0 + tid < a.n) {
    if (a.bias != nullptr) my_bias = a.bias[n0 + tid];
    if (a.shift_vec != nullptr) my_shift = a.shift_vec[n0 + tid];
  }

  if (warp == T::kProducerWarp) {
    // K step j into stage j % kStages once the consumers have released
    // its previous use; the weight, read once, under the evict-first L2
    // policy so that it streams through L2 without pushing out the rest
    if (lane == 0) {
      const uint64_t once = evict_first_policy();
      for (int j = 0; j < n_k; ++j) {
        const int s = j % kStages;
        if (j >= kStages)
          mbar_wait(smem_u32(&empty_bar[s]), ((j / kStages) - 1) & 1);
        const uint32_t bar = smem_u32(&full_bar[s]);
        mbar_expect_tx(bar, T::kStage);
        tma_load_policy(a_tile(s), &map_w, bar, (kt0 + j) * kBK, w_row0,
                        once);
        tma_load(b_tile(s), &map_x, bar, (kt0 + j) * kBK, x_row0);
      }
    }
    __syncwarp();
  } else {
    const int wg = warp >> 2;
    for (int j = 0; j < n_k; ++j) {
      const int s = j % kStages;
      mbar_wait(smem_u32(&full_bar[s]), (j / kStages) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_s8(acc,
                 sw128_desc(a_tile(s) + wg * 64 * kBK + kk * 32, 16, 1024),
                 sw128_desc(b_tile(s) + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));
    }
  }

  // every stage is consumed: the ring holds the sums tile (NW, kLd), row
  // r for x row m0 + r, in the fragment layout (a thread holds output
  // columns c and c + 8 of its warp's 16, and of each 8 rows of x the
  // pair 2 (lane % 4), + 1)
  __syncthreads();
  int32_t* const sums = reinterpret_cast<int32_t*>(base_ptr);
  if (tid < BN) {
    s_bias[tid] = my_bias;
    s_shift[tid] = my_shift;
  }
  if (warp < T::kProducerWarp) {
    const int c = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
    const int r = 2 * (lane & 3);
#pragma unroll
    for (int jn = 0; jn < NW / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sums[(8 * jn + r + e) * T::kLd + c + 8 * h] =
              acc[4 * jn + 2 * h + e];
  }

  // This block finishes its share of the tile's (x row, 4 columns) quads:
  // all of them, or with a K split 1/splits of them after adding the
  // other blocks' sums through distributed shared memory.
  constexpr int kQuads = BN / 4;
  const int items = NW * kQuads;
  const int share = (items + a.splits - 1) / a.splits;
  const int i0 = min(items, split * share), i1 = min(items, i0 + share);
  if (a.splits > 1) {
    cluster_arrive();
    cluster_wait();  // every block's sums are staged
  } else {
    __syncthreads();
  }
  for (int idx = i0 + tid; idx < i1; idx += T::kThreads) {
    const int r = idx / kQuads, q = idx % kQuads;
    const int row = m0 + r, col = n0 + 4 * q;
    if (row >= a.m || col >= a.n) continue;
    int32_t* const mine = sums + r * T::kLd + 4 * q;
    int4 v = *reinterpret_cast<const int4*>(mine);
    if (a.splits > 1) {
      const uint32_t at = smem_u32(mine);
      int4 u[kMaxSplits];
#pragma unroll
      for (int o = 0; o < kMaxSplits; ++o)  // every load before any add
        if (o < a.splits && o != split)
          u[o] = ld_cluster_v4(cluster_map(at, o));
#pragma unroll
      for (int o = 0; o < kMaxSplits; ++o)
        if (o < a.splits && o != split) {
          v.x = wrap_add(v.x, u[o].x);
          v.y = wrap_add(v.y, u[o].y);
          v.z = wrap_add(v.z, u[o].z);
          v.w = wrap_add(v.w, u[o].w);
        }
    }
    const int32_t s4[4] = {v.x, v.y, v.z, v.w};
    uint32_t packed = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (col + e < a.n) {
        const int32_t out = requant(s4[e], s_bias[4 * q + e],
                                    s_shift[4 * q + e], a.relu ? 0 : -128,
                                    127);
        packed |= static_cast<uint32_t>(static_cast<uint8_t>(out)) << (8 * e);
      }
    }
    int8_t* const dst =
        a.y + static_cast<size_t>(x_row0 + r) * a.n + col;
    if (a.wide && col + 4 <= a.n) {
      *reinterpret_cast<uint32_t*>(dst) = packed;
    } else {
      for (int e = 0; e < 4 && col + e < a.n; ++e)
        dst[e] = static_cast<int8_t>(packed >> (8 * e));
    }
  }
  if (a.splits > 1) {
    // the others may read this block's sums until every block is done
    cluster_arrive();
    cluster_wait();
  }
}

template <int BN, int NW>
int launch(const void* x, const void* wk, GemmArgs a, int kx, int k_pad,
           int trials, cudaStream_t st) {
  using T = Tile<BN, NW>;
  CUtensorMap map_w, map_x;
  int err = cached_u8_map(&map_w, wk, k_pad, trials * a.n, k_pad, BN);
  if (err != 0) return err;
  err = cached_u8_map(&map_x, x, kx, trials * a.m, kx, NW);
  if (err != 0) return err;
  // the shared-memory allowance, set once a device
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  if (dev >= 64 || !allowed[dev]) {
    cerr = cudaFuncSetAttribute(qgemm_wgmma_kernel<BN, NW>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(T::kSmem));
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    if (dev < 64) allowed[dev] = true;
  }
  a.m_tiles = (a.m + NW - 1) / NW;
  const dim3 grid((a.n + BN - 1) / BN, trials * a.m_tiles, a.splits);
  if (a.splits == 1) {
    qgemm_wgmma_kernel<BN, NW><<<grid, T::kThreads, T::kSmem, st>>>(
        map_w, map_x, a);
  } else {
    // the K splits of a tile are one cluster, adjacent along z
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(T::kThreads);
    cfg.dynamicSmemBytes = T::kSmem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = a.splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cerr = cudaLaunchKernelEx(&cfg, qgemm_wgmma_kernel<BN, NW>, map_w, map_x,
                              a);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_nw(int nw, const void* x, const void* wk, const GemmArgs& a,
              int kx, int k_pad, int trials, cudaStream_t st) {
  if (nw == 8) return launch<BN, 8>(x, wk, a, kx, k_pad, trials, st);
  if (nw == 16) return launch<BN, 16>(x, wk, a, kx, k_pad, trials, st);
  if (nw == 32) return launch<BN, 32>(x, wk, a, kx, k_pad, trials, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// y = requant(x @ w + bias), one launch.  x is (M, kx) int8 with kx a
// multiple of 16 (the wrapper zero-pads a ragged K), 16-byte aligned; wk
// is w staged K-major, (N, k_pad) int8 with k_pad a multiple of 128,
// 16-byte aligned.  With `trials` T > 1, x is (T*M, kx), wk (T*N, k_pad)
// and y (T*M, N): trial t's rows of x against its own weight image.  bias and shift_vec may be null (no bias; the scalar
// shift).  The wrapper plans the launch (kernels/qgemm.py:plan): bn (64
// or 128) output columns a tile, nw (8, 16 or 32) rows of x a tile, and
// `splits` (at most 8, a cluster) K splits of `chunk` K tiles.  Returns
// cudaGetLastError(), the error of encoding a tensor map, or
// cudaErrorInvalidValue for arguments outside those ranges.
extern "C" int qgemm_s8(const void* x, const void* wk, const void* bias,
                        const void* shift_vec, void* y, int m, int n, int kx,
                        int k_pad, int bn, int nw, int splits, int chunk,
                        int shift, int relu, int trials, void* stream) {
  const int k_tiles = k_pad / kBK;
  if (x == nullptr || wk == nullptr || m < 1 || n < 1 || trials < 1
      || kx % 16 != 0
      || kx < 16 || kx > k_pad || k_pad % kBK != 0 || splits < 1
      || splits > kMaxSplits || chunk < 1 || (splits - 1) * chunk >= k_tiles
      || splits * chunk < k_tiles
      || reinterpret_cast<uintptr_t>(x) % 16 != 0
      || reinterpret_cast<uintptr_t>(wk) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs a;
  a.bias = static_cast<const int32_t*>(bias);
  a.shift_vec = static_cast<const int32_t*>(shift_vec);
  a.y = static_cast<int8_t*>(y);
  a.m = m; a.n = n; a.k_tiles = k_tiles; a.splits = splits; a.chunk = chunk;
  a.shift = shift; a.relu = relu;
  a.wide = n % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 128) return launch_nw<128>(nw, x, wk, a, kx, k_pad, trials, st);
  if (bn == 64) return launch_nw<64>(nw, x, wk, a, kx, k_pad, trials, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
