// int8 GEMM + bias + requantize: the FC stage of the int8 CNN path.
//
// Replaces the Pallas kernel src/repro/kernels/qgemm.py:qgemm
// (_qgemm_kernel):
//   y[m, n] = clip(relu(round_shift(sum_k x[m, k] * w[k, n] + b[n], s[n])))
// with x (M, K) int8, w (K, N) int8, b (N,) int32, s a scalar or a
// per-column int32 vector, y (M, N) int8, all row-major.
//
// What bounds it on the H100: the CNN serves small batches (M = 1..8),
// so each weight byte is used M times, far below the ~590 int8 operations
// per byte at which the tensor cores, not the 3.35 TB/s of HBM, become the
// limit.  The kernel is bound by reading w once (VGG-16's FC1 alone is
// 103 MB).  The design spreads that read over every SM:
//   * a block owns kBlockM rows x 1024 columns of y and one slice of K
//     (split-K, chosen by the wrapper so that the grid fills the card);
//   * each thread reads 4 rows x 4 columns of w as four 32-bit loads (one
//     byte at a time on a ragged edge), transposes them into k-packed words
//     with __byte_perm and feeds __dp4a;
//   * the block's rows of x for the current K stretch sit in shared memory;
//   * with several K slices the partial sums meet in an int32 scratch
//     through atomicAdd (integer sums are exact in any order, so the result
//     is deterministic) and a second small kernel applies the epilogue;
//     with one slice the epilogue runs in the main kernel.
// Every edge is masked: no operand is padded.
#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kBlockN = kThreads * kColsPerThread;
constexpr int kStageK = 256;  // K values of x staged per pass, multiple of 4

// Columns n0..n0+3 of rows k..k+3 of w, as four words c[j] whose byte i is
// w[k + i][n0 + j]; rows at or past k_end and columns at or past n read 0.
__device__ __forceinline__ void load_w_quad(const int8_t* __restrict__ w,
                                            int n, int k_end, int k, int n0,
                                            bool vec, uint32_t c[4]) {
  if (vec && k + 3 < k_end) {
    const int8_t* p = w + static_cast<size_t>(k) * n + n0;
    const uint32_t r0 = __ldg(reinterpret_cast<const uint32_t*>(p));
    const uint32_t r1 = __ldg(reinterpret_cast<const uint32_t*>(p + n));
    const uint32_t r2 = __ldg(reinterpret_cast<const uint32_t*>(p + 2 * n));
    const uint32_t r3 = __ldg(reinterpret_cast<const uint32_t*>(p + 3 * n));
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
    const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
    c[0] = __byte_perm(t0, t1, 0x5410);
    c[1] = __byte_perm(t0, t1, 0x7632);
    c[2] = __byte_perm(t2, t3, 0x5410);
    c[3] = __byte_perm(t2, t3, 0x7632);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
    if (n0 + j < n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k + i < k_end) {
          const uint8_t b = static_cast<uint8_t>(
              w[static_cast<size_t>(k + i) * n + n0 + j]);
          word |= static_cast<uint32_t>(b) << (8 * i);
        }
      }
    }
    c[j] = word;
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
    qgemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const int32_t* __restrict__ bias,
                 const int32_t* __restrict__ shift_vec,
                 int8_t* __restrict__ y, int32_t* __restrict__ partial, int m,
                 int n, int k, int k_chunk, int shift, int relu, int vec) {
  __shared__ __align__(16) int8_t xs[BM][kStageK];
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kColsPerThread;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(k, k_begin + k_chunk);
  const bool active = n0 < n;

  int32_t acc[BM][kColsPerThread];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0;

  for (int ks = k_begin; ks < k_end; ks += kStageK) {
    const int klen = min(kStageK, k_end - ks);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kStageK; i += kThreads) {
      const int r = i / kStageK;
      const int kk = i % kStageK;
      int8_t v = 0;
      if (m0 + r < m && kk < klen) v = x[static_cast<size_t>(m0 + r) * k + ks + kk];
      xs[r][kk] = v;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int kk = 0; kk < klen; kk += 4) {
      uint32_t c[4];
      load_w_quad(w, n, k_end, ks + kk, n0, vec != 0, c);
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const int xw = *reinterpret_cast<const int*>(&xs[r][kk]);
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          acc[r][j] = __dp4a(static_cast<int>(c[j]), xw, acc[r][j]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int row = m0 + r;
    if (row >= m) break;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = n0 + j;
      if (col >= n) break;
      const size_t at = static_cast<size_t>(row) * n + col;
      if (partial != nullptr) {
        atomicAdd(partial + at, acc[r][j]);
      } else {
        y[at] = static_cast<int8_t>(
            requant(acc[r][j], bias ? bias[col] : 0,
                    shift_vec ? shift_vec[col] : shift, relu != 0));
      }
    }
  }
}

__global__ void qgemm_epilogue_kernel(const int32_t* __restrict__ partial,
                                      const int32_t* __restrict__ bias,
                                      const int32_t* __restrict__ shift_vec,
                                      int8_t* __restrict__ y, int m, int n,
                                      int shift, int relu) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(m) * n) return;
  const int col = static_cast<int>(i % n);
  y[i] = static_cast<int8_t>(requant(partial[i], bias ? bias[col] : 0,
                                     shift_vec ? shift_vec[col] : shift,
                                     relu != 0));
}

template <int BM>
void launch_main(dim3 grid, cudaStream_t st, const int8_t* x, const int8_t* w,
                 const int32_t* bias, const int32_t* shift_vec, int8_t* y,
                 int32_t* partial, int m, int n, int k, int k_chunk,
                 int shift, int relu, int vec) {
  qgemm_kernel<BM><<<grid, kThreads, 0, st>>>(x, w, bias, shift_vec, y,
                                              partial, m, n, k, k_chunk,
                                              shift, relu, vec);
}

}  // namespace

// y = requant(x @ w + bias).  bias and shift_vec may be null (no bias; the
// scalar shift).  bm is the rows of y a block owns (1, 2, 4 or 8), chosen
// by the caller, which sizes the split-K grid with it.  With splits > 1,
// partial is an (M, N) int32 scratch the caller has zeroed; k_chunk is the
// K length of each split.  vec says that N % 4 == 0 and w is 4-byte
// aligned.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// another bm.
extern "C" int qgemm_s8(const void* x, const void* w, const void* bias,
                        const void* shift_vec, void* y, void* partial, int m,
                        int n, int k, int bm, int k_chunk, int splits,
                        int shift, int relu, int vec, void* stream) {
  if (bm != 1 && bm != 2 && bm != 4 && bm != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBlockN - 1) / kBlockN, (m + bm - 1) / bm, splits);
  int32_t* part = splits > 1 ? static_cast<int32_t*>(partial) : nullptr;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* bp = static_cast<const int32_t*>(bias);
  const auto* sp = static_cast<const int32_t*>(shift_vec);
  auto* yp = static_cast<int8_t*>(y);
  switch (bm) {
    case 1: launch_main<1>(grid, st, xp, wp, bp, sp, yp, part, m, n, k, k_chunk, shift, relu, vec); break;
    case 2: launch_main<2>(grid, st, xp, wp, bp, sp, yp, part, m, n, k, k_chunk, shift, relu, vec); break;
    case 4: launch_main<4>(grid, st, xp, wp, bp, sp, yp, part, m, n, k, k_chunk, shift, relu, vec); break;
    case 8: launch_main<8>(grid, st, xp, wp, bp, sp, yp, part, m, n, k, k_chunk, shift, relu, vec); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(m) * n;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  qgemm_epilogue_kernel<<<blocks, threads, 0, st>>>(part, bp, sp, yp, m, n,
                                                    shift, relu);
  return static_cast<int>(cudaGetLastError());
}
