// Dense int8 conv with the fused requant / ReLU / residual-skip / concat /
// max-pool epilogue: the conv stage of the int8 CNN path.
//
// Replaces the Pallas kernels src/repro/kernels/qconv.py:qconv2d
// (_qconv_band_kernel + _band_epilogue), its concat-buffer variant
// _qconv2d_into (qconv2d(out_buf=...)) and the ragged grouped conv
// qgconv2d, which runs the same band body once per group.
//
// Semantics, per output channel c of a VALID conv over the pre-padded NHWC
// input (strides sh, sw; HWIO weights): v = epilogue(acc, c) (requant.cuh:
// bias, requant, ReLU, clip, then the skip and concat steps), then
// y = max over the pool window of v, and y lands in channels
// [out_off, out_off + Cout) of an output whose channel stride is c_tot (the
// shared concat buffer, updated in place; its other channels are never
// touched), or of a plain (N, OH, OW, Cout) tensor when c_tot == Cout and
// out_off == 0.
//
// Groups (1 when dense): group g reads input channels
// [g*Cin/G, (g+1)*Cin/G) of each pixel and owns output channels
// [g*Cout/G, (g+1)*Cout/G); its contraction is K = KH*KW*Cin/G against
// those weight columns (HWIO (KH, KW, Cin/G, Cout)).  The group rides
// gridDim.z and each block's channel tiles are masked at the group's edge,
// so no tile mixes two groups.
//
// What bounds it on the H100: the conv layers of VGG-16 and AlexNet reuse
// every input byte KH*KW*Cout times and every weight byte once per output
// pixel, so at the shapes of the main path they are bound by operations,
// not by HBM.  This first version is an implicit GEMM on __dp4a (four
// int8 products per instruction on the CUDA cores, not the tensor cores;
// wgmma s8 comes in a later version): rows are output pixels, columns
// output channels, the contraction runs over (kh, kw, ci).  A block
// computes a 64 x 64 tile; each of its 256 threads a 4 x 4 sub-tile, with
// 32-deep K steps staged in shared memory as k-packed words so that one
// 128-bit shared load feeds four __dp4a.
//
// The fused max-pool is the hard part: every pooled output must see its
// whole window of post-epilogue values, and AlexNet's 3x3/2 windows
// overlap.  Here the GEMM rows are (pooled pixel, window tap) pairs, so a
// block owns whole windows: a tap shared by two windows is computed once
// for each (2.25x the conv work for 3x3/2, none extra for VGG's 2x2/2).
// The epilogue writes the block's int8 values to shared memory and the
// block then reduces each window and stores the pooled row.
#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 64;  // GEMM rows: (pooled pixel, window tap) pairs
constexpr int kTileN = 64;  // output channels
constexpr int kTileK = 32;  // contraction step
constexpr int kQuads = kTileK / 4;

struct ConvArgs {
  const int8_t* x;          // (N, Hp, Wp, Cin)
  const int8_t* w;          // (KH, KW, Cin/G, Cout) == (K, Cout)
  int8_t* y;                // (N, OH, OW, c_tot)
  Epilogue ep;
  int n, hp, wp, cin, kh, kw, cout, sh, sw;
  int cin_g, cout_g;         // channels of one group
  int ho, wo, oh, ow;       // conv and output (pooled) geometry
  int pw, ps;               // pool window and stride; 1, 1 without a pool
  int c_tot, out_off;
  int vec;                  // Cin/G % 4 == 0 and x is 4-byte aligned
};

// The conv pixel that GEMM row `row` of block `blk` computes, or false when
// the row lies past the last pooled pixel.
__device__ __forceinline__ bool row_pixel(const ConvArgs& a, int blk, int row,
                                          int* img, int* ch, int* cw) {
  const int taps = a.pw * a.pw;
  const int per_block = kTileM / taps;
  if (row >= per_block * taps) return false;
  const long long pooled = static_cast<long long>(blk) * per_block + row / taps;
  if (pooled >= static_cast<long long>(a.n) * a.oh * a.ow) return false;
  const int tap = row % taps;
  const int plane = a.oh * a.ow;
  *img = static_cast<int>(pooled / plane);
  const int rem = static_cast<int>(pooled % plane);
  *ch = (rem / a.ow) * a.ps + tap / a.pw;
  *cw = (rem % a.ow) * a.ps + tap % a.pw;
  return true;
}

// Input byte k of the contraction (k runs over (kh, kw, ci) within the
// group) for the window whose group slice starts at `base`.
__device__ __forceinline__ uint8_t x_at(const ConvArgs& a, long long base,
                                        int k) {
  const int ci = k % a.cin_g;
  const int t = k / a.cin_g;
  const int j = t % a.kw;
  const int i = t / a.kw;
  return static_cast<uint8_t>(
      a.x[base + (static_cast<long long>(i) * a.wp + j) * a.cin + ci]);
}

__global__ void __launch_bounds__(kThreads) qconv_kernel(ConvArgs a) {
  __shared__ __align__(16) uint32_t as[kQuads][kTileM];
  __shared__ __align__(16) uint32_t bs[kQuads][kTileN];
  __shared__ int8_t ys[kTileM][kTileN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int blk = blockIdx.x;
  const int c0 = blockIdx.y * kTileN;             // within the group
  const int cg0 = blockIdx.z * a.cout_g + c0;     // weight / output column
  const int k_total = a.kh * a.kw * a.cin_g;

  // the A row this thread stages, and its input window's base offset
  // (the group's first channel of the window's first pixel)
  const int a_row = tid % kTileM;
  int img, ch, cw;
  const bool a_valid = row_pixel(a, blk, a_row, &img, &ch, &cw);
  const long long a_base =
      a_valid ? ((static_cast<long long>(img) * a.hp + ch * a.sh) * a.wp +
                 cw * a.sw) * a.cin + blockIdx.z * a.cin_g
              : 0;
  const int b_col = tid % kTileN;
  const bool b_valid = c0 + b_col < a.cout_g;

  int32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k_total; k0 += kTileK) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tid / kTileM + 4 * h;
      const int k = k0 + 4 * q;
      uint32_t word = 0;
      if (a_valid) {
        if (a.vec && k + 3 < k_total) {
          const int ci = k % a.cin_g;
          const int t = k / a.cin_g;
          const long long off =
              a_base + (static_cast<long long>(t / a.kw) * a.wp + t % a.kw) *
                           a.cin + ci;
          word = *reinterpret_cast<const uint32_t*>(a.x + off);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k + i < k_total)
              word |= static_cast<uint32_t>(x_at(a, a_base, k + i)) << (8 * i);
        }
      }
      as[q][a_row] = word;

      uint32_t wword = 0;
      if (b_valid) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k + i < k_total)
            wword |= static_cast<uint32_t>(static_cast<uint8_t>(
                         a.w[static_cast<long long>(k + i) * a.cout + cg0 +
                             b_col]))
                     << (8 * i);
      }
      bs[q][b_col] = wword;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const uint4 av = *reinterpret_cast<const uint4*>(&as[q][ty * 4]);
      const uint4 bv = *reinterpret_cast<const uint4*>(&bs[q][tx * 4]);
      const int ar[4] = {static_cast<int>(av.x), static_cast<int>(av.y),
                         static_cast<int>(av.z), static_cast<int>(av.w)};
      const int br[4] = {static_cast<int>(bv.x), static_cast<int>(bv.y),
                         static_cast<int>(bv.z), static_cast<int>(bv.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: conv requant, skip merge, concat alignment -> int8 in ys
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    int r_img, r_h, r_w;
    if (!row_pixel(a, blk, row, &r_img, &r_h, &r_w)) continue;
    const long long s_at =
        ((static_cast<long long>(r_img) * a.ho + r_h) * a.wo + r_w) * a.cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx * 4 + j;
      if (c0 + col >= a.cout_g) continue;
      const int c = cg0 + col;
      ys[row][col] =
          static_cast<int8_t>(epilogue(a.ep, acc[i][j], c, s_at + c));
    }
  }
  __syncthreads();

  // max over each window (one tap without a pool), strided store
  const int taps = a.pw * a.pw;
  const int per_block = kTileM / taps;
  const long long n_pooled = static_cast<long long>(a.n) * a.oh * a.ow;
  for (int idx = tid; idx < per_block * kTileN; idx += kThreads) {
    const int p = idx / kTileN;
    const int col = idx % kTileN;
    const long long pooled = static_cast<long long>(blk) * per_block + p;
    if (pooled >= n_pooled || c0 + col >= a.cout_g) continue;
    int m = ys[p * taps][col];
    for (int t = 1; t < taps; ++t) m = max(m, static_cast<int>(ys[p * taps + t][col]));
    a.y[pooled * a.c_tot + a.out_off + cg0 + col] = static_cast<int8_t>(m);
  }
}

}  // namespace

// Launch the conv.  Pointers may be null where ConvArgs and Epilogue say
// so.  The wrapper checks every shape, type and range (groups divides Cin
// and Cout).  Returns cudaGetLastError().
extern "C" int qconv_s8(const void* x, const void* w, const void* bias,
                        const void* shift_vec, const void* skip, void* y,
                        int n, int hp, int wp, int cin, int kh, int kw,
                        int cout, int sh, int sw, int pw, int ps, int shift,
                        int relu, int a_conv, int a_skip, int merge_shift,
                        int merge_relu, int concat_shift, int concat_relu,
                        int c_tot, int out_off, int vec, int groups,
                        void* stream) {
  ConvArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.y = static_cast<int8_t*>(y);
  a.ep.bias = static_cast<const int32_t*>(bias);
  a.ep.shift_vec = static_cast<const int32_t*>(shift_vec);
  a.ep.skip = static_cast<const int8_t*>(skip);
  a.ep.shift = shift; a.ep.relu = relu;
  a.ep.a_conv = a_conv; a.ep.a_skip = a_skip;
  a.ep.merge_shift = merge_shift; a.ep.merge_relu = merge_relu;
  a.ep.concat_shift = concat_shift; a.ep.concat_relu = concat_relu;
  a.n = n; a.hp = hp; a.wp = wp; a.cin = cin; a.kh = kh; a.kw = kw;
  a.cout = cout; a.sh = sh; a.sw = sw;
  a.cin_g = cin / groups; a.cout_g = cout / groups;
  a.ho = (hp - kh) / sh + 1;
  a.wo = (wp - kw) / sw + 1;
  a.pw = pw; a.ps = ps;
  a.oh = (a.ho - pw) / ps + 1;
  a.ow = (a.wo - pw) / ps + 1;
  a.c_tot = c_tot; a.out_off = out_off; a.vec = vec;
  const long long n_pooled = static_cast<long long>(n) * a.oh * a.ow;
  const int per_block = kTileM / (pw * pw);
  const dim3 grid(static_cast<unsigned>((n_pooled + per_block - 1) / per_block),
                  (a.cout_g + kTileN - 1) / kTileN, groups);
  qconv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
