// Depthwise int8 conv (ONNX group == Cin, channel multiplier m: output
// channel c convolves input channel c / m) with the fused requant / ReLU /
// residual-skip / concat / max-pool epilogue.
//
// Replaces the Pallas kernels src/repro/kernels/qconv.py:qdwconv2d
// (_qdwconv_band_kernel + _band_epilogue, pallas_call at :844) and its
// concat-buffer branch (qdwconv2d(out_buf=...), :770).
//
// Semantics, per output channel c: acc = the KH x KW window of input
// channel c / m times the filter column c (HWIO (KH, KW, 1, Cout)), summed
// in int32 with two's-complement wrap; v = epilogue(acc, c) (requant.cuh);
// y = max over the pool window of v; y lands in channels
// [out_off, out_off + Cout) of an output whose channel stride is c_tot (the
// shared concat buffer, updated in place; its other channels are never
// touched), or of a plain (N, OH, OW, Cout) tensor.
//
// What bounds it on the H100: each output value costs KH*KW multiply-adds
// and no reduction runs across channels, so neither __dp4a nor wgmma
// applies (both sum over the contraction, and a depthwise conv has none
// across channels): the work runs on the CUDA cores.  It is tiny beside the
// bytes, and the bytes are tiny too: at mobilenet_tiny's 224x224 shapes
// each layer moves about 0.4 MB, a tenth of a microsecond of HBM time, so a
// launch is bound by latency: how few dependent trips to memory a block
// makes, and how many blocks share the card.  The design:
// * A block owns (image, a band of output rows and columns, a group of cb
//   output channels), planned in kernels/qconv.py:dw_plan so that the grid
//   comes near one wave.  It stages the band's input rows and columns,
//   halo included, in shared memory, one channel run a pixel, in one pass
//   of copies from the UNPADDED input: a stage pixel that falls in the
//   conv's zero padding is staged as zeros (a copy of source size 0, or a
//   zero word), so no padded copy of the input is ever made, and only the
//   bands at the image's border take that path.  The copies are 16-byte
//   cp.async where the run is aligned (m == 1, Cin a multiple of 16),
//   4-byte ones where Cin is a multiple of 4, otherwise words of 4
//   channels gathered a byte at a time (and for m > 1, where the stage
//   holds input channel c / m at column c, so that every later step reads
//   4 channels as one word).  The block's filter taps, biases and shifts
//   go to shared memory beside them while the copies are in flight: one
//   trip to memory before the block computes, and none after but the skip
//   operand's.
// * A thread computes a run of kRun output pixels along W for 4
//   consecutive channels (char4 lanes).  At 3x3 stride 1 it holds the
//   nine taps and each input row's kRun + 2 columns in registers, so every
//   input word it reads serves three taps.
// * Without a pool the epilogue's int8 values leave as 4-byte words where
//   c_tot, out_off and the channel allow, else as bytes.  With a pool the
//   band also covers the pool's halo rows and columns: its conv outputs
//   are computed once, through the epilogue, into shared memory, and the
//   window max is then taken from there (windows that straddle two bands
//   see the halo conv rows that each band computes for itself).
//
// The trial form (`trials` T > 1) is what the JAX package's qdwconv2d
// becomes under jax.vmap in an SER campaign (src/repro/core/ser.py:315):
// the batch holds T trials of n / T images each, and trial t's images
// read their own filter image, the t-th of a (T, KH, KW, 1, Cout) stack.
// A block owns one image, so it reads one filter image: the trial only
// moves the filter pointer, by the block's image / (n / T).
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "requant.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 128;
constexpr int kRun = 2;  // output pixels a thread computes along W
constexpr int kMaxSmem = 96 * 1024;
constexpr int kMaxCb = 32;  // output channels a block (the plan's cap)

struct DwArgs {
  const int8_t* x;  // (N, H, W, Cin), unpadded
  const int8_t* w;  // (T, KH, KW, 1, Cout) == (T, KH * KW, Cout)
  int8_t* y;        // (N, OH, OW, c_tot)
  Epilogue ep;
  int n, ih, iw, cin, kh, kw, cout, m, sh, sw;  // ih, iw: x's H and W
  int pt, pl;       // the conv's top and left zero padding
  int n_trial;      // images of one trial: image i reads filter i / n_trial
  int ho, wo, oh, ow;  // conv and output (pooled) geometry
  int pw, ps;          // pool window and stride; 1, 1 without a pool
  int c_tot, out_off;
  int rp, cp, cb;      // a band's output rows, output columns, channels
  int x_bytes, w_bytes;  // shared memory of the input band and the taps
  int mode;            // input copies: 16, 4 or 1 bytes
  int wide;            // c_tot, out_off and y allow 4-byte stores
};

__device__ __forceinline__ int32_t lane_s8(uint32_t word, int e) {
  return static_cast<int32_t>(static_cast<int8_t>(word >> (8 * e)));
}

// 4 channels of the epilogue's int8 values as one word; lanes at or past
// Cout are 0.  `ep` has no bias or shift vector: the block's biases and
// shifts come from shared memory (s_bias, s_shift at the quad's first
// channel), the bias added to the sum first as requant adds it.
__device__ __forceinline__ uint32_t finish4(const DwArgs& a, Epilogue& ep,
                                            const uint32_t (&acc)[4],
                                            const int32_t* s_bias,
                                            const int32_t* s_shift, int c,
                                            long long skip_at) {
  uint32_t packed = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (c + e < a.cout) {
      ep.shift = s_shift[e];
      const int32_t v = epilogue(
          ep, wrap_add(static_cast<int32_t>(acc[e]), s_bias[e]), c + e,
          skip_at + e);
      packed |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * e);
    }
  }
  return packed;
}

__device__ __forceinline__ void store4(const DwArgs& a, long long pix, int c,
                                       uint32_t packed) {
  int8_t* const dst = a.y + pix * a.c_tot + a.out_off + c;
  if (a.wide && c + 4 <= a.cout) {
    *reinterpret_cast<uint32_t*>(dst) = packed;
  } else {
    for (int e = 0; e < 4 && c + e < a.cout; ++e)
      dst[e] = static_cast<int8_t>(packed >> (8 * e));
  }
}

// dst[i] = src(i) for i in [0, count): words of 4 channels that src
// gathers a byte at a time, kBatch of them a thread with every load before
// any store (a loop of one load and one store waits out a trip to memory
// each time).
template <typename Src>
__device__ __forceinline__ void gather_words(uint32_t* dst, int count,
                                             Src src) {
  constexpr int kBatch = 4;
  for (int base = threadIdx.x; base < count; base += kThreads * kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < count ? src(i) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < count) dst[i] = v[u];
    }
  }
}

// K == 3: a 3x3 stride-1 conv with the taps and a run's input columns in
// registers; K == 0: any window and stride, every tap read from shared
// memory.
template <int K>
__global__ void __launch_bounds__(kThreads) qdwconv_kernel(DwArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int bands_w = (a.ow + a.cp - 1) / a.cp;
  const int p0 = (blockIdx.x / bands_w) * a.rp;  // first output row
  const int q0 = (blockIdx.x % bands_w) * a.cp;  // first output column
  const int c0 = blockIdx.y * a.cb;              // first output channel
  const int img = blockIdx.z;
  const int8_t* const w_img =
      a.w + static_cast<long long>(img / a.n_trial) * a.kh * a.kw * a.cout;
  const int rp = min(a.rp, a.oh - p0), cp = min(a.cp, a.ow - q0);
  const int rc = (rp - 1) * a.ps + a.pw;  // the band's conv rows
  const int wc = (cp - 1) * a.ps + a.pw;  // and columns
  const int ri = (rc - 1) * a.sh + a.kh;  // its input rows
  const int wi = (wc - 1) * a.sw + a.kw;  // and columns
  const int cr0 = p0 * a.ps, cc0 = q0 * a.ps;  // first conv row, column
  const int cb = a.cb, quads = cb / 4;
  uint8_t* const xs = smem;                       // (ri, wi, cb)
  uint8_t* const ws = smem + a.x_bytes;           // (kh * kw, cb)
  uint8_t* const cs = ws + a.w_bytes;             // (rc, wc, cb), pooled
  __shared__ int32_t s_bias[kMaxCb], s_shift[kMaxCb];
  const int tid = threadIdx.x;

  // the input band: pixel (r, col) of the stage is pixel (cr0 * sh + r,
  // cc0 * sw + col) of the padded input, so pixel (iy0 + r, ix0 + col) of
  // x, and zeros where that lies outside x (the conv's pads); column cl
  // of it holds input channel (c0 + cl) / m, zero past Cout
  const int iy0 = cr0 * a.sh - a.pt, ix0 = cc0 * a.sw - a.pl;
  const int8_t* const x_img =
      a.x + static_cast<long long>(img) * a.ih * a.iw * a.cin;
  auto inside = [&](int r, int col) {
    return static_cast<unsigned>(iy0 + r) < static_cast<unsigned>(a.ih)
           && static_cast<unsigned>(ix0 + col) < static_cast<unsigned>(a.iw);
  };
  auto pixel = [&](int r, int col) {
    return x_img
           + (static_cast<long long>(iy0 + r) * a.iw + ix0 + col) * a.cin;
  };
  if (a.mode > 1) {  // m == 1: channel runs copied as they stand
    const int per_pix = cb / a.mode;
    for (int idx = tid; idx < ri * wi * per_pix; idx += kThreads) {
      const int j = idx % per_pix, pix = idx / per_pix;
      const int r = pix / wi, col = pix - r * wi;
      const int ch = c0 + j * a.mode;
      const bool in = ch < a.cin && inside(r, col);
      const int8_t* src = in ? pixel(r, col) + ch : a.x;
      const uint32_t dst = smem_u32(xs + pix * cb + j * a.mode);
      if (a.mode == 16) cp_async16(dst, src, in ? 16 : 0);
      else cp_async4(dst, src, in ? 4 : 0);
    }
    cp_async_commit();
  } else {  // word (pixel, 4 channels) i of the stage
    gather_words(reinterpret_cast<uint32_t*>(xs), ri * wi * quads,
                 [&](int i) -> uint32_t {
      const int qd = i % quads, pix = i / quads;
      const int r = pix / wi, col = pix - r * wi;
      if (!inside(r, col)) return 0u;
      const int8_t* const px = pixel(r, col);
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = c0 + 4 * qd + e;
        if (ch < a.cout)
          word |= static_cast<uint32_t>(static_cast<uint8_t>(px[ch / a.m]))
                  << (8 * e);
      }
      return word;
    });
  }
  // the taps, biases and shifts load while the copies are in flight, so
  // that the epilogue reads nothing from global memory but the skip
  gather_words(reinterpret_cast<uint32_t*>(ws), a.kh * a.kw * quads,
               [&](int i) -> uint32_t {
    const int qd = i % quads, t = i / quads;
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = c0 + 4 * qd + e;
      if (ch < a.cout)
        word |= static_cast<uint32_t>(static_cast<uint8_t>(
                    w_img[t * a.cout + ch])) << (8 * e);
    }
    return word;
  });
  if (tid < cb) {
    const bool in = c0 + tid < a.cout;
    s_bias[tid] = a.ep.bias != nullptr && in ? a.ep.bias[c0 + tid] : 0;
    s_shift[tid] = a.ep.shift_vec != nullptr && in ? a.ep.shift_vec[c0 + tid]
                                                   : a.ep.shift;
  }
  if (a.mode > 1) cp_async_wait<0>();
  __syncthreads();
  Epilogue ep = a.ep;
  ep.bias = nullptr;
  ep.shift_vec = nullptr;

  const bool pooled = a.pw != 1 || a.ps != 1;
  const int runs = (wc + kRun - 1) / kRun;
  for (int it = tid; it < rc * runs * quads; it += kThreads) {
    const int qd = it % quads, run = (it / quads) % runs,
              r = it / (quads * runs);
    const int cl = 4 * qd, c = c0 + cl;
    if (c >= a.cout) continue;
    const int col0 = run * kRun;  // first conv column of the run
    uint32_t acc[kRun][4];
#pragma unroll
    for (int p = 0; p < kRun; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][e] = 0;
    if (K == 3) {
      int32_t wt[9][4];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const uint32_t wv =
            *reinterpret_cast<const uint32_t*>(ws + t * cb + cl);
#pragma unroll
        for (int e = 0; e < 4; ++e) wt[t][e] = lane_s8(wv, e);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const uint8_t* const row = xs + ((r * a.sh + i) * wi + col0) * cb + cl;
        int32_t xv[kRun + 2][4];
#pragma unroll
        for (int t = 0; t < kRun + 2; ++t) {
          const uint32_t word =
              col0 + t < wi ? *reinterpret_cast<const uint32_t*>(row + t * cb)
                            : 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[t][e] = lane_s8(word, e);
        }
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int p = 0; p < kRun; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[p][e] +=
                  static_cast<uint32_t>(xv[p + j][e] * wt[3 * i + j][e]);
      }
    } else {
      for (int i = 0; i < a.kh; ++i) {
        for (int j = 0; j < a.kw; ++j) {
          const uint32_t wv = *reinterpret_cast<const uint32_t*>(
              ws + (i * a.kw + j) * cb + cl);
#pragma unroll
          for (int p = 0; p < kRun; ++p) {
            if (col0 + p >= wc) break;
            const uint32_t xw = *reinterpret_cast<const uint32_t*>(
                xs + ((r * a.sh + i) * wi + (col0 + p) * a.sw + j) * cb + cl);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[p][e] +=
                  static_cast<uint32_t>(lane_s8(xw, e) * lane_s8(wv, e));
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kRun; ++p) {
      if (col0 + p >= wc) break;
      const long long conv_pix =
          (static_cast<long long>(img) * a.ho + cr0 + r) * a.wo + cc0 + col0
          + p;
      const uint32_t packed = finish4(a, ep, acc[p], s_bias + cl,
                                      s_shift + cl, c, conv_pix * a.cout + c);
      if (pooled)
        *reinterpret_cast<uint32_t*>(cs + (r * wc + col0 + p) * cb + cl) =
            packed;
      else
        store4(a, conv_pix, c, packed);  // no pool: output pixel == conv pixel
    }
  }
  if (!pooled) return;

  // the max over each window, from the band's conv values in shared
  // memory (a byte-wise signed max of words)
  __syncthreads();
  for (int it = tid; it < rp * cp * quads; it += kThreads) {
    const int qd = it % quads, q = (it / quads) % cp, pr = it / (quads * cp);
    const int cl = 4 * qd, c = c0 + cl;
    if (c >= a.cout) continue;
    uint32_t best = 0x80808080u;  // -128 in every lane
    for (int dy = 0; dy < a.pw; ++dy)
      for (int dx = 0; dx < a.pw; ++dx)
        best = __vmaxs4(best, *reinterpret_cast<const uint32_t*>(
                                  cs + ((pr * a.ps + dy) * wc + q * a.ps + dx)
                                           * cb + cl));
    store4(a, (static_cast<long long>(img) * a.oh + p0 + pr) * a.ow + q0 + q,
           c, best);
  }
}

template <int K>
int launch(const DwArgs& a, cudaStream_t st) {
  // the shared-memory allowance, set once a device
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(qdwconv_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) allowed[dev] = true;
  }
  const int rc = (a.rp - 1) * a.ps + a.pw, wc = (a.cp - 1) * a.ps + a.pw;
  const bool pooled = a.pw != 1 || a.ps != 1;
  const int smem = a.x_bytes + a.w_bytes + (pooled ? rc * wc * a.cb : 0);
  const dim3 grid(((a.oh + a.rp - 1) / a.rp) * ((a.ow + a.cp - 1) / a.cp),
                  (a.cout + a.cb - 1) / a.cb, a.n);
  qdwconv_kernel<K><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the depthwise conv.  Pointers may be null where DwArgs and
// Epilogue say so.  The wrapper checks every shape, type and range (Cout is
// a multiple of Cin) and plans the launch (kernels/qconv.py:dw_plan): rp
// output rows, cp output columns and cb output channels (a multiple of 4)
// a block; mode is the input copies' width (16: m == 1, Cin % 16 == 0,
// cb % 16 == 0 and x 16-byte aligned; 4: m == 1, Cin % 4 == 0 and x 4-byte
// aligned; else 1); wide says that c_tot, out_off and y allow 4-byte
// stores.  With `trials` T > 1, w is a stack of T filter images and
// image i of the n reads image i / (n / T).  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a plan outside those ranges, a T that does
// not divide n, a negative pad, or over kMaxSmem bytes of shared memory.
// x is the unpadded (n, ih, iw, cin) input and pt, pl, pb, pr the conv's
// zero padding (ONNX's top, left, bottom, right): the conv runs over the
// (ih + pt + pb) x (iw + pl + pr) padded extent, whose pads the band
// staging takes as zeros.
// `hi` is the upper end of the requant's clamp: 127, or a ReLU-n's clamp
// code; the wrapper holds it in [0, 127].
extern "C" int qdwconv_s8(const void* x, const void* w, const void* bias,
                          const void* shift_vec, const void* skip, void* y,
                          int n, int ih, int iw, int cin, int kh, int kw,
                          int cout, int sh, int sw, int pw, int ps, int shift,
                          int relu, int hi, int a_conv, int a_skip,
                          int merge_shift, int merge_relu, int concat_shift,
                          int concat_relu, int c_tot, int out_off, int rp,
                          int cp, int cb, int mode, int wide, int trials,
                          int pt, int pl, int pb, int pr, void* stream) {
  DwArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.y = static_cast<int8_t*>(y);
  a.ep.bias = static_cast<const int32_t*>(bias);
  a.ep.shift_vec = static_cast<const int32_t*>(shift_vec);
  a.ep.skip = static_cast<const int8_t*>(skip);
  a.ep.shift = shift; a.ep.lo = relu ? 0 : -128; a.ep.hi = hi;
  a.ep.a_conv = a_conv; a.ep.a_skip = a_skip;
  a.ep.merge_shift = merge_shift; a.ep.merge_relu = merge_relu;
  a.ep.concat_shift = concat_shift; a.ep.concat_relu = concat_relu;
  a.n = n; a.ih = ih; a.iw = iw; a.cin = cin; a.kh = kh; a.kw = kw;
  a.cout = cout; a.m = cout / cin; a.sh = sh; a.sw = sw;
  a.pt = pt; a.pl = pl;
  a.ho = (ih + pt + pb - kh) / sh + 1;
  a.wo = (iw + pl + pr - kw) / sw + 1;
  a.pw = pw; a.ps = ps;
  a.oh = (a.ho - pw) / ps + 1;
  a.ow = (a.wo - pw) / ps + 1;
  a.c_tot = c_tot; a.out_off = out_off;
  a.rp = rp; a.cp = cp; a.cb = cb; a.mode = mode; a.wide = wide;
  a.n_trial = trials > 0 ? n / trials : 0;
  if (trials < 1 || n % trials != 0 || rp < 1 || cp < 1 || cb < 4
      || cb > kMaxCb || cb % 4 != 0
      || (mode != 1 && mode != 4 && mode != 16) || cb % mode != 0
      || (mode > 1 && a.m != 1) || pt < 0 || pl < 0 || pb < 0 || pr < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = (rp - 1) * ps + pw, wc = (cp - 1) * ps + pw;
  // the plan's shared memory, each part rounded up to 16 bytes
  auto up16 = [](long long v) { return 16 * ((v + 15) / 16); };
  const long long x_bytes =
      up16(static_cast<long long>((rc - 1) * sh + kh) * ((wc - 1) * sw + kw)
           * cb);
  const long long w_bytes = up16(static_cast<long long>(kh) * kw * cb);
  const long long pool_bytes =
      pw != 1 || ps != 1 ? static_cast<long long>(rc) * wc * cb : 0;
  if (x_bytes + w_bytes + pool_bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  a.x_bytes = static_cast<int>(x_bytes);
  a.w_bytes = static_cast<int>(w_bytes);
  if (static_cast<long long>(n) * a.oh * a.ow == 0 || cout == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kh == 3 && kw == 3 && sw == 1) return launch<3>(a, st);
  return launch<0>(a, st);
}
