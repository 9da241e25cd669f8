// Depthwise int8 conv (ONNX group == Cin, channel multiplier m: output
// channel c convolves input channel c / m) with the fused requant / ReLU /
// residual-skip / concat / max-pool epilogue.
//
// Replaces the Pallas kernels src/repro/kernels/qconv.py:qdwconv2d
// (_qdwconv_band_kernel + _band_epilogue) and its concat-buffer branch
// (qdwconv2d(out_buf=...)).
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
// and there is no reduction across channels, so neither __dp4a nor the
// tensor cores apply and the work is tiny beside the bytes: at
// mobilenet_tiny's 224x224 shapes (112x112x16 and smaller) each layer moves
// well under 1 MB, a fraction of a microsecond of HBM time, so a launch is
// bound by its own overhead.  The design is a direct conv: one thread per
// (output pixel, output channel), channel fastest, so that a warp's loads
// of input, weights, skip and its stores run along contiguous NHWC
// channels.  A fused pool is computed on the thread's whole window, each
// tap's conv recomputed (KH*KW multiply-adds, cheap here), so overlapping
// windows such as 3x3/2 need no exchange between threads.
#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int kThreads = 256;

struct DwArgs {
  const int8_t* x;  // (N, Hp, Wp, Cin)
  const int8_t* w;  // (KH, KW, 1, Cout) == (KH * KW, Cout)
  int8_t* y;        // (N, OH, OW, c_tot)
  Epilogue ep;
  int n, hp, wp, cin, kh, kw, cout, m, sh, sw;
  int ho, wo, oh, ow;  // conv and output (pooled) geometry
  int pw, ps;          // pool window and stride; 1, 1 without a pool
  int c_tot, out_off;
};

__global__ void __launch_bounds__(kThreads) qdwconv_kernel(DwArgs a) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(a.n) * a.oh * a.ow * a.cout) return;
  const int c = static_cast<int>(idx % a.cout);
  const long long pix = idx / a.cout;  // output (pooled) pixel
  const int ox = static_cast<int>(pix % a.ow);
  const int oy = static_cast<int>((pix / a.ow) % a.oh);
  const int img = static_cast<int>(pix / (static_cast<long long>(a.ow) * a.oh));
  const int8_t* xc = a.x + (c / a.m);
  const int8_t* wc = a.w + c;

  int best = -128;  // every epilogue value lies in [-128, 127]
  for (int py = 0; py < a.pw; ++py) {
    for (int px = 0; px < a.pw; ++px) {
      const int ch = oy * a.ps + py;  // conv output pixel of this pool tap
      const int cw = ox * a.ps + px;
      const long long base =
          ((static_cast<long long>(img) * a.hp + ch * a.sh) * a.wp +
           cw * a.sw) * a.cin;
      uint32_t acc = 0;  // int32 sum with wrap, as the reference's
      for (int i = 0; i < a.kh; ++i) {
        const long long row = base + static_cast<long long>(i) * a.wp * a.cin;
        for (int j = 0; j < a.kw; ++j) {
          const int xv = xc[row + static_cast<long long>(j) * a.cin];
          const int wv = wc[(i * a.kw + j) * a.cout];
          acc += static_cast<uint32_t>(xv * wv);
        }
      }
      const long long skip_at =
          ((static_cast<long long>(img) * a.ho + ch) * a.wo + cw) * a.cout + c;
      best = max(best, epilogue(a.ep, static_cast<int32_t>(acc), c, skip_at));
    }
  }
  a.y[pix * a.c_tot + a.out_off + c] = static_cast<int8_t>(best);
}

}  // namespace

// Launch the depthwise conv.  Pointers may be null where DwArgs and
// Epilogue say so.  The wrapper checks every shape, type and range (Cout is
// a multiple of Cin).  Returns cudaGetLastError().
extern "C" int qdwconv_s8(const void* x, const void* w, const void* bias,
                          const void* shift_vec, const void* skip, void* y,
                          int n, int hp, int wp, int cin, int kh, int kw,
                          int cout, int sh, int sw, int pw, int ps, int shift,
                          int relu, int a_conv, int a_skip, int merge_shift,
                          int merge_relu, int concat_shift, int concat_relu,
                          int c_tot, int out_off, void* stream) {
  DwArgs a;
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
  a.cout = cout; a.m = cout / cin; a.sh = sh; a.sw = sw;
  a.ho = (hp - kh) / sh + 1;
  a.wo = (wp - kw) / sw + 1;
  a.pw = pw; a.ps = ps;
  a.oh = (a.ho - pw) / ps + 1;
  a.ow = (a.wo - pw) / ps + 1;
  a.c_tot = c_tot; a.out_off = out_off;
  const long long total = static_cast<long long>(n) * a.oh * a.ow * cout;
  if (total > 0) {
    const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads));
    qdwconv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
