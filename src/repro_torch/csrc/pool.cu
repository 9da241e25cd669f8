// Standalone int8 NHWC max-pool: ONNX MaxPool with a square window, one
// stride and asymmetric pads (top, left, bottom, right), the pads taking
// INT8_MIN, the identity of max.
//
// Replaces no Pallas kernel: the JAX package's standalone pools were plain
// array ops (reduce_window), and the port ran them as torch ops, a padded
// copy filled with INT8_MIN, then an amax over an unfold view of the
// windows (kernels/ref.py:maxpool2d_ref, still the plain version and the
// CPU path).  Added because that became three device operations and most
// of a residual net's batch: ResNet-18's padded 3x3/2 pool at batch 512
// took 2.32 ms of a 10-ms batch.
//
// What bounds it on the H100: bytes.  Each output value is the max of at
// most window^2 bytes, no arithmetic to speak of, so the least time is the
// input read once and the output written once: ResNet-18's stage reads
// 512x112x112x64 = 411 MB and writes 512x56x56x64 = 103 MB, 0.153 ms at
// 3.35 TB/s.  The design:
// * One pass, no padded copy.  A thread owns one output pixel and one
//   chunk of its channels, walks the window's taps and skips each tap
//   outside the unpadded input: a bounds check on (ih, iw) takes the place
//   of the pad.  Its running max starts at INT8_MIN, so a window made only
//   of pads gives INT8_MIN, as the padded copy did.
// * Chunks as wide as the input allows, chosen by the wrapper
//   (kernels/pool.py:chunk_width): 16 bytes (a uint4, four __vmaxs4 a
//   tap) where C is a multiple of 16 and both pointers are 16-byte
//   aligned, 4 (one __vmaxs4) where C and the pointers allow 4, else one
//   byte.  Neighbouring threads take neighbouring chunks of a pixel, then
//   neighbouring pixels, so each warp's loads and stores coalesce; the
//   taps that overlapping windows share are read again from L1 or L2, not
//   from device memory.
// * blockIdx.y walks the images, so the offsets inside an image take 32
//   bits (the wrapper refuses an image of 2^31 bytes or more) and an
//   image's origin takes 64: ResNet-18's stage at batch 512 is already
//   411 M bytes.
// * It launches on the caller's stream, allocates nothing and never
//   synchronizes, so a CUDA graph captures it as one kernel node.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// A chunk of kWidth int8 channels: its type, INT8_MIN in every lane, and
// the lane-wise signed max.
template <int kWidth> struct Chunk;

template <> struct Chunk<16> {
  using T = uint4;
  static __device__ __forceinline__ T lowest() {
    return make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
  }
  static __device__ __forceinline__ T max(T a, T b) {
    return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                      __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
  }
};

template <> struct Chunk<4> {
  using T = uint32_t;
  static __device__ __forceinline__ T lowest() { return 0x80808080u; }
  static __device__ __forceinline__ T max(T a, T b) { return __vmaxs4(a, b); }
};

template <> struct Chunk<1> {
  using T = int8_t;
  static __device__ __forceinline__ T lowest() { return INT8_MIN; }
  static __device__ __forceinline__ T max(T a, T b) { return a > b ? a : b; }
};

// y (n, oh, ow, c) = the max over each window of x (n, h, w, c).  Thread
// `item` of the x grid owns output chunk `item` of each image it visits:
// pixel item / (c / kWidth), chunk item % (c / kWidth).
template <int kWidth>
__global__ void __launch_bounds__(kThreads)
maxpool_nhwc_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ y,
                    int n, int h, int w, int c, int window, int stride,
                    int pad_t, int pad_l, int oh, int ow) {
  using C = Chunk<kWidth>;
  using T = typename C::T;
  const int chunks = c / kWidth;
  const int item = blockIdx.x * kThreads + threadIdx.x;
  if (item >= oh * ow * chunks) return;
  const int pix = item / chunks;
  const int r = pix / ow;
  const int ih0 = r * stride - pad_t;
  const int iw0 = (pix - r * ow) * stride - pad_l;
  const int row_chunks = w * chunks;
  for (int img = blockIdx.y; img < n; img += gridDim.y) {
    const T* origin = reinterpret_cast<const T*>(
        x + static_cast<long long>(img) * h * w * c) + (item - pix * chunks);
    T acc = C::lowest();
    for (int dh = 0; dh < window; ++dh) {
      const int ih = ih0 + dh;
      if (ih < 0 || ih >= h) continue;
      const T* row = origin + ih * row_chunks;
      for (int dw = 0; dw < window; ++dw) {
        const int iw = iw0 + dw;
        if (iw < 0 || iw >= w) continue;
        acc = C::max(acc, row[iw * chunks]);
      }
    }
    reinterpret_cast<T*>(y + static_cast<long long>(img) * oh * ow * c)[item] =
        acc;
  }
}

template <int kWidth>
int launch(const int8_t* x, int8_t* y, int n, int h, int w, int c,
           int window, int stride, int pad_t, int pad_l, int oh, int ow,
           cudaStream_t stream) {
  const int per_image = oh * ow * (c / kWidth);
  const dim3 grid((per_image + kThreads - 1) / kThreads,
                  n < kMaxGridY ? n : kMaxGridY);
  maxpool_nhwc_kernel<kWidth><<<grid, kThreads, 0, stream>>>(
      x, y, n, h, w, c, window, stride, pad_t, pad_l, oh, ow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, h, w, c) int8 contiguous, y (n, oh, ow, c) int8 contiguous, oh and
// ow as ONNX's floor rule gives them from the four pads; `width` the
// chunk (16, 4 or 1 bytes), which c and both pointers must allow.  Returns
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int maxpool_s8(const void* x, void* y, int n, int h, int w, int c,
                          int window, int stride, int pad_t, int pad_l,
                          int oh, int ow, int width, void* stream) {
  const auto xa = reinterpret_cast<uintptr_t>(x);
  const auto ya = reinterpret_cast<uintptr_t>(y);
  if (n < 0 || h < 0 || w < 0 || c < 0 || window < 1 || stride < 1
      || pad_t < 0 || pad_l < 0 || oh < 0 || ow < 0
      || (width != 1 && width != 4 && width != 16) || c % width != 0
      || xa % width != 0 || ya % width != 0
      || static_cast<long long>(h) * w * c >= (1LL << 31)
      || static_cast<long long>(oh) * ow * c >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || oh == 0 || ow == 0 || c == 0) return 0;
  const auto* xs = static_cast<const int8_t*>(x);
  auto* ys = static_cast<int8_t*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 16)
    return launch<16>(xs, ys, n, h, w, c, window, stride, pad_t, pad_l, oh,
                      ow, st);
  if (width == 4)
    return launch<4>(xs, ys, n, h, w, c, window, stride, pad_t, pad_l, oh,
                     ow, st);
  return launch<1>(xs, ys, n, h, w, c, window, stride, pad_t, pad_l, oh, ow,
                   st);
}
