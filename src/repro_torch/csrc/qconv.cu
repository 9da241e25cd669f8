// Dense int8 conv with the fused requant / ReLU / residual-skip / concat /
// max-pool epilogue: the conv stage of the int8 CNN path.
//
// Replaces the Pallas kernels of src/repro/kernels/qconv.py: qconv2d
// (pallas_call at :619; _qconv_band_kernel + _band_epilogue), its
// concat-buffer variant _qconv2d_into (:453; qconv2d(out_buf=...)) and the
// ragged grouped conv qgconv2d (:945), which runs the same band body once
// per group.
//
// Semantics, per output channel c of a conv over the NHWC input zero-padded
// by (pt, pl, pb, pr) rows and columns (ONNX's top, left, bottom, right;
// strides sh, sw; HWIO weights): v = epilogue(acc, c) (requant.cuh:
// bias, requant, the ReLU and clip as one clamp, then the skip and concat
// steps), then
// y = max over the pool window of v, and y lands in channels
// [out_off, out_off + Cout) of an output whose channel stride is c_tot (the
// shared concat buffer, updated in place; its other channels are never
// touched), or of a plain (N, OH, OW, Cout) tensor when c_tot == Cout and
// out_off == 0.
//
// Groups (1 when dense): group g reads input channels
// [g*Cin/G, (g+1)*Cin/G) of each pixel and owns output channels
// [g*Cout/G, (g+1)*Cout/G); its contraction is K = KH*KW*Cin/G against
// those weight columns.  P neighbouring groups (`pack`, chosen in
// kernels/qconv.py:groups_per_tile: the most whose P*Cout/G fits the
// 64-wide tile) run as one group of P*Cin/G inputs and P*Cout/G outputs
// whose K-major weight is block-diagonal: row c holds its weights at the
// inputs of its own group and zeros at the other P - 1 groups' (staged so
// by kernels/qconv.py:stage_kmajor), so the sums are exact.  The packed
// groups ride gridDim.z, and each block's channel tiles are masked at a
// packed group's edge, so no tile mixes two of them.  A block's cost is
// mostly fixed (prologue, weight boxes, the epilogue over its whole tile),
// so it is paid once for P groups: a block of ResNeXt-50's first stage (4
// channels a group, P = 16) computes 64 columns over K = 9 * 64 = 576 (5 K
// steps), gathers A by 16-byte cp.async and stores 16 bytes at a time.
// Packing within the 64-wide tile adds no tensor-core work: an unpacked
// group narrower than the tile computes the masked columns all the same.
// Grouped launches
// (G > 1, packed or not, even where G/P is 1) take
// qconv_grouped_wgmma_kernel, the same body as the dense
// qconv_wgmma_kernel under a name of its own, so that a device trace
// tells the two routes apart.
//
// The kernel is an implicit GEMM: rows are (pooled pixel, window tap)
// pairs, columns output channels, the contraction runs over (kh, kw, ci).
// With the rows in that order a block owns whole pool windows, so the
// fused max-pool never crosses blocks: a tap shared by two of AlexNet's
// overlapping 3x3/2 windows is computed once for each (2.25x the conv
// work; none extra for VGG's 2x2/2).  The epilogue writes the block's int8
// values to shared memory, and the block then reduces each window and
// stores the pooled row.  Every dense and grouped conv takes it, down to
// googlenet_tiny's 4-channel convs: a group (packed or not) narrower than
// the tile masks the columns past its edge.
//
// What bounds it on the H100: the conv layers of VGG-16 and AlexNet reuse
// every input byte KH*KW*Cout times and every weight byte once per output
// pixel, so they are bound by operations (int8 tensor cores, 1,979 TOPS
// dense) at every batch; at batch 1 the late 14x14 layers are too small
// to fill 132 SMs, and launch latency is the floor.
//
// What the design does about it (qconv_wgmma_kernel):
// * The product runs on the int8 tensor cores: wgmma m64nNk32 s8.s8 with
//   int32 accumulators in registers, two warpgroups of 64 rows (a 128-row
//   tile), N = 128 output channels (64 for narrow convs).  Integer sums
//   are exact in any order, so the result is bit for bit the plain
//   version's whatever the tiling or K split.
// * int8 wgmma takes both operands K-major.  HWIO weights are N-major, so
//   the wrapper stages them once as a (Cout, K_pad) matrix, K zero-padded
//   to the 128-byte K tile (kernels/qconv.py:stage_kmajor); TMA loads a
//   (BN x 128-byte) box of it per K step, in the 128-byte swizzle that the
//   wgmma descriptor names, through a ring of kStages mbarrier stages.
// * A, the im2col rows, is gathered by all 256 threads into the same
//   swizzled layout (Cin/G of the packed group): 16-byte cp.async where
//   Cin/G % 16 == 0 (every VGG layer but the first, AlexNet's groups of 48
//   and 192, ResNeXt-50's packed groups of 64), 4-byte cp.async
//   where Cin/G % 4 == 0, and the narrow gather otherwise (the Cin-3 stems,
//   Cin 6, Cin/G 9; also any input whose pointer is not 4-byte aligned);
//   zero past K and past the last row.  The padding is never stored: a row
//   records its window's origin in the unpadded input, which may lie above
//   or left of it, and a tap outside the image reads as zero (a cp.async of
//   source size 0, as past K).  A cp.async chunk lies within one tap, since
//   Cin/G is a multiple of its width, so a thread finds its chunk's tap once
//   a K step and tests it for each row.  The ring keeps kStages - 1 K steps
//   in flight while the tensor cores work on the current one, and two
//   blocks fit an SM, so that one's gather and epilogue overlap the
//   other's products.
// * The narrow gather (narrow_chunk) does no division per byte: a K step
//   is 8 chunks of 16 bytes, and a thread owns one chunk (of the fewest
//   power-of-two chunks that hold the step's data, so that VGG-16's
//   27-byte K keeps every thread busy) in every row it walks.  It works
//   out its chunk's 16 input offsets once a step, walking (kh, kw, ci) a
//   byte at a time from one division pair, so no table bounds K; then, 4
//   rows in flight, it loads each row's 16 bytes (ld.global.nc) and stores
//   them with one 16-byte store.  A row whose window crosses the image's
//   border loads only the bytes inside it: a 16-bit mask of them, made
//   without a division from the kh rows the chunk meets (border_mask), so
//   its loads stay in flight beside the other rows'.  (A second pass over
//   the border rows, walking each byte's tap, put a second round of load
//   latency on every block that has one: the stems took 13-39 % longer.)
//   It is an instantiation of its own (kNarrow): inlined beside the
//   cp.async gathers it took their registers and cost the other convs
//   1-2 %.  On the H100 (700 W) AlexNet's 11x11/4
//   stem at batch 64 went from 0.841 ms (a division pair and a modulo per
//   byte) to 0.227; with its loads taken out the kernel still takes 0.128,
//   so the fixed cost of its 3,333 small-K blocks (weights, rows,
//   epilogue, pool) now bounds it beside the byte loads' L1 traffic.
//   Aligned word loads with a funnel shift, for the 4 bytes that lie in
//   one kh run, were no faster: which words qualify differs between a
//   warp's chunks, so the warp runs both paths.  Both narrow instances
//   take 128 registers; the 128-column one (no stem of the benchmark's)
//   spills 24 bytes.
// * The 16-byte gather's thread walks the same 4 rows at every K step and
//   keeps their windows in registers: read from shared memory a step, with
//   the border test, they cost VGG-16's convs 4-12 %.
// * The first weight boxes are requested before the block works out its
//   rows, and the tile's bias and per-lane shifts go to shared memory
//   meanwhile.
// * Where the tile grid is under one wave (the 14x14 and 28x28 layers at
//   batch 1), the K tiles are split across blocks (gridDim.z, at most 8):
//   the splits of a tile run as one thread-block cluster.  Each block
//   stages its int32 sums in its shared memory; then each adds the
//   others' sums over its own share of the tile's pool windows through
//   distributed shared memory and finishes those windows, so that the
//   reduction and the epilogue are spread over the cluster.  The split is
//   chosen in kernels/qconv.py:plan.
// * The epilogue runs over the int32 tile staged in shared memory, one
//   (row, channel) pair a thread at a time, and pooled rows leave in
//   16-byte stores where the output's offset allows.
//
// The trial form (`trials` T > 1) is what the JAX package's qconv2d,
// _qconv2d_into and qgconv2d become under jax.vmap in an SER campaign
// (src/repro/core/ser.py:315): trial t convolves its own N images of the
// (T*N, H, W, Cin) input, and writes its own N images of the output,
// with its own weight image, rows [t*Cout, (t+1)*Cout) of a K-major stack
// (T*Cout, K_pad); biases and shifts are shared.  The trial rides
// gridDim.x beside the trial's row tiles, so a tile, which reads one
// weight image, never holds rows of two trials, and the K splits of a
// cluster (gridDim.z) never straddle two trials.  Columns a weight box
// reads past Cout belong to the next trial's image, as past a group's
// edge they belong to the next group: they are masked in the epilogue.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "requant.cuh"

namespace {

struct ConvArgs {
  const int8_t* x;          // (N, H, W, Cin), unpadded
  const int8_t* wk;         // (Cout, k_pad), K-major
  int8_t* y;                // (N, OH, OW, c_tot)
  Epilogue ep;
  int n, h, w, cin, kh, kw, cout, sh, sw;  // n: images of one trial
  int pt, pl;               // zero rows above, columns left of the input
  int cin_g, cout_g;         // channels of one group
  int ho, wo, oh, ow;       // conv and output (pooled) geometry
  int pw, ps;               // pool window and stride; 1, 1 without a pool
  int c_tot, out_off;
  int k_pad, splits, chunk;  // padded K, K split, K tiles a split
  int mode;                 // A gather: 16- or 4-byte cp.async, 1: narrow
  int wide;                 // c_tot, out_off and y allow 16-byte stores
  int m_tiles;              // row tiles of one trial
};

// The conv pixel that GEMM row `row` of block `blk` computes, for blocks of
// `rows` rows, or false when the row lies past the last pooled pixel.
__device__ __forceinline__ bool row_pixel(const ConvArgs& a, int blk, int row,
                                          int rows, int* img, int* ch,
                                          int* cw) {
  const int taps = a.pw * a.pw;
  const int per_block = rows / taps;
  if (row >= per_block * taps) return false;
  const int pooled = blk * per_block + row / taps;  // < 2^31 (the wrapper)
  if (pooled >= a.n * a.oh * a.ow) return false;
  const int tap = row % taps;
  const int plane = a.oh * a.ow;
  *img = pooled / plane;
  const int rem = pooled - *img * plane;
  *ch = (rem / a.ow) * a.ps + tap / a.pw;
  *cw = (rem % a.ow) * a.ps + tap % a.pw;
  return true;
}

// The window origin of a row past the last window: every tap of it lies
// outside the image, so its gathers read zeros.
constexpr int kFar = -(1 << 29);

// Whether tap (kh, kw) of the window whose origin is input pixel org lies
// inside the image; outside it, the tap is the conv's zero padding.
__device__ __forceinline__ bool tap_in(const ConvArgs& a, int2 org, int kh,
                                       int kw) {
  return static_cast<unsigned>(org.x + kh) < static_cast<unsigned>(a.h) &&
         static_cast<unsigned>(org.y + kw) < static_cast<unsigned>(a.w);
}

// Whether every tap of the window whose origin is org lies inside the image.
__device__ __forceinline__ bool interior(const ConvArgs& a, int2 org) {
  return org.x >= 0 && org.x <= a.h - a.kh && org.y >= 0 &&
         org.y <= a.w - a.kw;
}

// Offset of contraction byte k (over (kh, kw, ci) within the group) from
// its window's first byte, and the tap (kh, kw) it lies in.
__device__ __forceinline__ long long k_offset(const ConvArgs& a, int k,
                                              int* kh, int* kw) {
  const int t = k / a.cin_g;
  const int ci = k - t * a.cin_g;
  *kh = t / a.kw;
  *kw = t - *kh * a.kw;
  return (static_cast<long long>(*kh) * a.w + *kw) * a.cin + ci;
}

// The narrow gather's offsets: o[e] is k_offset of contraction byte k0 + e
// (past K too: those bytes are never loaded); byte k0 lies in kh row kh0 of
// the window, p0 bytes into its KW * Cin/G.  One division pair, then (kh,
// kw, ci) walks a byte at a time: past the group's last channel to the next
// tap, past the last tap of a kh row to the next row (the wrapper keeps
// ((KH+1)*W + KW)*Cin below 2^31).
__device__ __forceinline__ void chunk_offsets(const ConvArgs& a, int k0,
                                              int (&o)[16], int* kh0,
                                              int* p0) {
  const int t = k0 / a.cin_g;
  int ci = k0 - t * a.cin_g, kw = t % a.kw;
  *kh0 = t / a.kw;
  *p0 = k0 - *kh0 * a.kw * a.cin_g;
  int off = (*kh0 * a.w + kw) * a.cin + ci;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    o[e] = off++;
    if (++ci == a.cin_g) {
      ci = 0;
      off += a.cin - a.cin_g;
      if (++kw == a.kw) {
        kw = 0;
        off += (a.w - a.kw) * a.cin;
      }
    }
  }
}

// The bits e of a narrow chunk (contraction bytes k0 + e, from
// chunk_offsets' kh0 and p0) whose taps lie inside the image, for a border
// row whose window starts at input pixel org.  A kh row of the window is a
// run of KW * Cin/G bytes, and the chunk starts p0 bytes into row kh0; the
// rows kh in [kh_lo, kh_hi) lie inside the image, and of each the bytes
// [b0, b1), the taps kw in [kw_lo, kw_hi).  No division, and no walk a
// byte at a time: a mask of each kh row the chunk meets.  A row past the
// last window (org kFar) gets no bit.
__device__ __forceinline__ uint32_t border_mask(const ConvArgs& a, int2 org,
                                                int kh0, int p0) {
  const int kh_lo = max(0, -org.x), kh_hi = min(a.kh, a.h - org.x);
  const int b0 = max(0, -org.y) * a.cin_g;
  const int b1 = min(a.kw, a.w - org.y) * a.cin_g;
  const int run = a.kw * a.cin_g;
  uint32_t m = 0;
  for (int kh = kh0, e0 = -p0; e0 < 16; ++kh, e0 += run) {
    const int lo = max(e0 + b0, 0), hi = min(e0 + b1, 16);
    if (kh >= kh_lo && kh < kh_hi && lo < hi)
      m |= ((1u << hi) - 1) & ~((1u << lo) - 1);
  }
  return m;
}

// The 16 bytes at p + o[e] whose bit e of mask is set (0 for the others),
// packed little-endian.
__device__ __forceinline__ uint4 narrow_chunk(const int8_t* p,
                                              const int (&o)[16],
                                              uint32_t mask) {
  const uint8_t* const b = reinterpret_cast<const uint8_t*>(p);
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (mask & (1u << (4 * j + i)))
        w |= static_cast<uint32_t>(__ldg(b + o[4 * j + i])) << (8 * i);
    v[j] = w;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// ------------------------------------------------- int8 tensor cores (wgmma)

namespace tc {

using namespace sm90;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kRows = 128;     // GEMM rows of a block: 64 a warpgroup
constexpr int kBK = 128;       // K bytes a stage: one 128-byte swizzle row
constexpr int kATile = kRows * kBK;
constexpr int kMaxSplits = 8;  // K splits of a tile: one portable cluster

// A ring of 4 stages at 64 channels, 3 at 128: two blocks fit an SM's
// shared memory either way.
template <int BN>
struct Tile {
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kBTile = BN * kBK;
  static constexpr int kStage = kATile + kBTile;
  static constexpr int kAcc = BN / 2;  // int32 sums a thread
  static constexpr size_t kSmem = kStages * kStage + 1024;  // + alignment
  // the epilogue's int32 tile (rows padded by 8 words) and int8 tile
  static_assert(kRows * (BN + 8) * 4 + kRows * BN <= kStages * kStage,
                "the epilogue's tiles must fit the drained stages");
};

// Byte offset of chunk `c` (16 bytes) of row r in a tile of 128-byte rows
// in the layout of TMA's 128-byte swizzle, which the descriptor names.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// The epilogue over rows [ra, rb) of the staged int32 tile `sums` into
// the int8 tile `ys`.  A thread keeps four columns and walks their rows
// four at a time, every load of a pass before any store, so that nothing
// serialises them.  Its columns' biases are added to the sums first and
// each column's shift is passed as the scalar one, so that epilogue()
// reads nothing per value but the skip (requant adds the bias the same
// way, with wrap_add, before the shift).  kMerge false is the path with no
// skip and no concat step: those fields are constants there, so the
// compiler drops their code from the unchanged epilogue().
template <int BN, bool kMerge>
__device__ __forceinline__ void epilogue_rows(
    const ConvArgs& a, const int32_t* sums, int8_t* ys,
    const long long* row_pix, const int32_t* s_bias, const int32_t* s_shift,
    int ra, int rb, int ncols, int cg0) {
  constexpr int kLd = BN + 8;
  constexpr int kQuad = BN / 4;            // four-column groups a row
  constexpr int kStep = kThreads / kQuad;  // rows apart in one pass
  const int c4 = 4 * (threadIdx.x % kQuad);
  Epilogue ep = a.ep;
  ep.bias = nullptr;
  ep.shift_vec = nullptr;
  if (!kMerge) {
    ep.skip = nullptr;
    ep.concat_shift = 0;
    ep.concat_relu = 0;
  }
  int32_t bias[4];
  int shift[4];
  bool ok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bias[e] = s_bias[c4 + e];
    shift[e] = s_shift[c4 + e];
    ok[e] = c4 + e < ncols;
  }
  for (int r0 = ra + static_cast<int>(threadIdx.x) / kQuad; r0 < rb;
       r0 += 4 * kStep) {
    int4 sum[4];
    long long pix[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = min(r0 + kStep * u, rb - 1);
      sum[u] = *reinterpret_cast<const int4*>(sums + r * kLd + c4);
      pix[u] = row_pix[r];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int32_t s4[4] = {sum[u].x, sum[u].y, sum[u].z, sum[u].w};
      uint32_t packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int32_t v = 0;
        if (pix[u] >= 0 && ok[e]) {
          ep.shift = shift[e];
          v = epilogue(ep, wrap_add(s4[e], bias[e]), c4 + e,
                       pix[u] * a.cout + cg0 + c4 + e);
        }
        packed |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * e);
      }
      if (r0 + kStep * u < rb)
        *reinterpret_cast<uint32_t*>(ys + (r0 + kStep * u) * BN + c4) = packed;
    }
  }
}

// The body of both kernels below.  kNarrow: the narrow gather (mode 1), an
// instantiation of its own so that its unrolled loads stay out of the
// cp.async gathers' main loop.
template <int BN, bool kNarrow>
__device__ __forceinline__ void conv_tile(const CUtensorMap& map_w,
                                          const ConvArgs& a) {
  using T = Tile<BN>;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[kStages];
  __shared__ long long row_off[kRows];  // window's first input byte
  __shared__ int2 row_org[kRows];       // window's first pixel (ih, iw)
  __shared__ long long row_in[kRows];   // row_off if interior(), else -1
  __shared__ long long row_pix[kRows];  // conv pixel (N, Ho, Wo) index
  __shared__ int32_t s_bias[BN], s_shift[BN];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  uint8_t* const base_ptr = smem_raw + (base - raw);
  auto a_tile = [&](int s) { return base + s * T::kStage; };
  auto b_tile = [&](int s) { return base + s * T::kStage + kATile; };
  auto bar = [&](int s) { return smem_u32(&bars[s]); };

  const int tid = threadIdx.x;
  const int trial = blockIdx.x / a.m_tiles;
  const int blk = blockIdx.x - trial * a.m_tiles;  // row tile of the trial
  const int g = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  const int c0 = blockIdx.y * BN;       // within the group
  const int cg0 = g * a.cout_g + c0;    // weight row / output channel
  const int w_row0 = trial * a.cout + cg0;  // in the trials' weight stack
  const int k_total = a.kh * a.kw * a.cin_g;
  const int kt0 = split * a.chunk;
  const int n_k = min(a.chunk, a.k_pad / kBK - kt0);

  // K step j of this split into stage j % kStages: B by TMA (one thread),
  // A gathered by every thread; always one cp.async group, so that the
  // waits count
  auto load_b = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(bar(s), T::kBTile);
    tma_load(b_tile(s), &map_w, bar(s), (kt0 + j) * kBK, w_row0);
  };
  // the 16-byte gather's rows: a thread walks the same kRows / 32 rows at
  // every K step, so it keeps their windows in registers
  long long g_off[kRows / 32];
  int2 g_org[kRows / 32];
  auto load_a = [&](int j) {
    const int s = j % kStages;
    const int kb = (kt0 + j) * kBK;  // first K byte of the step
    const uint32_t at = a_tile(s);
    if (kNarrow) {
      // the chunks that hold data, rounded up to a power of two so that a
      // thread keeps its chunk over its rows; the others are zeros
      uint8_t* const tile = base_ptr + (at - base);
      const int kv = k_total - kb;
      int nc = 1;
      while (nc < 8 && 16 * nc < kv) nc <<= 1;
      const int c = tid & (nc - 1);
      int o[16], kh0, p0;
      chunk_offsets(a, kb + 16 * c, o, &kh0, &p0);
      const int kv_c = kv - 16 * c;  // bytes of the chunk within K
      const uint32_t kmask = kv_c >= 16 ? 0xffffu : (1u << max(kv_c, 0)) - 1;
      // 4 rows in flight; a border row (or one past the last window) loads
      // only the bytes inside the image
#pragma unroll 4
      for (int r = tid / nc; r < kRows; r += kThreads / nc) {
        long long ro = row_in[r];
        uint32_t mask = kmask;
        if (ro < 0) {
          ro = row_off[r];
          mask &= border_mask(a, row_org[r], kh0, p0);
        }
        *reinterpret_cast<uint4*>(tile + sw128(r, c)) =
            narrow_chunk(a.x + ro, o, mask);
      }
      for (int idx = tid; idx < kRows * 8; idx += kThreads)
        if ((idx & 7) >= nc)
          *reinterpret_cast<uint4*>(tile + sw128(idx >> 3, idx & 7)) =
              make_uint4(0, 0, 0, 0);
    } else if (a.mode == 16) {
      const int c = tid & 7;
      const int k = kb + 16 * c;
      const bool kin = k < k_total;
      int kh = 0, kw = 0;
      const long long ko = kin ? k_offset(a, k, &kh, &kw) : 0;
#pragma unroll
      for (int m = 0; m < kRows / 32; ++m) {
        const int r = (tid >> 3) + 32 * m;
        const bool ok = kin && tap_in(a, g_org[m], kh, kw);
        cp_async16(at + sw128(r, c), ok ? a.x + g_off[m] + ko : a.x,
                   ok ? 16 : 0);
      }
    } else {
      const int wd = tid & 31;
      const int k = kb + 4 * wd;
      const bool kin = k < k_total;
      int kh = 0, kw = 0;
      const long long ko = kin ? k_offset(a, k, &kh, &kw) : 0;
#pragma unroll 4
      for (int m = 0; m < kRows / 8; ++m) {
        const int r = (tid >> 5) + 8 * m;
        const long long ro = row_off[r];
        const bool ok = kin && tap_in(a, row_org[r], kh, kw);
        cp_async4(at + sw128(r, wd >> 2) + 4 * (wd & 3),
                  ok ? a.x + ro + ko : a.x, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // the first weight boxes go out before anything else; meanwhile the
  // other threads find each row's window (its first pixel, which lies
  // outside the image where the padding does, and the group's first
  // channel there) and stage the tile's bias and shifts
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < kStages - 1 && j < n_k; ++j) load_b(j);
  }
  if (tid < kRows) {
    int img, ch, cw;
    const bool valid = row_pixel(a, blk, tid, kRows, &img, &ch, &cw);
    img += trial * a.n;  // the image in the whole (trials * n) batch
    const int2 org = valid ? make_int2(ch * a.sh - a.pt, cw * a.sw - a.pl)
                           : make_int2(kFar, kFar);
    const long long off =
        valid ? ((static_cast<long long>(img) * a.h + org.x) * a.w + org.y)
                        * a.cin + g * a.cin_g
              : 0;
    row_org[tid] = org;
    row_off[tid] = off;
    row_in[tid] = interior(a, org) ? off : -1;
    row_pix[tid] =
        valid ? (static_cast<long long>(img) * a.ho + ch) * a.wo + cw : -1;
  } else if (tid - kRows < BN) {
    const int c = tid - kRows;
    const bool in = c0 + c < a.cout_g;
    s_bias[c] = a.ep.bias != nullptr && in ? a.ep.bias[cg0 + c] : 0;
    s_shift[c] = a.ep.shift_vec != nullptr && in ? a.ep.shift_vec[cg0 + c]
                                                 : a.ep.shift;
  }
  __syncthreads();
  if (!kNarrow) {
#pragma unroll
    for (int m = 0; m < kRows / 32; ++m) {
      g_off[m] = row_off[(tid >> 3) + 32 * m];
      g_org[m] = row_org[(tid >> 3) + 32 * m];
    }
  }

  const int wg = tid >> 7;
  int32_t acc[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0;

  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_k) load_a(j);
    else cp_async_commit();
  }
  for (int j = 0; j < n_k; ++j) {
    const int s = j % kStages;
    // this thread's A bytes of step j are in; make them (and the plain
    // stores of the narrow gather) visible to wgmma, then wait for all
    // threads: every warpgroup's step j - 1 products are done, so that
    // stage is free
    cp_async_wait<kStages - 2>();
    fence_async_smem();
    __syncthreads();
    mbar_wait(bar(s), (j / kStages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8(acc, sw128_desc(a_tile(s) + wg * 64 * 128 + kk * 32, 16, 1024),
               sw128_desc(b_tile(s) + kk * 32, 16, 1024));
    wgmma_commit();
    // step j + kStages - 1 goes into step j - 1's stage while the tensor
    // cores run
    if (j + kStages - 1 < n_k) {
      load_a(j + kStages - 1);
      if (tid == 0) load_b(j + kStages - 1);
    } else {
      cp_async_commit();
    }
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  // epilogue: the int32 sums go to shared memory in their fragment
  // layout (a thread holds rows r0 and r0 + 8 of its warp's 16, and of
  // each 8 columns the pair 2 (lane % 4), + 1; rows padded by 8 words
  // against bank conflicts), then a short loop applies the epilogue into
  // the int8 tile ys.  The epilogue unrolled over every fragment register
  // instead is code enough to stall on instruction fetch.
  __syncthreads();  // every stage is drained: the tiles may take them
  constexpr int kLd = BN + 8;
  int32_t* const sums = reinterpret_cast<int32_t*>(base_ptr);  // (kRows, kLd)
  int8_t* const ys =
      reinterpret_cast<int8_t*>(base_ptr + kRows * kLd * 4);  // (kRows, BN)
  {
    const int lane = tid & 31;
    const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int col0 = 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
        *reinterpret_cast<int2*>(sums + (r0 + 8 * h) * kLd + 8 * jn + col0) =
            make_int2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
  }

  // The pool windows this block finishes: all of them, or with a K split
  // its share of them.  The splits of a tile form one cluster (rank =
  // split); each block adds every other block's sums over its windows'
  // rows into its own through distributed shared memory, then finishes
  // those windows alone.
  const int taps = a.pw * a.pw;
  const int per_block = kRows / taps;
  const int w_share = (per_block + a.splits - 1) / a.splits;
  const int w0 = min(per_block, split * w_share);
  const int w1 = min(per_block, w0 + w_share);
  const int ra = w0 * taps, rb = w1 * taps;  // the rows of those windows
  if (a.splits > 1) {
    cluster_arrive();
    cluster_wait();  // every block's sums are staged
    for (int idx = tid; idx < (rb - ra) * (BN / 4); idx += kThreads) {
      const int r = ra + idx / (BN / 4), c = 4 * (idx % (BN / 4));
      int4* const mine = reinterpret_cast<int4*>(sums + r * kLd + c);
      const uint32_t at = smem_u32(mine);
      int4 v = *mine;
      int4 u[kMaxSplits];
#pragma unroll
      for (int o = 0; o < kMaxSplits; ++o)   // every load before any add
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
      *mine = v;
    }
    // done reading the others: they may leave once all have said so
    cluster_arrive();
  }
  __syncthreads();
  const int ncols = min(BN, a.cout_g - c0);
  if (a.ep.skip == nullptr && a.ep.concat_shift == 0 && a.ep.concat_relu == 0)
    epilogue_rows<BN, false>(a, sums, ys, row_pix, s_bias, s_shift, ra, rb,
                             ncols, cg0);
  else
    epilogue_rows<BN, true>(a, sums, ys, row_pix, s_bias, s_shift, ra, rb,
                            ncols, cg0);
  __syncthreads();

  // max over each window, 16 channels at a time (a byte-wise signed max
  // of four words); 16-byte stores where the destination allows
  const long long n_pooled = static_cast<long long>(a.n) * a.oh * a.ow;
  const long long pooled0 = trial * n_pooled;  // the trial's first output
  const bool wide = a.wide && (cg0 & 15) == 0;
  for (int idx = tid; idx < (w1 - w0) * (BN / 16); idx += kThreads) {
    const int p = w0 + idx / (BN / 16), q = idx % (BN / 16);
    const long long pooled = static_cast<long long>(blk) * per_block + p;
    if (pooled >= n_pooled || 16 * q >= ncols) continue;
    uint4 m = *reinterpret_cast<const uint4*>(ys + p * taps * BN + 16 * q);
    for (int t = 1; t < taps; ++t) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(ys + (p * taps + t) * BN + 16 * q);
      m.x = __vmaxs4(m.x, v.x);
      m.y = __vmaxs4(m.y, v.y);
      m.z = __vmaxs4(m.z, v.z);
      m.w = __vmaxs4(m.w, v.w);
    }
    int8_t* const dst =
        a.y + (pooled0 + pooled) * a.c_tot + a.out_off + cg0 + 16 * q;
    if (wide && 16 * q + 16 <= ncols) {
      *reinterpret_cast<uint4*>(dst) = m;
    } else {
      const int8_t* mb = reinterpret_cast<const int8_t*>(&m);
      for (int e = 0; e < min(16, ncols - 16 * q); ++e) dst[e] = mb[e];
    }
  }
  // the others may still read this block's sums until all are done
  if (a.splits > 1) cluster_wait();
}

// The dense conv (one group).
template <int BN, bool kNarrow>
__global__ void __launch_bounds__(kThreads, 2)
qconv_wgmma_kernel(const __grid_constant__ CUtensorMap map_w, ConvArgs a) {
  conv_tile<BN, kNarrow>(map_w, a);
}

// The grouped conv (1 < G, the groups on gridDim.z): the same body under a
// name of its own, so that a device trace tells its launches from the
// dense ones.
template <int BN, bool kNarrow>
__global__ void __launch_bounds__(kThreads, 2)
qconv_grouped_wgmma_kernel(const __grid_constant__ CUtensorMap map_w,
                           ConvArgs a) {
  conv_tile<BN, kNarrow>(map_w, a);
}

template <int BN, bool kNarrow>
int launch(ConvArgs a, int groups, int pack, int trials, cudaStream_t st) {
  // the K-major weight (stack) in boxes of 128 K bytes x BN rows (rows
  // past the last read as zero)
  CUtensorMap map;
  const int err =
      cached_u8_map(&map, a.wk, a.k_pad, trials * a.cout, a.k_pad, BN);
  if (err != 0) return err;
  const bool grouped = groups > 1;
  void (*const kernel)(CUtensorMap, ConvArgs) =
      grouped ? qconv_grouped_wgmma_kernel<BN, kNarrow>
              : qconv_wgmma_kernel<BN, kNarrow>;
  // the shared-memory allowance, set once a kernel and device
  static bool allowed[2][64] = {};
  int dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  if (dev >= 64 || !allowed[grouped][dev]) {
    cerr = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(Tile<BN>::kSmem));
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    if (dev < 64) allowed[grouped][dev] = true;
  }
  const long long n_pooled = static_cast<long long>(a.n) * a.oh * a.ow;
  const int per_block = kRows / (a.pw * a.pw);
  a.m_tiles = static_cast<int>((n_pooled + per_block - 1) / per_block);
  const dim3 grid(static_cast<unsigned>(trials) * a.m_tiles,
                  (a.cout_g + BN - 1) / BN, groups / pack * a.splits);
  if (a.splits == 1) {
    kernel<<<grid, kThreads, Tile<BN>::kSmem, st>>>(map, a);
  } else {
    // the K splits of a tile are one cluster, adjacent along z
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Tile<BN>::kSmem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = a.splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cerr = cudaLaunchKernelEx(&cfg, kernel, map, a);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Launch the conv over x (n, h, w, cin), zero-padded by pt rows above, pl
// columns left, pb rows below and pr columns right: the padding is taken in
// the A gathers, never stored.  Pointers may be null where ConvArgs and
// Epilogue say so.  The wrapper checks every shape, type and range (groups
// divides Cin and Cout) and plans the launch: `pack` groups (dividing
// `groups`) run as one, and wk is the weight K-major (Cout, k_pad) with the
// packed groups' weights block-diagonal, k_pad a multiple of 128, 16-byte
// aligned; bn (64 or 128)
// output channels a tile; `splits` (at most 8, a cluster) K splits of
// `chunk` K tiles.  mode is the A gather (16: 16-byte cp.async, Cin/G % 16
// == 0 and x 16-byte aligned; 4: 4-byte cp.async, Cin/G % 4 == 0 and x
// 4-byte aligned; else 1, the narrow gather); wide says that c_tot, out_off
// and y allow 16-byte stores.  With `trials` T > 1, x holds n = T *
// (images of a trial) images, wk is the trials' stack (T * Cout, k_pad)
// and y (and skip) hold n images: trial t's images against its own weight
// image.  Returns cudaGetLastError() or the error
// of encoding the weight's tensor map.
// `hi` is the upper end of the requant's clamp: 127, or a ReLU-n's clamp
// code; the wrapper holds it in [0, 127].
extern "C" int qconv_s8(const void* x, const void* wk, const void* bias,
                        const void* shift_vec, const void* skip, void* y,
                        int n, int h, int w, int cin, int kh, int kw,
                        int cout, int sh, int sw, int pw, int ps, int shift,
                        int relu, int hi, int a_conv, int a_skip,
                        int merge_shift, int merge_relu, int concat_shift,
                        int concat_relu, int c_tot, int out_off, int groups,
                        int pack, int bn,
                        int k_pad, int splits, int chunk, int mode, int wide,
                        int trials, int pt, int pl, int pb, int pr,
                        void* stream) {
  if (wk == nullptr || k_pad % tc::kBK != 0 || splits < 1
      || splits > tc::kMaxSplits || chunk < 1
      || (splits - 1) * chunk >= k_pad / tc::kBK || trials < 1
      || n % trials != 0 || pt < 0 || pl < 0 || pb < 0 || pr < 0
      || groups < 1 || pack < 1 || groups % pack != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.wk = static_cast<const int8_t*>(wk);
  a.y = static_cast<int8_t*>(y);
  a.ep.bias = static_cast<const int32_t*>(bias);
  a.ep.shift_vec = static_cast<const int32_t*>(shift_vec);
  a.ep.skip = static_cast<const int8_t*>(skip);
  a.ep.shift = shift; a.ep.lo = relu ? 0 : -128; a.ep.hi = hi;
  a.ep.a_conv = a_conv; a.ep.a_skip = a_skip;
  a.ep.merge_shift = merge_shift; a.ep.merge_relu = merge_relu;
  a.ep.concat_shift = concat_shift; a.ep.concat_relu = concat_relu;
  a.n = n / trials; a.h = h; a.w = w; a.cin = cin; a.kh = kh; a.kw = kw;
  a.cout = cout; a.sh = sh; a.sw = sw; a.pt = pt; a.pl = pl;
  a.cin_g = cin / groups * pack; a.cout_g = cout / groups * pack;
  a.ho = (h + pt + pb - kh) / sh + 1;
  a.wo = (w + pl + pr - kw) / sw + 1;
  a.pw = pw; a.ps = ps;
  a.oh = (a.ho - pw) / ps + 1;
  a.ow = (a.wo - pw) / ps + 1;
  a.c_tot = c_tot; a.out_off = out_off;
  a.k_pad = k_pad; a.splits = splits; a.chunk = chunk; a.mode = mode;
  a.wide = wide;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = mode == 1;
  if (bn == 128)
    return narrow ? tc::launch<128, true>(a, groups, pack, trials, st)
                  : tc::launch<128, false>(a, groups, pack, trials, st);
  if (bn == 64)
    return narrow ? tc::launch<64, true>(a, groups, pack, trials, st)
                  : tc::launch<64, false>(a, groups, pack, trials, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
