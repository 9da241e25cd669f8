// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (flash_attention.cu, ssd_scan.cu, qconv.cu, qgemm.cu, qdwconv.cu):
// shared-memory mbarriers, TMA tile loads, cp.async copies, cluster
// barriers and distributed shared-memory loads, wgmma shared-memory
// descriptors for the 128-byte swizzle, the m64n128k16 and m64n64k16 bf16
// wgmma forms with float32 sums, the m64nNk32 int8 forms (N = 128, 64,
// 32, 16, 8) with int32 sums, and the driver's cuTensorMapEncodeTiled
// reached through the runtime.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

namespace {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait that lasts more than about ten seconds is a deadlock: it traps,
// so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One box of a 2-D map, {c0, c1} innermost first, into shared memory;
// completes `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// Bring a TMA descriptor (a __grid_constant__ parameter) into the cache
// before its first use.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// An L2 policy for data read once: its lines are the first evicted, so
// that streaming it through L2 pushes out little else.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// tma_load of a 2-D box under an L2 cache policy.
__device__ __forceinline__ void tma_load_policy(uint32_t dst,
                                                const CUtensorMap* map,
                                                uint32_t bar, int c0, int c1,
                                                uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "l"(policy)
      : "memory");
}

// One box of a 3-D map, {c0, c1, c2} innermost first, into shared memory;
// completes `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 4-D map.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 (or 4) bytes from global to shared memory through cp.async; only the
// first `src_bytes` are read and the rest of the copy is zero, so
// src_bytes 0 writes zeros (`src` must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Thread-block clusters: a barrier over every thread of the cluster in
// two halves (arrive releases this thread's shared-memory writes, wait
// acquires the others'), the address of the same shared-memory location in
// block `rank` of the cluster, and a 16-byte load from such an address.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ int4 ld_cluster_v4(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// Make plain shared-memory stores visible to wgmma's (async) proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of wgmma's registers across the
// points where the asynchronous product reads or writes them.
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(int32_t (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

#define WG_D4 "{%0, %1, %2, %3}"
#define WG_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WG_D16                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)
#define WG_F32 WG_F16(0), WG_F16(16)
#define WG_F64 WG_F16(0), WG_F16(16), WG_F16(32), WG_F16(48)

// d (64 x 128, float32) (+)= A (64 x 16) . B (16 x 128), A and B bf16 in
// shared memory, both K-major; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_F64
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64) (+)= A (64 x 16) . B (16 x 64), as above.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_F32
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, float32) (+)= A (64 x 16, bf16 pairs in registers, the
// accumulator's row layout) . B (16 x 128, bf16 in shared memory,
// MN-major: the transpose bit); d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : WG_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// d (64 x 64) (+)= A (64 x 16, registers) . B (16 x 64, MN-major), as above.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

#define WG_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define WG_R16(i) WG_R4(i), WG_R4(i + 4), WG_R4(i + 8), WG_R4(i + 12)

// d (64 x 128, int32) += A (64 x 32) . B (32 x 128), A and B int8 in
// shared memory, both K-major (the only layout int8 wgmma takes).  Integer
// sums are exact (they wrap modulo 2^32, which no conv here reaches).
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_D64
      ", %64, %65, p;\n"
      "}\n"
      : WG_R16(0), WG_R16(16), WG_R16(32), WG_R16(48)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64, int32) += A (64 x 32) . B (32 x 64), as above.
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WG_D32
      ", %32, %33, p;\n"
      "}\n"
      : WG_R16(0), WG_R16(16)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 32, int32) += A (64 x 32) . B (32 x 32), as above.
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[16], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " WG_D16
      ", %16, %17, p;\n"
      "}\n"
      : WG_R16(0)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 16, int32) += A (64 x 32) . B (32 x 16), as above.
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[8], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 " WG_D8
      ", %8, %9, p;\n"
      "}\n"
      : WG_R4(0), WG_R4(4)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 8, int32) += A (64 x 32) . B (32 x 8), as above.
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[4], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 " WG_D4
      ", %4, %5, p;\n"
      "}\n"
      : WG_R4(0)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

#undef WG_R4
#undef WG_R16
#undef WG_D4
#undef WG_D8
#undef WG_D16
#undef WG_D32
#undef WG_D64
#undef WG_F4
#undef WG_F16
#undef WG_F32
#undef WG_F64

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two float32 values (columns c, c + 1) as bf16 pairs hi and lo, each
// value v carried as hi + lo = bf16(v) + bf16(v - bf16(v)): a relative
// 2^-17 where bf16(v) alone carries 2^-9.
__device__ __forceinline__ void split_pack_bf16(float x, float y,
                                                uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&l);
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so that the
// library links nothing but the runtime.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a tensor of `type` and `rank` dimensions (innermost first;
// `strides` in bytes for dimensions 1..rank-1), read in boxes of `box`
// elements with the 128-byte swizzle; elements outside the tensor read as
// zero.  0 on success, else a CUDA error code.
inline int encode_tiled_map(CUtensorMap* map, CUtensorMapDataType type,
                            const void* ptr, int rank, const cuuint64_t* dims,
                            const cuuint64_t* strides,
                            const cuuint32_t* box) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult res = fn(
      map, type, rank, const_cast<void*>(ptr),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

inline int encode_bf16_map(CUtensorMap* map, const void* ptr, int rank,
                           const cuuint64_t* dims, const cuuint64_t* strides,
                           const cuuint32_t* box) {
  return encode_tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank,
                          dims, strides, box);
}

inline int encode_u8_map(CUtensorMap* map, const void* ptr, int rank,
                         const cuuint64_t* dims, const cuuint64_t* strides,
                         const cuuint32_t* box) {
  return encode_tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, rank,
                          dims, strides, box);
}

// The map of a row-major int8 matrix of `rows` rows of `cols` bytes (row
// stride `stride`, a multiple of 16), read in boxes of 128 bytes x
// `box_rows` rows; bytes past `cols` or rows past `rows` read as zero.  A
// map describes memory, not its contents, so maps are kept by (address,
// cols, rows, stride, box_rows) and each is encoded once: a layer's
// staged weight, or an activation buffer the allocator hands out again,
// is encoded at its first launch only.
inline int cached_u8_map(CUtensorMap* out, const void* ptr, int cols,
                         int rows, int stride, int box_rows) {
  struct Entry {
    const void* ptr;
    int cols, rows, stride, box_rows;
    CUtensorMap map;
  };
  constexpr int kEntries = 256;
  static Entry cache[kEntries];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == ptr && e.cols == cols && e.rows == rows
        && e.stride == stride && e.box_rows == box_rows) {
      *out = e.map;
      return 0;
    }
  }
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_rows)};
  const int err = encode_u8_map(&map, ptr, 2, dims, strides, box);
  if (err != 0) return err;
  cache[next] = Entry{ptr, cols, rows, stride, box_rows, map};
  next = (next + 1) % kEntries;
  used = used < kEntries ? used + 1 : kEntries;
  *out = map;
  return 0;
}

}  // namespace sm90
}  // namespace
