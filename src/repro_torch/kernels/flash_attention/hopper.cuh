// Hopper building blocks shared by K4 (flash_attention.cu) and K4b
// (flash_attention_bwd.cu): mbarriers, TMA loads and stores, wgmma on
// 128-byte-swizzled shared-memory tiles, and the rank-4 tensor maps that
// the launchers build from a (B, S, heads, D) tensor's strides.  All of it
// sits in an anonymous namespace, so each library has its own copy;
// build.py hashes this header with each source of its directory, so an
// edit here rebuilds both libraries.
#pragma once

#include <cstdint>
#include <cuda.h>          // CUtensorMap; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROW_BYTES = 128;     // one swizzled row: 64 bf16 of one panel
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  int64_t b, s, h;                 // elements; the last dimension is contiguous
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit; subnormal results flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// ---- named barriers over `n` threads (id 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// ---- TMA (coordinates innermost first: column, row, head, batch)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3) : "memory");
}

// `bytes` (a multiple of 16) from 16-byte-aligned global memory, completing
// on `bar` like a TMA tile
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- wgmma
// Shared-memory matrix descriptor for a 128-byte-swizzled operand whose
// 1 KiB swizzle atoms (8 rows of 128 bytes) start on 1 KiB boundaries.
// lbo: bytes between 64-element column panels (MN-major only; ignored for
// K-major); sbo: bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {   // at most N groups pending
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define FA_ACC8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (m64 x n64, f32) (+)= a . b, a and b (both K-major) from shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC8(0),
        FA_ACC8(8),
        FA_ACC8(16),
        FA_ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64 x n64, f32) += a . b, a (bf16) from registers, b (MN-major)
// from shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0),
        FA_ACC8(8),
        FA_ACC8(16),
        FA_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n128, f32) += a . b, a (bf16) from registers, b (MN-major)
// from shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0),
        FA_ACC8(8),
        FA_ACC8(16),
        FA_ACC8(24),
        FA_ACC8(32),
        FA_ACC8(40),
        FA_ACC8(48),
        FA_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n256, f32) += a . b, a (bf16) from registers, b (MN-major)
// from shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0),
        FA_ACC8(8),
        FA_ACC8(16),
        FA_ACC8(24),
        FA_ACC8(32),
        FA_ACC8(40),
        FA_ACC8(48),
        FA_ACC8(56),
        FA_ACC8(64),
        FA_ACC8(72),
        FA_ACC8(80),
        FA_ACC8(88),
        FA_ACC8(96),
        FA_ACC8(104),
        FA_ACC8(112),
        FA_ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FA_ACC8

// d (m64 x nD) += a (m64 x k16, registers) . b (k16 x nD, MN-major)
template <int D>
__device__ __forceinline__ void wgmma_rs_nd(float (&d)[D / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// that the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Rank-4 map of a bf16 tensor (B, S, heads, D) with element strides `st`,
// dimensions innermost first (D, S, heads, B); a box is 64 columns x `rows`
// rows of one head, 128-byte swizzled.  Out-of-range rows read as zeros
// and are not written.
bool tensor_map(CUtensorMap* map, const void* ptr, int d, int s, int heads,
                int b, Strides st, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
