// Hopper (sm_90a) building blocks of the port's TMA + wgmma kernels: 2-D
// and 3-D tensor maps (dense or strided, bf16 or f32) and 4-D maps with the
// head as a dimension of its own for the Tensor Memory Accelerator,
// mbarrier waits and arrivals, TMA tile loads, shared-memory matrix
// descriptors, the m64n256k16, m64n128k16 and m64n64k16 bf16 warpgroup
// products (A in shared memory or, for n64, in registers) with their
// fences, the m64n128k8, m64n64k8 and m64n32k8 tf32 products (A in shared
// memory or, for n64, in registers) and the split of f32
// tiles into tf32 halves that makes three of them an f32-accurate product,
// TMA tile stores, the thread-block cluster's barrier and stores to
// another block's shared memory (plain, or st.async counted on the
// receiver's mbarrier), and the stage ring (producer and consumer
// sides) that the kernels of ffn_bwd.cu, ffn_fwd.cu, attention_fwd.cu,
// attention_bwd.cu, dense_res_ln.cu, conv_ln_gelu.cu and conv_bwd.cu share,
// and the row statistics that K6's forward and backward reduce across a
// cluster.
//
// Layout used throughout: every operand tile in shared memory is a stack of
// 128-byte rows written by TMA with the 128-byte swizzle, its base 1024-byte
// aligned (the swizzle atom: 8 rows of 128 bytes).  A K-major operand (K
// contiguous in memory) is a (rows, 64) bf16 box: one 128-byte row per M or
// N index; its descriptor steps 32 bytes per k16 slice and 1024 bytes per
// 8 rows.  An MN-major operand (M or N contiguous) is a (64 k, 64 mn) box:
// one 128-byte row per k; its descriptor steps 2048 bytes (16 rows) per k16
// slice, 1024 bytes per 8 k and `lbo` bytes per further 64 M or N columns.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached below
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace smx {
namespace hopper {

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// that the library links no libcuda of its own
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix, loaded in (box_rows, box_cols)
// boxes, box_cols * 2 == 128 bytes, with the 128-byte swizzle.  Rows and
// columns past the matrix load as zeros.  False if the driver refuses.
inline bool make_map(CUtensorMap* map, const void* base, uint64_t rows,
                     uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major (rows, cols) float32 matrix whose rows lie `row_stride`
// elements apart (a multiple of 4: 16 bytes), loaded in (box_rows, 32)
// boxes (one 128-byte row per matrix row) with the 128-byte swizzle.  Rows
// and columns past the matrix load as zeros.
inline bool make_map_f32(CUtensorMap* map, const void* base, uint64_t rows,
                         uint64_t cols, uint64_t row_stride,
                         uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_stride * sizeof(float)};
  const cuuint32_t box[2] = {32, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (batches, rows, cols) view of elements of `elem` bytes (bf16 or f32),
// element (batch, row, col) at base + batch * batch_stride + row *
// row_stride + col (strides in elements, each 16 bytes a multiple), loaded
// in boxes of (box_rows, box_cols) of one batch, box_cols * elem == 128
// bytes, with the 128-byte swizzle.  Rows past `rows` load as zeros within
// their own batch: a box at the end of one batch never reads the next
// batch's rows.
inline bool make_map3_strided(CUtensorMap* map, const void* base,
                              uint64_t batches, uint64_t rows, uint64_t cols,
                              uint64_t row_stride, uint64_t batch_stride,
                              uint32_t box_rows, uint32_t box_cols,
                              uint32_t elem = sizeof(__nv_bfloat16)) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, batches};
  const cuuint64_t strides[2] = {row_stride * elem, batch_stride * elem};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map,
            elem == sizeof(float) ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same over a row-major (batches, rows, cols) tensor.
inline bool make_map3(CUtensorMap* map, const void* base, uint64_t batches,
                      uint64_t rows, uint64_t cols, uint32_t box_rows,
                      uint32_t box_cols) {
  return make_map3_strided(map, base, batches, rows, cols, cols, rows * cols,
                           box_rows, box_cols);
}

// A (B, T, H*d) bf16 (or, with elem 4, f32) slab seen as (batches, rows,
// heads, d), loaded in boxes of 128 bytes of one head's row (64 bf16 or 32
// f32 columns) and `box_rows` rows of one batch, with the 128-byte swizzle:
// the head is a dimension of its own, so the columns of a box past d load
// as zeros instead of the next head's (d a multiple of 8: 16-byte
// strides), and a box wholly past d loads as zeros.  Rows past `rows` load
// as zeros within their batch.  The box lands in shared memory as
// make_map3's (box_rows, 128 bytes) box.
inline bool make_map_heads(CUtensorMap* map, const void* base,
                           uint64_t batches, uint64_t rows, uint64_t heads,
                           uint64_t d, uint32_t box_rows,
                           uint32_t elem = sizeof(__nv_bfloat16)) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const uint64_t e = elem;
  const cuuint64_t dims[4] = {d, heads, rows, batches};
  const cuuint64_t strides[3] = {d * e, heads * d * e, rows * heads * d * e};
  const cuuint32_t box[4] = {128 / elem, 1, box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map,
            elem == sizeof(float) ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------- device
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// after every mbar_init, before any thread uses a barrier
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed.  A wait
// of 2^35 cycles (about 20 s) can only be a fault: it traps, so that the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long start = -1;
  do {
    if (start < 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 35)) {
      __trap();
    }
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of `map` at (column c0, row c1) into dst; completes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// one box of a 3-D `map` at (column c0, row c1, batch c2) into dst
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// one box of a make_map_heads map at (column c0 of the head, head, row,
// batch) into dst
__device__ __forceinline__ void tma_load_head(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int c0, int head,
                                              int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; lbo / sbo in bytes
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = smem_addr(tile);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for A fragments held in registers: fenced after the wait that
// retires their product, they stay live (unclobbered) until then
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16) * B (16 x 128), bf16 operands in shared
// memory.  TA / TB: 0 K-major, 1 MN-major (bf16 allows both).  The
// accumulator layout: thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 + 8 i and columns 8 j + 2 (t % 4) + c in
// d[4 j + 2 i + c], i, c in {0, 1}, j < 16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 256, f32) += A (64 x 16) * B (16 x 256), bf16 operands in shared
// memory, TA / TB as for m64n128k16; the accumulator layout is
// m64n128k16's with j < 32.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 64, f32) = A (64 x 16) * B (16 x 64) + (accumulate ? d : 0), bf16
// operands in shared memory, TA / TB as for m64n128k16.  The accumulator
// layout is m64n128k16's with j < 8: thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 + 8 i and columns 8 j + 2 (t % 4) + c in
// d[4 j + 2 i + c].
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// The same with A in registers: a[0..3] hold bf16 pairs of the 64 x 16
// slice in the accumulator layout of a 64 x 16 tile, a[0] (row r, columns
// 2 (t % 4) + {0, 1}), a[1] (row r + 8, the same columns), a[2] and a[3]
// those of columns + 8, r = 16 (t / 32) + (t % 32) / 4; the low half is the
// lower column.  So the f32 accumulator of an earlier m64nN product,
// elements 8 kk .. 8 kk + 7 rounded in pairs, is the A slice of columns
// 16 kk .. 16 kk + 15.  The registers must not change until the product's
// wait: fence them (fence_regs) after it.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3,
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate),
        "n"(TB));
}

// ------------------------------------------------ f32 on the tensor cores
// d (64 x N, f32) = A (64 x 8) * B (8 x N) + (accumulate ? d : 0), tf32
// operands in shared memory,
// both K-major (the transpose bits exist for 16-bit types only): 32-bit
// elements, 8 of them (32 bytes) per k8 slice, so a K-major tile is laid out
// as a bf16 one, (rows, 32) f32 boxes, its descriptor stepping 32 bytes per
// slice and 1024 per 8 rows.  The accumulator layout is that of
// m64nNk16.  The tensor cores read the top 19 bits of each element: the
// operands are rounded to tf32 beforehand (split_tf32).
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16],
                                                   uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// m64n32k8 with d an output only: the product starts d afresh and reads
// nothing of it, so d's registers need hold nothing before it (a product
// that reads d keeps it live, and ptxas serializes the products when it
// moves registers so held while another product is in flight)
__device__ __forceinline__ void wgmma_m64n32k8_tf32_zero(float (&d)[16],
                                                        uint64_t da,
                                                        uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15])
      : "l"(da), "l"(db));
}

// m64n64k8 with d an output only (as wgmma_m64n32k8_tf32_zero)
__device__ __forceinline__ void wgmma_m64n64k8_tf32_zero(float (&d)[32],
                                                        uint64_t da,
                                                        uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "tf32 products are N = 64 or 128");
  if constexpr (N == 64) {
    wgmma_m64n64k8_tf32(d, da, db, accumulate);
  } else {
    wgmma_m64n128k8_tf32(d, da, db, accumulate);
  }
}

// d (64 x 64, f32) = A (64 x 8) * B (8 x 64) + (accumulate ? d : 0), A in
// registers as tf32 values, B K-major in shared memory.  The A fragment of
// a k8 slice (PTX ISA, wgmma's register fragment of a 64 x 8 tf32 A):
// thread t of the warpgroup holds rows r = 16 (t / 32) + (t % 32) / 4 and
// r + 8 at columns c = t % 4 and c + 4, a[0] (r, c), a[1] (r + 8, c),
// a[2] (r, c + 4), a[3] (r + 8, c + 4).  An f32 accumulator's 8-column
// group j holds columns 8 j + 2 (t % 4) + {0, 1} instead, so its elements
// 4 j, 4 j + 2, 4 j + 1, 4 j + 3 are the A slice of those columns taken in
// the order 0, 2, 4, 6, 1, 3, 5, 7: the B tile's k rows must lie in that
// order.  The registers must not change until the product's wait.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db,
                                                      int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// One k8 slice of an f32-accurate product from split operands (the three
// products of split_tf32's note, the small ones first): A tiles K-major
// (rows, 32) at a_hi / a_lo, B tiles at b_hi / b_lo, the slice's 32-byte
// offset already added; `first`: the slice starts d afresh.
template <int N>
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[N / 2],
                                             const uint8_t* a_hi,
                                             const uint8_t* a_lo,
                                             const uint8_t* b_hi,
                                             const uint8_t* b_lo,
                                             bool first) {
  const uint64_t ah = desc_sw128(a_hi, 16, 1024);
  const uint64_t bh = desc_sw128(b_hi, 16, 1024);
  wgmma_tf32<N>(d, desc_sw128(a_lo, 16, 1024), bh, first ? 0 : 1);
  wgmma_tf32<N>(d, ah, desc_sw128(b_lo, 16, 1024), 1);
  wgmma_tf32<N>(d, ah, bh, 1);
}

// wgmma_m64n64k8_tf32_rs that starts d afresh with d an output only (as
// wgmma_m64n32k8_tf32_zero)
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs_zero(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// v rounded to tf32 (10 mantissa bits), to nearest, ties to even
__device__ __forceinline__ float tf32_rn(float v) {
  uint32_t u = __float_as_uint(v);
  u += 0xFFFu + ((u >> 13) & 1u);
  return __uint_as_float(u & 0xFFFFE000u);
}

// v rounded to tf32 by one instruction: to nearest, ties away from zero
// (cvt.rna; tf32_rn's ties go to even, which only an exact tie tells apart)
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

// The tf32 halves of an f32 operand v: the tensor cores read the top 19
// bits of each element, so v itself serves as its hi half, trunc(v), and
// lo = tf32(v - trunc(v)) (exact before its rounding, which tf32_rna does
// in one instruction): a b = hi_a hi_b + hi_a lo_b + lo_a hi_b within
// about 2^-20 |a||b|, the term lo_a lo_b left out.
__device__ __forceinline__ float tf32_lo(float v) {
  return tf32_rna(v - __uint_as_float(__float_as_uint(v) & 0xFFFFE000u));
}

// The lo halves (tf32_lo) of the `bytes` of a tile that TMA wrote at hi,
// to the same offsets from hi + bytes, so that one descriptor offset
// serves both; thread t of n takes every n-th 16-byte word
__device__ __forceinline__ void split_lo(uint8_t* hi, int bytes, int t,
                                         int n) {
  for (int at = t * 16; at < bytes; at += n * 16) {
    const float4 v = *reinterpret_cast<const float4*>(hi + at);
    *reinterpret_cast<float4*>(hi + bytes + at) = make_float4(
        tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z), tf32_lo(v.w));
  }
}

// x, a 64 x 8 NJ accumulator (element 4 j + 2 i + c at column 8 j + 2 (t
// % 4) + c), as the tf32 halves (v itself, tf32_lo) of the A fragments of
// its NJ k8 slices: elements 4 j, 4 j + 2, 4 j + 1, 4 j + 3
// (wgmma_m64n64k8_tf32_rs), so the B tile's k rows of each 8 lie in the
// order 0, 2, 4, 6, 1, 3, 5, 7
template <int NJ>
__device__ __forceinline__ void to_fragments(const float (&x)[4 * NJ],
                                             uint32_t (&xh)[NJ][4],
                                             uint32_t (&xl)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float v[4] = {x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xh[j][e] = __float_as_uint(v[e]);
      xl[j][e] = __float_as_uint(tf32_lo(v[e]));
    }
  }
}

// fence_regs over the slices of to_fragments' halves
template <int A, int B>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i) fence_regs(x[i]);
}

// The three-product split of f32 operands: each element v of a tile that
// TMA wrote to `hi` becomes hi = tf32(v) in place and lo = tf32(v - hi) at
// the same offset of `lo` (v - hi is exact), so both tiles keep the
// swizzled layout and one descriptor offset serves both.  a * b is then
// hi_a hi_b + hi_a lo_b + lo_a hi_b within about 3 * 2^-22 |a||b|.  Thread
// `t` of `threads` takes every threads-th 16-byte word of the `bytes`.
__device__ __forceinline__ void split_tf32(uint8_t* hi, uint8_t* lo,
                                           int bytes, int t, int threads) {
  for (int at = t * 16; at < bytes; at += threads * 16) {
    float4 v = *reinterpret_cast<const float4*>(hi + at);
    float4 h, l;
    h.x = tf32_rn(v.x);
    h.y = tf32_rn(v.y);
    h.z = tf32_rn(v.z);
    h.w = tf32_rn(v.w);
    l.x = tf32_rn(v.x - h.x);
    l.y = tf32_rn(v.y - h.y);
    l.z = tf32_rn(v.z - h.z);
    l.w = tf32_rn(v.w - h.w);
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// named barrier over the first `threads` threads of the block (id 1..15)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// one box of `map` at (column c0, row c1) from src in shared memory to
// global memory (rows and columns past the matrix are not written), in the
// thread's bulk group; src's writes by other threads must be fenced
// (fence_async_smem) and synchronised before
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}
// close the thread's bulk group, then wait until its stores have read
// their shared memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// make this thread's shared-memory writes visible to the TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ------------------------------------------------- thread-block clusters
// barrier over every thread of every block of the cluster: arrive (making
// this thread's earlier writes, to its own and to other blocks' shared
// memory, visible to the cluster), wait (seeing the other blocks' writes).
// Whole warps call both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// v to the same shared-memory offset as `p` in block `rank` of the cluster
__device__ __forceinline__ void st_cluster(const void* p, uint32_t rank,
                                           float v) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr)
               : "r"(smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}

// the first half of cluster_sync without its release: for a barrier whose
// only purpose is that every block has started (and initialised its
// mbarriers, fenced by mbar_fence_init) before any block writes to another
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// v to the same shared-memory offset as `p` in block `rank` of the
// cluster, counted as 4 bytes of the transaction count of that block's
// mbarrier at the offset of `bar` (st.async): the receiver waits on its
// mbarrier (mbar_wait_cluster), not on a cluster barrier
__device__ __forceinline__ void st_async(const void* p, uint32_t rank,
                                         float v, const uint64_t* bar) {
  uint32_t addr, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr)
               : "r"(smem_addr(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rbar)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(rbar)
      : "memory");
}

// mbar_wait with acquire at cluster scope: the writes other blocks made
// with st_async are visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long start = -1;
  do {
    if (start < 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 35)) {
      __trap();
    }
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// ------------------------------------------- the kernels' common schedule
// A block owns a TILE x TILE output tile: a producer (a warpgroup, or one
// warp; one thread of it issues the TMA loads) and two consumer warpgroups
// of 64 rows each, fed through a ring of stages BK deep.
constexpr int TILE = 128;              // output tiles are TILE x TILE
constexpr int BK = 64;                 // depth of a stage: one 128-byte row
constexpr int BOX = TILE * BK * 2;     // one operand tile of a stage, 16 KB
constexpr int HALF = BOX / 2;          // 64 rows of 128 bytes, 8 KB
constexpr int WG_THREADS = 128;
constexpr int CONSUMERS = 2 * WG_THREADS;
constexpr int THREADS = CONSUMERS + WG_THREADS;  // + a producer warpgroup
constexpr uint32_t SBO = 1024;         // 8 rows of 128 bytes
constexpr uint32_t MN_LBO = HALF;      // MN-major: the next 64 M or N columns

// a shared-memory buffer rounded up to the swizzle atom
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// One consumer warpgroup's pass over a stage ring: waits for each stage,
// issues its four k16 slices on `mma(stage)`, keeps one group of products in
// flight and releases a stage once its products are done.
template <int STAGES, typename Mma>
__device__ __forceinline__ void consume(uint64_t* full, uint64_t* empty,
                                        int ksteps, Mma mma) {
  int s = 0, prev = -1;
  uint32_t phase = 0;
  for (int kb = 0; kb < ksteps; ++kb) {
    mbar_wait(&full[s], phase);
    wgmma_fence();
    mma(s);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
}

// consume() for f32 operands on the tensor cores.  Once a stage has landed,
// every consumer thread runs `split(stage)` (its share of the stage's tiles
// through split_tf32), fences its shared-memory writes for the asynchronous
// proxy and meets the other consumers, so that the products read whole hi
// and lo tiles.  `mma(stage)` issues the stage's products into a partial
// accumulator that its first product starts afresh, and `promote()` adds
// the partial to the f32 accumulator on the CUDA cores: the tensor cores'
// sum, whose additions drop low bits (on an H100, K8's dx at K = 7680 came
// out three times its f32 limit from one accumulator), then spans one
// stage (12 tf32 products of 8 terms), and the stages are added in f32 with
// rounding.  The split of one stage overlaps the products of the stage
// before, still in flight.
template <int STAGES, typename Split, typename Mma, typename Promote>
__device__ __forceinline__ void consume_split(uint64_t* full, uint64_t* empty,
                                              int ksteps, Split split,
                                              Mma mma, Promote promote) {
  int s = 0, prev = -1;
  uint32_t phase = 0;
  for (int kb = 0; kb < ksteps; ++kb) {
    mbar_wait(&full[s], phase);
    split(s);
    fence_async_smem();
    bar_sync(1, CONSUMERS);
    if (prev >= 0) {
      wgmma_wait<0>();
      promote();
      mbar_arrive(&empty[prev]);
    }
    wgmma_fence();
    mma(s);
    wgmma_commit();
    prev = s;
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  if (prev >= 0) {
    wgmma_wait<0>();
    promote();
  }
}

// acc += part after the products writing part have retired
template <int N>
__device__ __forceinline__ void promote_acc(float (&acc)[N],
                                            float (&part)[N]) {
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += part[i];
}

// The producer's turn before loading stage s of step kb: wait until the
// consumers released the stage, announce `bytes`, then load.
template <int STAGES>
struct Ring {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void acquire(uint64_t* full, uint64_t* empty,
                                          uint32_t bytes) {
    mbar_wait(&empty[s], phase ^ 1);
    mbar_expect_tx(&full[s], bytes);
  }
  __device__ __forceinline__ void advance() {
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
};

// every stage's full / empty barriers: one arrival (the producer's expect)
// and one per consumer thread; by thread 0, then the whole block syncs
template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// ---------------------------------- row statistics across a cluster's blocks
// (conv_ln_gelu.cu and conv_bwd.cu: a row's columns spread over the blocks
// of a cluster, in the accumulator layout of m64nNk16)

// the sum over the four lanes of a quad (one row of the accumulator layout),
// the same bits on all four
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One row statistic over the cluster: this block's row sums v[i] (rows
// lrow + 8 i of its TILE-row tile, its column slice) to slice `rank` of
// `part` ([cluster][TILE] floats) in every block; after the barrier, the
// `cluster` slices' sums in slice order.
__device__ __forceinline__ void cluster_row_sums(float* part, int rank,
                                                 int cluster, int lrow,
                                                 int lane, float (&v)[2]) {
  v[0] = quad_sum(v[0]);
  v[1] = quad_sum(v[1]);
  if (lane % 4 == 0) {
    for (int r = 0; r < cluster; ++r) {
      st_cluster(part + rank * TILE + lrow, r, v[0]);
      st_cluster(part + rank * TILE + lrow + 8, r, v[1]);
    }
  }
  cluster_sync();
  v[0] = 0.0f;
  v[1] = 0.0f;
  for (int r = 0; r < cluster; ++r) {
    v[0] += part[r * TILE + lrow];
    v[1] += part[r * TILE + lrow + 8];
  }
}

}  // namespace hopper
}  // namespace smx
